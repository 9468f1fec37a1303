"""PFDSP parity: NCO mixers, carrier generators, CIC decimation.

Counterpart of ``pffft_tpu/dsp``: :mod:`mixer` (the 32-bit fixed-point
NCO and the ALGO A-J surface), :mod:`carrier` (the period-4 carriers) and
:mod:`cic` (the CIC downconverter as one banded fp32 product).  None of
them has a kernel of its own: the reference has no Pallas kernel for
them, so they are PyTorch ops on the input's device.
"""

from . import carrier, cic, mixer
from .mixer import (
    mixer_apply_split,
    MixerState,
    mixer_init,
    mixer_apply,
    Mixer,
    shift_math_cc,
    shift_table_init,
    shift_table_cc,
    shift_addfast_init,
    shift_addfast_cc,
    shift_unroll_init,
    shift_unroll_cc,
    shift_limited_unroll_init,
    shift_limited_unroll_cc,
    shift_recursive_osc_init,
    shift_recursive_osc_cc,
    gen_recursive_osc_c,
    have_sse_shift_mixer_impl,
)
from .carrier import (
    generate_dc_f,
    generate_dc_s16,
    generate_pos_fs4_f,
    generate_pos_fs4_s16,
    generate_neg_fs4_f,
    generate_neg_fs4_s16,
    generate_dc_pos_fs4_s16,
    generate_dc_neg_fs4_s16,
    generate_pos_neg_fs4_s16,
    generate_dc_pos_neg_fs4_s16,
    generate_pos_neg_fs2_s16,
    generate_dc_pos_neg_fs2_s16,
)
from .cic import CicState, cicddc_init, cicddc_apply, CicDDC

__all__ = [
    "MixerState", "mixer_init", "mixer_apply", "mixer_apply_split", "Mixer",
    "shift_math_cc", "shift_table_init", "shift_table_cc",
    "shift_addfast_init", "shift_addfast_cc",
    "shift_unroll_init", "shift_unroll_cc",
    "shift_limited_unroll_init", "shift_limited_unroll_cc",
    "shift_recursive_osc_init", "shift_recursive_osc_cc", "gen_recursive_osc_c",
    "have_sse_shift_mixer_impl",
    "generate_dc_f", "generate_dc_s16",
    "generate_pos_fs4_f", "generate_pos_fs4_s16",
    "generate_neg_fs4_f", "generate_neg_fs4_s16",
    "generate_dc_pos_fs4_s16", "generate_dc_neg_fs4_s16",
    "generate_pos_neg_fs4_s16", "generate_dc_pos_neg_fs4_s16",
    "generate_pos_neg_fs2_s16", "generate_dc_pos_neg_fs2_s16",
    "CicState", "cicddc_init", "cicddc_apply", "CicDDC",
]
