"""pffft_tpu_torch: the PyTorch/CUDA port of pffft_tpu.

A second package beside the JAX one, with the same conventions: unscaled
transforms (backward(forward(x)) == N*x), canonical bin order, planar
(re, im) split APIs.  Its kernels are CUDA C++ for Hopper (sm_90a) under
``csrc/``, built with nvcc on first use; on the CPU every kernel wrapper
runs its plain PyTorch version.  It imports neither jax nor pffft_tpu.

Ported so far: the f32 transform of time-major planes,
:func:`transform_ordered_split_tmajor`, for complex and real plans; FIR
filtering by overlap-save, :mod:`conv` (``FastConv``, ``StreamingConv``);
the polyphase channelizers, :mod:`channelizer`.
"""

from . import channelizer, conv, fft, ops, runtime
from .channelizer import (
    Channelizer,
    ChannelizerState,
    OversampledChannelizer,
    design_lowpass,
    state_from_arrays,
)
from .conv import ConvFlags, FastConv, StreamingConv, fastconv_valid
from .fft import transform_ordered_split_tmajor
from .plan import (
    BACKWARD,
    COMPLEX,
    FORWARD,
    REAL,
    Direction,
    Plan,
    StageTables,
    TransformKind,
    decompose_smooth,
    is_power_of_two,
    is_valid_size,
    load_plan,
    min_fft_size,
    nearest_transform_size,
    new_setup,
    next_power_of_two,
    plan_factors,
    plan_from_reference,
    save_plan,
)

__all__ = [
    "channelizer",
    "conv",
    "fft",
    "ops",
    "runtime",
    "transform_ordered_split_tmajor",
    "Channelizer",
    "ChannelizerState",
    "OversampledChannelizer",
    "design_lowpass",
    "state_from_arrays",
    "ConvFlags",
    "FastConv",
    "StreamingConv",
    "fastconv_valid",
    "BACKWARD",
    "COMPLEX",
    "FORWARD",
    "REAL",
    "Direction",
    "Plan",
    "StageTables",
    "TransformKind",
    "decompose_smooth",
    "is_power_of_two",
    "is_valid_size",
    "load_plan",
    "min_fft_size",
    "nearest_transform_size",
    "new_setup",
    "next_power_of_two",
    "plan_factors",
    "plan_from_reference",
    "save_plan",
]
