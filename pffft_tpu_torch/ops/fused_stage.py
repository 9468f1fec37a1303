"""Fused two-stage FFT of batch-major planes [B, N] in one pass (kernel B9).

Counterpart of ``pffft_tpu/ops/fused_stage.py``.  The Pallas kernel becomes
``csrc/fused2.cu``: a block runs the thin radix-16/8/4/2/5/3 chain on whole
rows with the register-resident core of ``csrc/regfft.cuh`` (first stage
read straight from the rows, exchanges through one padded row buffer in
shared memory, last stage written straight out), and stores each row
through the output map of the plan's two factors N = n1*n2:

  ordered:   out[b, k]            (canonical bins)
  internal:  out[b, k1*n2 + k2]   holds bin k1 + n1*k2 (k1-major)

Unscaled both directions.  The TPU kernel's dense r x r DFT matmuls are
not carried over: in true fp32 a dense 64-term stage drops the carrier test
below 140 dB, and the ordered spectrum does not depend on the
factorization, so the chain computes it and (n1, n2) define only the
internal order.  An ordered call therefore takes any plan of length N; an
internal-order call needs a two-stage plan (:func:`supported`).

:func:`cfft_fused2` takes its plain version, :func:`cfft_fused2_plain`,
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises.  ``cfft_fused2.launches`` counts its launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import plan as _plan
from ..utils import profiling as _profiling
from . import _build
from . import pallas_fft as _pk

__all__ = ["supported", "fused2_tile", "cfft_fused2", "cfft_fused2_plain", "Fused2Tile",
           "MAX_TB", "MAX_N"]

# Rows per block at most: the reference's tile (DEFAULT_TB).
MAX_TB = 64
# The longest row the kernel takes, as in the reference.
MAX_N = 16384
# Threads a block of short rows is filled up to.
_ROW_THREADS = 256
# Values a thread holds per stage: 16 up to N = 4096 (a radix-16 butterfly
# each), 32 above, so that a row of 8192 still takes 256 threads.
_ELEMS_SPLIT = 4096
# Padding of the row buffer: one float2 every 16, which spreads the
# strided reads of every radix over distinct banks.
_PAD_SHIFT = 4


class Fused2Tile(NamedTuple):
    """B9's launch shape for one row length (``fused2_tile``)."""

    rows: int           # rows per block
    threads: int        # threads per block
    elems: int          # values a thread holds per stage (16 or 32)
    pitch: int          # float2 slots between two rows' buffers
    shift: int          # one float2 of padding every 2**shift elements
    smem: int           # bytes of shared memory per block
    blocks_per_sm: int  # by the planner's arithmetic (pallas_fft.core_blocks_per_sm)


def supported(plan: _plan.Plan) -> bool:
    """Two active stages, each factor in [2, 128], no local split."""

    active = [st for st in plan.stages if st.r > 1]
    return (
        plan.local_split is None
        and len(active) == 2
        and all(2 <= st.r <= 128 for st in active)
    )


def _factors(plan: _plan.Plan) -> Tuple[int, int]:
    n1, n2 = (st.r for st in plan.stages if st.r > 1)
    return n1, n2


def fused2_tile(n: int, device: Optional[torch.device] = None) -> Optional[Fused2Tile]:
    """B9's launch shape for rows of length n, or None past :data:`MAX_N`
    or where n has no thin plan (not 2/3/5-smooth).

    Each thread holds 16 values per stage up to N = 4096 and 32 above, so
    a row takes ceil(n / elems) threads; short rows are packed into one
    block up to 256 threads (at most :data:`MAX_TB` rows).  The block's
    shared memory is one padded buffer per row.  N = 4096 and 8192 get one
    row of 256 threads and 34 / 68 KB, two blocks per SM by
    ``core_blocks_per_sm`` (registers counted at the launch bound's 128);
    N = 16384 one block of 512 threads and 136 KB."""

    if n < 1 or n > MAX_N or _pk.thin_plan(n) is None:
        return None
    elems = 16 if n <= _ELEMS_SPLIT else 32
    per_row = -(-n // elems)
    rows = max(1, min(MAX_TB, _ROW_THREADS // per_row))
    threads = -(-rows * per_row // 32) * 32
    pitch = _pk.core_pad(n - 1, _PAD_SHIFT) + 1
    smem = rows * pitch * 8
    if threads > _pk.CORE_MAX_THREADS or smem > _pk.smem_per_block(device):
        return None
    return Fused2Tile(rows, threads, elems, pitch, _PAD_SHIFT, smem,
                      _pk.core_blocks_per_sm(threads, smem))


def _out_map(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Canonical [B, N] -> the internal order: out[b, k1*n2 + k2] = x[b, k2*n1 + k1]."""

    b = x.shape[0]
    return x.reshape(b, n2, n1).transpose(1, 2).reshape(b, n1 * n2)


def cfft_fused2_plain(plan: _plan.Plan, re, im, *, backward: bool = False,
                      ordered: bool = True):
    """Plain PyTorch version of the kernel: the thin chain on the rows
    (``chain_tmajor_plain`` on the transposed planes), then the output map."""

    n = re.shape[1]
    ar, ai = _pk.chain_tmajor_plain(_pk.thin_plan(n), re.T, im.T, backward=backward)
    ar, ai = ar.T, ai.T
    if not ordered:
        n1, n2 = _factors(plan)
        ar, ai = _out_map(ar, n1, n2), _out_map(ai, n1, n2)
    return ar.contiguous(), ai.contiguous()


def cfft_fused2(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                backward: bool = False, ordered: bool = True):
    """Batched complex FFT of batch-major planes [B, N] in one pass.

    Unscaled both directions; layout per the module docstring.  Any B: the
    rows past B of the last block are masked.  The inputs are not modified."""

    if not ordered and not supported(plan):
        raise ValueError(f"plan {plan} is not a two-stage plan")
    b, n = _pk._planes(re, im)
    if n != plan.engine_n:
        raise ValueError(f"data length {n} != plan engine length {plan.engine_n}")
    if re.device.type == "cpu":
        return cfft_fused2_plain(plan, re, im, backward=backward, ordered=ordered)
    _pk._check_cuda(re, im)
    t = fused2_tile(n, re.device)
    if t is None:
        raise ValueError(f"N={n} exceeds the fused two-stage kernel's rows")
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return ore, oim
    with _profiling.span("launch", "cfft_fused2"):
        # the identity map n1 = N, n2 = 1 stores canonical order
        n1, n2 = (n, 1) if ordered else _factors(plan)
        lib, fn = _pk._kernel("pf_fused2")
        tw, desc, count = _pk._core_tables(_pk.thin_plan(n).stages, re.device)
        err = fn(re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(), tw.data_ptr(),
                 desc, count, n, b, t.rows, t.threads, t.elems, t.pitch, t.shift, n1, n2,
                 int(ordered), int(backward), re.device.index or 0, _pk._stream(re))
        _build.check(lib, err, f"fused two-stage kernel (N={n}, B={b}, rows={t.rows}, "
                               f"threads={t.threads})")
    cfft_fused2.launches += 1
    return ore, oim


cfft_fused2.launches = 0
