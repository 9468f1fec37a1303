"""Fused two-stage FFT of batch-major planes [B, N] in one pass (kernel B9).

Counterpart of ``pffft_tpu/ops/fused_stage.py``.  The Pallas kernel becomes
``csrc/fused2.cu``: a block loads whole rows into the chain's shared-memory
tile, runs the thin radix-16/8/4/2/5/3 chain of ``csrc/chain.cuh`` on it,
and stores each row through the output map of the plan's two factors
N = n1*n2:

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

from typing import Optional, Tuple

import torch

from .. import plan as _plan
from . import _build
from . import pallas_fft as _pk

__all__ = ["supported", "fused2_tile", "cfft_fused2", "cfft_fused2_plain", "MAX_TB"]

# Rows per block at most: the reference's tile (DEFAULT_TB).
MAX_TB = 64


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


def fused2_tile(n: int, device: Optional[torch.device] = None) -> Optional[int]:
    """Rows per block for length n: the largest power of two up to
    :data:`MAX_TB` whose [n, TB] tile fits one block of the thin chain
    (``pallas_fft.tile_elems``), or None when not even one row fits."""

    chain = _pk.thin_plan(n)
    if chain is None:
        return None
    cap = _pk.tile_elems([st.r for st in chain.stages if st.r != 1], device)
    tb = MAX_TB
    while tb >= 1:
        if n * tb <= cap:
            return tb
        tb //= 2
    return None


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
    ragged last tile is masked.  The inputs are not modified."""

    if not ordered and not supported(plan):
        raise ValueError(f"plan {plan} is not a two-stage plan")
    b, n = _pk._planes(re, im)
    if n != plan.engine_n:
        raise ValueError(f"data length {n} != plan engine length {plan.engine_n}")
    if re.device.type == "cpu":
        return cfft_fused2_plain(plan, re, im, backward=backward, ordered=ordered)
    _pk._check_cuda(re, im)
    tb = fused2_tile(n, re.device)
    if tb is None:
        raise ValueError(f"N={n} exceeds the fused two-stage kernel's tile")
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return ore, oim
    # the identity map n1 = N, n2 = 1 stores canonical order
    n1, n2 = (n, 1) if ordered else _factors(plan)
    lib, fn = _pk._kernel("pf_fused2")
    tw, desc, count = _pk._chain_tables(_pk.thin_plan(n).stages, re.device)
    err = fn(re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(), tw.data_ptr(),
             desc, count, n, b, tb, n1, n2, int(ordered), int(backward),
             re.device.index or 0, _pk._stream(re))
    _build.check(lib, err, f"fused two-stage kernel (N={n}, B={b}, tb={tb})")
    cfft_fused2.launches += 1
    return ore, oim


cfft_fused2.launches = 0
