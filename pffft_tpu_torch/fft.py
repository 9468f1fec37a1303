"""Public transforms of the port.

Counterpart of ``pffft_tpu/fft.py``.  The ported path is the f32 transform
of time-major planes, :func:`transform_ordered_split_tmajor`, for complex
and real plans.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import plan as _plan
from .ops import dispatch as _dispatch
from .ops import split as _split
from .plan import BACKWARD, FORWARD, Plan

__all__ = ["transform_ordered_split_tmajor"]


def _as_plane(x, device: Optional[str]) -> torch.Tensor:
    """A contiguous f32 tensor: torch tensors stay on their device, numpy
    arrays go to ``device`` (default "cuda")."""

    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).contiguous()
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


def _check_pair(re: torch.Tensor, im: torch.Tensor) -> None:
    if im.shape != re.shape or im.device != re.device:
        raise ValueError(
            f"re and im planes differ: {tuple(re.shape)} on {re.device}, "
            f"{tuple(im.shape)} on {im.device}"
        )


def _real_forward_tmajor(plan: Plan, x: torch.Tensor):
    """[N, B] real -> the packed spectrum planes [N/2, B] x2."""

    batch = x.shape[1]
    y = x.view(plan.engine_n, 2 * batch)  # free: row h is x[2h] | x[2h+1]
    fused = _dispatch.fused_real_fwd_route(plan, batch, x.device)
    if fused is not None:
        return fused(y)
    packed = _dispatch.packed_fwd_route(plan, batch, x.device)
    if packed is not None:
        zr, zi = packed(y)
    else:
        zr, zi = _split.pack_real_input_split_tmajor(x)
        zr, zi = _dispatch.cfft_dispatch(plan, zr, zi)
    return _dispatch.real_split_kernel_route(plan, False)(zr, zi)


def _real_backward_tmajor(plan: Plan, sr: torch.Tensor, si: torch.Tensor):
    """The packed spectrum planes [N/2, B] x2 -> [N, B] real, unscaled."""

    batch = sr.shape[1]
    fused = _dispatch.fused_real_bwd_route(plan, batch, sr.device)
    if fused is not None:
        wr, wi = fused(sr, si)
    else:
        zr, zi = _dispatch.real_split_kernel_route(plan, True)(sr, si)
        wr, wi = _dispatch.cfft_dispatch(plan, zr, zi, backward=True)
    return _split.interleave_to_real_split_tmajor(wr, wi)


def transform_ordered_split_tmajor(plan: Plan, x, direction=FORWARD, *,
                                   device: Optional[str] = None):
    """Split-format ordered transform in TIME-MAJOR layout.

    COMPLEX:       x = (re, im) planes [N, B] -> (re, im) [N, B]
    REAL forward:  x [N, B] real             -> (re, im) [N/2, B]
    REAL backward: x = (re, im) [N/2, B]     -> [N, B] real

    f32 tensors, unscaled (backward(forward(x)) == N*x), canonical bin
    order; real spectra pack bin0 = DC + i*Nyquist.  The caller's tensors
    are not modified.  numpy input is moved to ``device`` (default
    "cuda"); tensors stay where they are.
    """

    d = _plan._coerce_direction(direction)
    if plan.dtype != np.float32:
        raise NotImplementedError("float64 plans are not ported yet (ROADMAP.md A6)")
    if plan.is_real:
        if d == BACKWARD:
            sr, si = (_as_plane(a, device) for a in x)
            if sr.ndim != 2 or sr.shape[0] != plan.spectrum_size:
                raise ValueError(
                    f"time-major real spectrum planes must be "
                    f"[{plan.spectrum_size}, B]; got {tuple(sr.shape)}"
                )
            _check_pair(sr, si)
            return _real_backward_tmajor(plan, sr, si)
        if isinstance(x, (tuple, list)):
            raise ValueError(
                "time-major REAL forward takes a single [N, B] real array "
                "(got a tuple; planar pairs are the spectrum side)"
            )
        x = _as_plane(x, device)
        if x.ndim != 2 or x.shape[0] != plan.n:
            raise ValueError(
                f"time-major real input must be [N={plan.n}, B]; got {tuple(x.shape)}"
            )
        return _real_forward_tmajor(plan, x)
    re, im = (_as_plane(a, device) for a in x)
    if re.ndim != 2 or re.shape[0] != plan.n:
        raise ValueError(
            f"time-major planes must be [N={plan.n}, B]; got {tuple(re.shape)}"
        )
    _check_pair(re, im)
    return _dispatch.cfft_dispatch(plan, re, im, backward=d == BACKWARD)
