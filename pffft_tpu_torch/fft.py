"""Public transforms of the port.

Counterpart of ``pffft_tpu/fft.py``.  This slice ports the main path, the
complex f32 transform of time-major planes,
:func:`transform_ordered_split_tmajor`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import plan as _plan
from .ops import dispatch as _dispatch
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


def transform_ordered_split_tmajor(plan: Plan, x, direction=FORWARD, *,
                                   device: Optional[str] = None):
    """Split-format ordered transform in TIME-MAJOR layout.

    COMPLEX: x = (re, im) planes [N, B] -> (re, im) [N, B] f32 tensors,
    unscaled (backward(forward(x)) == N*x), canonical bin order.  The
    caller's tensors are not modified.  numpy planes are moved to
    ``device`` (default "cuda"); tensors stay where they are.
    """

    d = _plan._coerce_direction(direction)
    if plan.is_real:
        raise NotImplementedError("REAL plans are not ported yet (ROADMAP.md A5)")
    if plan.dtype != np.float32:
        raise NotImplementedError("float64 plans are not ported yet (ROADMAP.md A6)")
    re, im = x
    re = _as_plane(re, device)
    im = _as_plane(im, device)
    if re.ndim != 2 or re.shape[0] != plan.n:
        raise ValueError(
            f"time-major planes must be [N={plan.n}, B]; got {tuple(re.shape)}"
        )
    if im.shape != re.shape or im.device != re.device:
        raise ValueError(
            f"re and im planes differ: {tuple(re.shape)} on {re.device}, "
            f"{tuple(im.shape)} on {im.device}"
        )
    return _dispatch.cfft_dispatch(plan, re, im, backward=d == BACKWARD)
