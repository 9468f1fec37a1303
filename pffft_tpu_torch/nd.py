"""Multi-dimensional transforms composed from the 1-D engine.

Counterpart of ``pffft_tpu/nd.py``.  fft2/fftn run per-axis ordered
transforms, minor axis first: each other axis is moved to the minor
position by an explicit copy (``movedim`` then ``contiguous``: the kernels
read whole rows in contiguous memory; it is the reference's transpose),
transformed on batch-major rows through the 1-D dispatcher, and moved back
as a view, which the next axis's copy or the final copy lays out.  Per-axis
plans come from :func:`pffft_tpu_torch.bluestein.new_setup_any`, so ANY
extent works: smooth ones run the batch-major engines (B9 up to 16384),
the rest the chirp-Z path.

Unscaled, as the 1-D library: ``ifftn(fftn(x)) == prod(shape) * x``.
numpy input goes to ``device`` (default "cuda"); tensors stay on their
device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import bluestein as _bs
from . import fft as _fft
from . import plan as _plan
from .ops import split as _split

__all__ = ["NdPlan", "fftn_setup", "fftn_split", "fftn", "ifftn",
           "fft2", "ifft2", "rfftn", "irfftn"]


class NdPlan:
    """Per-axis plan bundle for an n-dimensional complex transform.

    ``shape`` are the transformed extents (the trailing ``len(shape)``
    axes of the operand; anything before them is batch).  Each axis gets
    its own 1-D plan via new_setup_any — equal extents share one plan.
    """

    def __init__(self, shape: Sequence[int], dtype="float32"):
        self.shape = tuple(int(s) for s in shape)
        if not self.shape:
            raise ValueError("fftn needs at least one axis")
        if any(s < 2 for s in self.shape):
            raise ValueError(f"every transformed extent must be >= 2: {self.shape}")
        self.dtype = np.dtype(dtype)
        # new_setup_any caches BluesteinPlans per (n, dtype) and Plan.create
        # caches smooth plans, so equal extents share one plan
        self.plans = tuple(
            _bs.new_setup_any(s, _plan.COMPLEX, self.dtype.name)
            for s in self.shape
        )

    @property
    def size(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"NdPlan(shape={self.shape}, {self.dtype.name})"


def fftn_setup(shape: Sequence[int], dtype="float32") -> NdPlan:
    """Plan an n-dimensional complex transform over the given extents."""

    return NdPlan(shape, dtype)


def fftn_split(ndplan: NdPlan, x, direction=_plan.FORWARD, *,
               device: Optional[str] = None):
    """Planar n-d transform: (re, im) [..., *shape] -> (re, im), contiguous.

    Axes are processed minor-to-major; each non-minor axis is copied to
    the minor position, transformed, and moved back.
    """

    d = _plan._coerce_direction(direction)
    re, im = (_fft._as_plane(a, device, ndplan) for a in x)
    nd = len(ndplan.shape)
    if tuple(re.shape[-nd:]) != ndplan.shape:
        raise ValueError(
            f"trailing axes {tuple(re.shape[-nd:])} do not match plan shape "
            f"{ndplan.shape}")
    _fft._check_pair(re, im)
    for k in range(nd):
        ax = -1 - k  # minor-to-major
        p = ndplan.plans[nd - 1 - k]
        if ax != -1:
            re = re.movedim(ax, -1).contiguous()
            im = im.movedim(ax, -1).contiguous()
        # the 1-D ordered transform along the last axis, either plan type
        re, im = _fft.transform_ordered_split(p, (re, im), d)
        if ax != -1:
            re, im = re.movedim(-1, ax), im.movedim(-1, ax)
    return re.contiguous(), im.contiguous()


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _complex_planes(x, nd: NdPlan, device: Optional[str]):
    """x as the plan's complex dtype, split into contiguous planes."""

    return _split.to_split(_fft._as_tensor(x, device, nd).to(_fft._complex_dtype(nd)))


def fftn(x, shape: Optional[Sequence[int]] = None, dtype="float32", *,
         device: Optional[str] = None):
    """Complex-dtype n-d forward transform over the trailing ``shape``
    axes (default: all axes)."""

    nd = NdPlan(shape if shape is not None else _shape(x), dtype)
    return torch.complex(*fftn_split(nd, _complex_planes(x, nd, device), _plan.FORWARD))


def ifftn(x, shape: Optional[Sequence[int]] = None, dtype="float32", *,
          device: Optional[str] = None):
    """Unscaled n-d backward transform (ifftn(fftn(x)) == size * x)."""

    nd = NdPlan(shape if shape is not None else _shape(x), dtype)
    return torch.complex(*fftn_split(nd, _complex_planes(x, nd, device), _plan.BACKWARD))


def fft2(x, dtype="float32", *, device: Optional[str] = None):
    """2-D forward transform over the trailing two axes."""

    return fftn(x, _shape(x)[-2:], dtype, device=device)


def ifft2(x, dtype="float32", *, device: Optional[str] = None):
    """Unscaled 2-D backward transform over the trailing two axes."""

    return ifftn(x, _shape(x)[-2:], dtype, device=device)


def rfftn(x, dtype="float32", *, device: Optional[str] = None):
    """Real-input n-d forward: np.fft.rfftn bin layout (last axis halved
    to N//2+1), unscaled.  Built as rfft_any on the minor axis followed
    by complex transforms on the rest."""

    half = _bs.rfft_any(x, dtype, device=device)  # [..., n_last//2 + 1] complex
    rest = tuple(half.shape[:-1])
    if not rest:
        return half
    nd = NdPlan(rest, dtype)
    rr, ri = fftn_split(nd, (half.real.movedim(-1, 0), half.imag.movedim(-1, 0)),
                        _plan.FORWARD)
    return torch.complex(rr, ri).movedim(0, -1).contiguous()


def irfftn(s, shape: Sequence[int], dtype="float32", *, device: Optional[str] = None):
    """Inverse of :func:`rfftn` for a real result of extents ``shape``
    (unscaled: irfftn(rfftn(x), x.shape) == prod(shape) * x)."""

    shape = tuple(int(v) for v in shape)
    rest, n_last = shape[:-1], shape[-1]
    sshape = _shape(s)
    if tuple(sshape[-len(shape):-1]) != rest or sshape[-1] != n_last // 2 + 1:
        raise ValueError(
            f"spectrum trailing shape {tuple(sshape[-len(shape):])} does not "
            f"match rfftn of {shape}")
    if rest:
        nd = NdPlan(rest, dtype)
        z = _fft._as_tensor(s, device, nd).to(_fft._complex_dtype(nd))
        rr, ri = fftn_split(nd, (z.real.movedim(-1, 0), z.imag.movedim(-1, 0)),
                            _plan.BACKWARD)
        s = torch.complex(rr, ri).movedim(0, -1)
    return _bs.irfft_any(s, n_last, dtype, device=device)
