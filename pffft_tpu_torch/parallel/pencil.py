"""Pencil-decomposed distributed 2-D FFT over a device mesh.

Counterpart of ``pffft_tpu/parallel/pencil.py``.  The classic multi-device
n-d FFT: shard the ROW axis, transform the contiguous column axis locally,
re-shard with one ``all_to_all`` transpose, transform the other axis
locally.  Exactly two exchanges per direction (one with
``transposed=True``), each moving the payload once — the same
O(1)-in-D communication shape as the four-step 1-D plan (fourstep.py).

The local transforms go through the port's dispatcher: the rows of the
contiguous axis batch-major ([B*n0/D, n1]: B9 up to 16384), the other
axis as time-major planes [n0, B*n1/D] (the chain, or kern2).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import plan as _plan
from ..ops import dispatch as _dispatch
from . import _comm
from .fourstep import to_planes

__all__ = ["Pencil2D"]


class Pencil2D:
    """Distributed complex 2-D FFT of extents ``(n0, n1)``.

    The operand's trailing two axes are the transform axes; axis -2
    (length n0) is sharded over the mesh axis, axis -1 is local.  Both
    extents must be 2/3/5-smooth and divisible by the shard count.

    ``forward(x)`` -> spectrum with the SAME sharding as the input
    (costs 2 all_to_all); ``forward(x, transposed=True)`` skips the
    final transpose exchange and returns the spectrum with axes
    swapped, sharded the same way — useful when the consumer is a
    pointwise multiply followed by ``backward(..., transposed=True)``,
    which accepts that layout (a full conv round trip then costs 2
    exchanges instead of 4).
    Unscaled: ``backward(forward(x)) == n0 * n1 * x``.
    """

    def __init__(self, shape: Sequence[int], mesh: DeviceMesh, *,
                 dtype="float32", axis_name: Optional[str] = None):
        self.n0, self.n1 = (int(s) for s in shape)
        self.mesh = mesh
        self._ax = _comm.MeshAxis(mesh, axis_name)
        self.axis = self._ax.name
        self.n_shards = d = self._ax.size
        if self.n0 % d or self.n1 % d:
            raise ValueError(
                f"extents {(self.n0, self.n1)} must be divisible by the "
                f"shard count {d}")
        self.dtype = np.dtype(dtype)
        self.plan0 = _plan.Plan.create(self.n0, _plan.COMPLEX, dtype, strict=False)
        self.plan1 = _plan.Plan.create(self.n1, _plan.COMPLEX, dtype, strict=False)
        self.cdtype = self.plan0.cdtype
        self._rdtype = torch.float64 if self.dtype == np.float64 else torch.float32

    # --- rank-local phases on planes ----------------------------------------
    def _rows(self, planes, backward: bool):
        """Transforms along the contiguous axis of [B, n0/D, n1] planes."""

        yr, yi = planes
        rr, ri = _dispatch.cfft_dispatch(self.plan1, yr.reshape(-1, self.n1).contiguous(),
                                         yi.reshape(-1, self.n1).contiguous(), backward=backward,
                                         time_major=False)
        return rr.view(yr.shape), ri.view(yi.shape)

    def _cols(self, planes, backward: bool):
        """Transforms along axis 0 of [n0, B, n1/D] planes (time-major)."""

        ar, ai = planes
        rr, ri = _dispatch.cfft_dispatch(self.plan0, ar.reshape(self.n0, -1).contiguous(),
                                         ai.reshape(self.n0, -1).contiguous(), backward=backward)
        return rr.view(ar.shape), ri.view(ai.shape)

    def _fwd_core(self, planes, transposed: bool):
        ax, n0, n1 = self._ax, self.n0, self.n1
        y = self._rows(planes, False)                        # rows (local, full n1)
        y = self._cols(ax.rows_to_cols(y, n0, n1), False)    # [n0, B, n1/D]
        if transposed:
            return tuple(t.permute(1, 2, 0) for t in y)      # [B, n1/D, n0]
        return ax.cols_to_rows(y, n0, n1)                    # [B, n0/D, n1]

    def _bwd_core(self, planes, transposed: bool):
        ax, n0, n1 = self._ax, self.n0, self.n1
        if transposed:
            y = tuple(t.permute(2, 0, 1).contiguous() for t in planes)  # [n0, B, n1/D]
        else:
            y = ax.rows_to_cols(planes, n0, n1)
        y = self._cols(y, True)
        return self._rows(ax.cols_to_rows(y, n0, n1), True)

    def _check(self, x, transposed_in: bool) -> None:
        want = (self.n1, self.n0) if transposed_in else (self.n0, self.n1)
        if tuple(x.shape[-2:]) != want:
            raise ValueError(
                f"trailing axes {tuple(x.shape[-2:])} do not match plan "
                f"{'transposed ' if transposed_in else ''}extents {want}")

    def _run(self, x, backward: bool, transposed: bool, transposed_in: bool):
        self._check(x, transposed_in)
        xl, place = self._ax.local(x, -2)
        lead, (a, c) = xl.shape[:-2], xl.shape[-2:]
        planes = to_planes(xl.reshape(-1, a, c), self._rdtype)
        core = self._bwd_core if backward else self._fwd_core
        yr, yi = core(planes, transposed)
        out = torch.complex(yr, yi).contiguous()
        return self._ax.dtensor(out.reshape(*lead, *out.shape[1:]), place)

    # --- public -------------------------------------------------------------
    def forward(self, x, transposed: bool = False):
        """[..., n0, n1] -> spectrum ([..., n1, n0] if transposed)."""

        return self._run(x, False, transposed, False)

    def backward(self, s, transposed: bool = False):
        """Unscaled inverse; with ``transposed=True`` accepts the
        transposed spectrum layout from ``forward(..., transposed=True)``."""

        return self._run(s, True, transposed, transposed)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Pencil2D(({self.n0}, {self.n1}), D={self.n_shards}, "
                f"{self.dtype.name})")
