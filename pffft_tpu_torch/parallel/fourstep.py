"""Four-step (Bailey) decomposition: one large-N FFT over a device mesh.

Counterpart of ``pffft_tpu/parallel/fourstep.py``: the TP/SP analog.
PFFFT's own engine is a miniature of the idea (its 4-lane SIMD complex
FFT is a two-level N = 4 x (N/4) decomposition with a transpose+twiddle
"finalize"); here the two levels are rank-local FFT phases and the
transposes are ``all_to_all`` exchanges over the mesh axis's process
group.

Algebra (decimation in time over n = n1*N2 + n2, bins k = k1 + N1*k2):

    A[k1, n2] = CFFT_N1 over n1 of x[n1, n2]                    (column FFTs)
    Y[k1, k2] = CFFT_N2 over n2 of ( A[k1, n2] * W_N^{k1*n2} )  (row FFTs)
    X[k1 + N1*k2] = Y[k1, k2]

Distribution:

    local [N1/D, N2]  --all_to_all-->  [N1, N2/D]   column FFTs + twiddle
                      --all_to_all-->  [N1/D, N2]   row FFTs
    ordered output: one more all_to_all + local transpose.

The k1-major flattening of Y is the plan's **internal order** — the
distributed rendition of pffft's unordered z-domain layout: free to
produce, pointwise convolution works in it, and :meth:`FourStepPlan.reorder`
(one all-to-all) maps to canonical order.

The local phases go through the port's dispatcher
(``ops/dispatch.cfft_dispatch``), so they run the ported kernels: the
column transforms are time-major planes [N1, B*N2/D] (the chain, or kern2
past its tile), the row transforms batch-major rows [B*N1/D, N2] (B9 up to
16384).  A call splits its input into (re, im) planes once and joins them
once; every phase between works on planes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import plan as _plan
from ..ops import dispatch as _dispatch
from . import _comm
from . import mesh as _mesh

__all__ = ["FourStepPlan", "fourstep_cfft", "fourstep_icfft", "fourstep_rfft", "fourstep_irfft"]


def _split_n(n: int, n1: Optional[int], n_shards: int) -> Tuple[int, int]:
    """Choose N = N1 * N2 with both factors 2/3/5-smooth and divisible by the
    shard count (so both FFT phases are exactly shard-local), preferring
    balanced factors (minimum total twiddle/transpose imbalance)."""

    if n1 is not None:
        if n % n1:
            raise ValueError(f"N1={n1} does not divide N={n}")
        return n1, n // n1

    best = None
    for cand in _smooth_divisors(n):
        n2 = n // cand
        if cand % n_shards or n2 % n_shards:
            continue
        score = abs(math.log(cand) - math.log(n2))
        if best is None or score < best[0]:
            best = (score, cand)
    if best is None:
        raise ValueError(
            f"cannot split N={n} into two 2/3/5-smooth factors each divisible "
            f"by {n_shards} shards"
        )
    return best[1], n // best[1]


def _smooth_divisors(n: int):
    fs = _plan.decompose_smooth(n)
    divs = {1}
    for p in fs:
        divs |= {d * p for d in divs}
    return sorted(divs)


def _twiddle_np(n1: int, n2: int, cdtype) -> np.ndarray:
    """W_N^{k1*n2} (forward sign), exact integer phase reduction then float64
    trig, matching the conditioning policy of plan.py twiddles."""

    n = n1 * n2
    k1 = np.arange(n1, dtype=np.int64)[:, None]
    m2 = np.arange(n2, dtype=np.int64)[None, :]
    e = (k1 * m2) % n
    ang = (2.0 * np.pi / n) * e.astype(np.float64)
    return (np.cos(ang) - 1j * np.sin(ang)).astype(cdtype)


def cmul(ar, ai, br, bi, conj: bool = False):
    """(ar + i ai) * (br + i bi), or times the conjugate of b."""

    if conj:
        return ar * br + ai * bi, ai * br - ar * bi
    return ar * br - ai * bi, ar * bi + ai * br


def to_planes(x: torch.Tensor, rdtype: torch.dtype):
    """(re, im) views of a tensor of any dtype, as ``rdtype``."""

    if x.is_complex():
        return x.real.to(rdtype), x.imag.to(rdtype)
    return x.to(rdtype), torch.zeros_like(x, dtype=rdtype)


class FourStepPlan:
    """Distributed plan for one complex FFT of length N = N1 * N2.

    Read-only, like a local :class:`~pffft_tpu_torch.plan.Plan`.
    ``kind=REAL`` adds the half-length split step (N must then be even; the
    complex engine runs at N/2, as the local real path does).  Inputs are
    DTensors on ``mesh`` or tensors (the same global tensor on every rank);
    outputs are DTensors with the last axis sharded over ``axis_name``.
    """

    def __init__(
        self,
        n: int,
        mesh: DeviceMesh,
        *,
        kind=_plan.COMPLEX,
        dtype="float32",
        axis_name: Optional[str] = None,
        n1: Optional[int] = None,
        max_factor=None,
    ):
        self.mesh = mesh
        self._ax = _comm.MeshAxis(mesh, axis_name)
        self.axis = self._ax.name
        self.n_shards = self._ax.size
        self.kind = _plan._coerce_kind(kind)
        self.n = int(n)
        self.dtype = np.dtype(dtype)

        engine_n = self.n // 2 if self.kind == _plan.REAL else self.n
        self.engine_n = engine_n
        self.n1, self.n2 = _split_n(engine_n, n1, self.n_shards)
        # local sub-plans run with no SIMD-granularity constraint
        self.plan1 = _plan.Plan.create(self.n1, _plan.COMPLEX, dtype, strict=False,
                                       max_factor=max_factor)
        self.plan2 = _plan.Plan.create(self.n2, _plan.COMPLEX, dtype, strict=False,
                                       max_factor=max_factor)
        self.cdtype = self.plan1.cdtype
        self._rdtype = torch.float64 if self.dtype == np.float64 else torch.float32
        # this rank's columns of the twiddle, [N1, 1, N2/D] for the column
        # phase's [N1, B, N2/D] planes
        d2 = self.n2 // self.n_shards
        cols = slice(self._ax.rank * d2, (self._ax.rank + 1) * d2)
        tw = _twiddle_np(self.n1, self.n2, self.cdtype)[:, None, cols]
        self._tw = (self._ax.tensor(tw.real), self._ax.tensor(tw.imag))
        if self.kind == _plan.REAL:
            h = engine_n // self.n_shards
            rtw = _plan._real_split_twiddle(self.n, -1, self.cdtype)
            rtw = rtw[self._ax.rank * h:(self._ax.rank + 1) * h]
            self._real_tw = (self._ax.tensor(rtw.real), self._ax.tensor(rtw.imag))

    # --- rank-local cores on planes [B, N/D] ------------------------------
    def _cols(self, planes, backward: bool):
        """The column transforms of [N1, B, N2/D] planes (time-major)."""

        ar, ai = planes
        shape = ar.shape
        rr, ri = _dispatch.cfft_dispatch(self.plan1, ar.reshape(self.n1, -1).contiguous(),
                                         ai.reshape(self.n1, -1).contiguous(), backward=backward)
        return rr.view(shape), ri.view(shape)

    def _rows(self, planes, backward: bool):
        """The row transforms of [B, N1/D, N2] planes (batch-major)."""

        yr, yi = planes
        shape = yr.shape
        rr, ri = _dispatch.cfft_dispatch(self.plan2, yr.reshape(-1, self.n2).contiguous(),
                                         yi.reshape(-1, self.n2).contiguous(), backward=backward,
                                         time_major=False)
        return rr.view(shape), ri.view(shape)

    def _fwd_core(self, xr, xi, ordered: bool):
        b, ax = xr.shape[0], self._ax
        n1, n2, d = self.n1, self.n2, self.n_shards
        rows = (xr.reshape(b, n1 // d, n2), xi.reshape(b, n1 // d, n2))
        a = self._cols(ax.rows_to_cols(rows, n1, n2), False)   # [N1, B, N2/D]
        a = cmul(*a, *self._tw)                                  # W_N^{k1*n2}
        y = self._rows(ax.cols_to_rows(a, n1, n2), False)      # [B, N1/D, N2]
        if ordered:
            y = ax.transpose_rows(y, n1, n2)                     # [B, N2/D, N1]
        return tuple(t.reshape(b, -1) for t in y)

    def _bwd_core(self, sr, si, ordered: bool):
        b, ax = sr.shape[0], self._ax
        n1, n2, d = self.n1, self.n2, self.n_shards
        if ordered:
            y = ax.transpose_rows((sr.reshape(b, n2 // d, n1), si.reshape(b, n2 // d, n1)),
                                  n2, n1)                         # [B, N1/D, N2]
        else:
            y = (sr.reshape(b, n1 // d, n2), si.reshape(b, n1 // d, n2))
        a = ax.rows_to_cols(self._rows(y, True), n1, n2)         # [N1, B, N2/D]
        a = self._cols(cmul(*a, *self._tw, conj=True), True)
        x = ax.cols_to_rows(a, n1, n2)                           # [B, N1/D, N2]
        return tuple(t.reshape(b, -1) for t in x)

    # --- real split steps.  The Hermitian mirror y[k] = z[(H-k) mod H]
    # crosses shard boundaries: a local flip, the shard reversal and a
    # rotate by one element across the boundary (send/recv), the
    # distributed rendition of pffft's reversed_copy. ----------------------
    def _rev1(self, planes):
        """This rank's piece of the global y[k] = z[(H-k) mod H] mirror."""

        ax, d = self._ax, self.n_shards
        f = torch.flip(torch.stack(planes), (-1,))
        if d > 1:
            # global flip: rank s now holds flip-block D-1-s -> swap ranks
            partner = d - 1 - ax.rank
            if partner != ax.rank:
                f = _comm.shift(f, partner, partner, ax.group)
            # rotate right by one element across the rank boundary
            prev = _comm.shift(f[..., -1:], (ax.rank + 1) % d, (ax.rank - 1) % d, ax.group)
        else:
            prev = f[..., -1:]
        out = torch.cat([prev, f[..., :-1]], dim=-1)
        return out[0], out[1]

    def _real_post_fwd(self, zr, zi):
        rr, ri = self._rev1((zr, zi))
        er, ei = 0.5 * (zr + rr), 0.5 * (zi - ri)
        orr, oi = 0.5 * (zi + ri), -0.5 * (zr - rr)
        tr, ti = cmul(orr, oi, *self._real_tw)
        sr, si = er + tr, ei + ti
        if self._ax.rank == 0:  # bin0 = DC + i*Nyquist
            z0r, z0i = zr[:, 0], zi[:, 0]
            sr[:, 0], si[:, 0] = z0r + z0i, z0r - z0i
        return sr, si

    def _real_pre_bwd(self, sr, si):
        xar, xai = sr, si
        if self._ax.rank == 0:
            xar, xai = sr.clone(), si.clone()
            xai[:, 0] = 0  # bin0's DC
        xbr, xbi = self._rev1((xar, xai))
        if self._ax.rank == 0:
            xbr, xbi = xbr.clone(), xbi.clone()
            xbr[:, 0], xbi[:, 0] = si[:, 0], 0  # bin0's Nyquist
        er, ei = xar + xbr, xai - xbi
        orr, oi = cmul(xar - xbr, xai + xbi, *self._real_tw, conj=True)
        return er - oi, ei + orr

    # --- public ----------------------------------------------------------
    def _check_len(self, x, want: int):
        if x.shape[-1] != want:
            raise ValueError(f"last axis {x.shape[-1]} does not match the plan's length {want}")

    def forward(self, x, ordered: bool = True):
        """Forward transform of [..., N] (last axis sharded over the mesh).

        REAL kind: [..., N] real -> [..., N/2] complex, pffft bin0 packing.
        """

        self._check_len(x, self.n)
        xl, place = self._ax.local(x, -1)
        lead = xl.shape[:-1]
        xl = xl.reshape(-1, xl.shape[-1])
        if self.kind == _plan.REAL:
            xr = xl.to(self._rdtype)
            zr, zi = self._fwd_core(xr[:, 0::2], xr[:, 1::2], True)
            sr, si = self._real_post_fwd(zr, zi)
        else:
            sr, si = self._fwd_core(*to_planes(xl, self._rdtype), ordered)
        out = torch.complex(sr, si)
        return self._ax.dtensor(out.reshape(*lead, -1), place)

    def backward(self, s, ordered: bool = True):
        """Unscaled inverse: backward(forward(x)) == N * x (pffft.h:134)."""

        self._check_len(s, self.engine_n)
        sl, place = self._ax.local(s, -1)
        lead = sl.shape[:-1]
        sr, si = to_planes(sl.reshape(-1, sl.shape[-1]), self._rdtype)
        if self.kind == _plan.REAL:
            wr, wi = self._bwd_core(*self._real_pre_bwd(sr, si), True)
            out = torch.stack([wr, wi], dim=-1)
        else:
            out = torch.complex(*self._bwd_core(sr, si, ordered))
        return self._ax.dtensor(out.reshape(*lead, -1), place)

    def reorder(self, z, to_canonical: bool = True):
        """zreorder analog between the internal (k1-major) and canonical
        orders; costs one all-to-all transpose."""

        self._check_len(z, self.engine_n)
        zl, place = self._ax.local(z, -1)
        lead, b, d = zl.shape[:-1], zl[..., 0].numel(), self.n_shards
        a, c = (self.n1, self.n2) if to_canonical else (self.n2, self.n1)
        planes = to_planes(zl.reshape(b, a // d, c), self._rdtype)
        yr, yi = self._ax.transpose_rows(planes, a, c)
        return self._ax.dtensor(torch.complex(yr, yi).reshape(*lead, -1), place)

    def input_sharding(self, ndim: int):
        """The placements of an input with its last axis sharded."""

        return _mesh.batch_sharding(self.mesh, ndim, -1, self.axis)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"FourStepPlan(N={self.n}={self.n1}x{self.n2}, {self.kind.value}, "
            f"{self.n_shards} shards over '{self.axis}')"
        )


# Functional conveniences -----------------------------------------------------


def fourstep_cfft(plan: FourStepPlan, x, ordered: bool = True):
    return plan.forward(x, ordered=ordered)


def fourstep_icfft(plan: FourStepPlan, s, ordered: bool = True):
    return plan.backward(s, ordered=ordered)


def fourstep_rfft(plan: FourStepPlan, x):
    return plan.forward(x)


def fourstep_irfft(plan: FourStepPlan, s):
    return plan.backward(s)
