"""Split-format (planar re/im) stage engine and real steps.

Counterpart of ``pffft_tpu/ops/split.py``'s ``"xla"`` engine in its
``"4mul"`` form: each Stockham stage is an elementwise twiddle multiply and
a dense [r, r] DFT-matrix contraction (``torch.einsum``).  The dispatcher
sends here the shapes that no CUDA kernel covers.  Both layouts are here:
time-major planes [N, B] (:func:`cfft_stages_split_tmajor`) and batch-major
planes [..., N] (:func:`cfft_stages_split`, :func:`cfft_plan_split`).

The real transform's steps are here too, in both layouts: the pack of a
real signal into the half-length complex input, the split steps
(REAL_FINALIZE forward, REAL_PREPROCESS backward) and the interleave back.
They are plain torch ops; the split twiddles are passed as a pair of
tensors [H] of the plan's dtype on the data's device,
:func:`real_split_twiddle`.

The contractions run in full fp32: reduced-precision products (TF32) give
relative errors of 1e-5 to 1e-3 and break the 140 dB carrier bound, so the
stage engines turn TF32 off and the matmul precision to "highest" for
their duration.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import plan as _plan

SplitPair = Tuple[torch.Tensor, torch.Tensor]

# Above this many elements a twiddle table is factored into split tables
# T[k, i] = A[k_hi, i] * B[k_lo, i] (k = k_hi * _TW_SPLIT_LO + k_lo), with
# KB-sized constants in place of an l*r-sized table; exponents reduce
# exactly in integers, so A*B == T up to one extra rounding.
_TW_SPLIT_MIN = 1 << 21
_TW_SPLIT_LO = 128


# ---------------------------------------------------------------------------
# Planar complex arithmetic
# ---------------------------------------------------------------------------


def to_split(x: torch.Tensor) -> SplitPair:
    """Complex tensor [..., N] -> contiguous (re, im) planes, in one copy."""

    t = torch.view_as_real(x.resolve_conj()).movedim(-1, 0).contiguous()
    return t[0], t[1]


def from_split(p: SplitPair, cdtype=None) -> torch.Tensor:
    """(re, im) planes -> complex tensor (``cdtype`` converts it)."""

    z = torch.complex(*p)
    return z.to(cdtype) if cdtype is not None else z


def split_mul(a: SplitPair, b: SplitPair) -> SplitPair:
    """(a.re + i a.im) * (b.re + i b.im), elementwise."""

    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def split_conj_mul(a: SplitPair, b: SplitPair) -> SplitPair:
    """a * conj(b), elementwise."""

    ar, ai = a
    br, bi = b
    return ar * br + ai * bi, ai * br - ar * bi


# ---------------------------------------------------------------------------
# Stage engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4096)
def _stage_consts(stage, backward: bool):
    """Host-side split of a stage's complex tables: (dft_re, dft_im, tw).

    ``tw`` is ("dense", re, im) or ("split", lo, Ar, Ai, Br, Bi)."""

    dft = np.conj(stage.dft) if backward else stage.dft
    tw = stage.twiddle  # stored forward-sign; conjugated below for backward
    twc = _tw_consts_from_table(tw, tw.shape[0] * tw.shape[1], backward)
    return np.ascontiguousarray(dft.real), np.ascontiguousarray(dft.imag), twc


def _tw_consts_from_table(tw: np.ndarray, period: int, backward: bool):
    """Dense or split constants for a product-exponent table
    T[a, b] = exp(-2i pi a b / period); ``backward`` conjugates."""

    if backward:
        tw = np.conj(tw)
    l, r = tw.shape
    if l * r >= _TW_SPLIT_MIN and l % _TW_SPLIT_LO == 0:
        lo = _TW_SPLIT_LO
        sign = 1 if backward else -1
        hi_k = (np.arange(l // lo, dtype=np.int64)[:, None] * lo) % period
        lo_k = np.arange(lo, dtype=np.int64)[:, None]
        i = np.arange(r, dtype=np.int64)[None, :]
        ang_a = (2.0 * np.pi / period) * ((hi_k * i) % period).astype(np.float64)
        ang_b = (2.0 * np.pi / period) * ((lo_k * i) % period).astype(np.float64)
        dt = tw.real.dtype
        return (
            "split",
            lo,
            np.cos(ang_a).astype(dt), (np.sin(ang_a) * sign).astype(dt),
            np.cos(ang_b).astype(dt), (np.sin(ang_b) * sign).astype(dt),
        )
    return ("dense", np.ascontiguousarray(tw.real), np.ascontiguousarray(tw.imag))


@functools.lru_cache(maxsize=4096)
def _device_consts(stage, backward: bool, device: torch.device):
    """:func:`_stage_consts` as tensors on ``device`` (cached per stage)."""

    dr, di, twc = _stage_consts(stage, backward)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tw = (twc[0], twc[1], *map(put, twc[2:])) if twc[0] == "split" else (
        twc[0], *map(put, twc[1:]))
    return put(dr), put(di), tw


def _contract_stage(ar, ai, consts, sub: str):
    """One stage's complex DFT-matrix contraction, planar, 4 real einsums.

    ``sub`` contracts index ``r`` against the [r, t] DFT matrix."""

    dr, di, _ = consts
    nr = torch.einsum(sub, ar, dr) - torch.einsum(sub, ai, di)
    ni = torch.einsum(sub, ar, di) + torch.einsum(sub, ai, dr)
    return nr, ni


def _apply_twiddle(ar, ai, twc, l_axis: int):
    """Elementwise product twiddle T[a, b] on axes (l_axis, l_axis + 1).

    Split form: the l axis is viewed as (l_hi, lo) and A[l_hi, r] then
    B[lo, r] are applied."""

    shape = ar.shape
    nd = len(shape)
    l_axis %= nd
    r_axis = l_axis + 1
    l, r = shape[l_axis], shape[r_axis]
    if twc[0] == "dense":
        _, twr, twi = twc
        b = [1] * nd
        b[l_axis], b[r_axis] = l, r
        wr, wi = twr.reshape(b), twi.reshape(b)
        return ar * wr - ai * wi, ar * wi + ai * wr
    _, lo, a_r, a_i, b_r, b_i = twc
    hi = l // lo
    ns = shape[:l_axis] + (hi, lo) + shape[l_axis + 1 :]
    xr = ar.reshape(ns)
    xi = ai.reshape(ns)
    ba = [1] * (nd + 1)
    ba[l_axis], ba[r_axis + 1] = hi, r
    bb = [1] * (nd + 1)
    bb[l_axis + 1], bb[r_axis + 1] = lo, r
    war, wai = a_r.reshape(ba), a_i.reshape(ba)
    wbr, wbi = b_r.reshape(bb), b_i.reshape(bb)
    xr, xi = xr * war - xi * wai, xr * wai + xi * war
    xr, xi = xr * wbr - xi * wbi, xr * wbi + xi * wbr
    return xr.reshape(shape), xi.reshape(shape)


@contextlib.contextmanager
def _full_fp32():
    """No TF32 (matmuls and cuDNN convolutions) and "highest" matmul
    precision inside the block."""

    tf32 = torch.backends.cuda.matmul.allow_tf32
    conv_tf32 = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cudnn.allow_tf32 = conv_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32


def cfft_stages_split_tmajor(
    re: torch.Tensor,
    im: torch.Tensor,
    stages: Sequence,
    *,
    backward: bool,
    ordered: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staged complex FFT in TIME-MAJOR layout: planes [N, B] -> [N, B].

    Unscaled.  ``ordered`` gives canonical bin order; otherwise the last
    stage leaves the internal order of the reference engine."""

    n, b = re.shape
    ar = re.reshape(1, n, b)
    ai = im.reshape(1, n, b)
    nstages = len(stages)
    with _full_fp32():
        for idx, st in enumerate(stages):
            l, r, m = st.l, st.r, st.m
            if r == 1:
                continue
            consts = _device_consts(st, backward, re.device)
            ar = ar.reshape(l, r, m, b)
            ai = ai.reshape(l, r, m, b)
            if l > 1:
                ar, ai = _apply_twiddle(ar, ai, consts[2], 0)
            last = idx == nstages - 1
            sub = "lrmb,rt->ltmb" if (last and not ordered) else "lrmb,rt->tlmb"
            ar, ai = _contract_stage(ar, ai, consts, sub)
            ar, ai = ar.reshape(l * r, m, b), ai.reshape(l * r, m, b)
    return ar.reshape(n, b), ai.reshape(n, b)


def cfft_stages_split(
    re: torch.Tensor,
    im: torch.Tensor,
    stages: Sequence,
    *,
    backward: bool,
    ordered: bool,
) -> SplitPair:
    """Staged complex FFT over the last axis, planar: [..., N] x2 -> [..., N] x2.

    Batch-major mirror of :func:`cfft_stages_split_tmajor`, the same
    Stockham stages and tables.  Unscaled.  ``ordered`` gives canonical bin
    order; otherwise the last stage leaves the internal order (flat index
    l*r_last + t holds bin t*L + l, ``stages.reorder_spectrum``)."""

    lead = re.shape[:-1]
    n = re.shape[-1]
    b = int(np.prod(lead)) if lead else 1
    ar = re.reshape(b, 1, n)
    ai = im.reshape(b, 1, n)
    nstages = len(stages)
    with _full_fp32():
        for idx, st in enumerate(stages):
            l, r, m = st.l, st.r, st.m
            if r == 1:
                continue
            consts = _device_consts(st, backward, re.device)
            ar = ar.reshape(b, l, r, m)
            ai = ai.reshape(b, l, r, m)
            if l > 1:
                ar, ai = _apply_twiddle(ar, ai, consts[2], 1)
            last = idx == nstages - 1
            sub = "blrm,rt->bltm" if (last and not ordered) else "blrm,rt->btlm"
            ar, ai = _contract_stage(ar, ai, consts, sub)
            ar, ai = ar.reshape(b, l * r, m), ai.reshape(b, l * r, m)
    return ar.reshape(*lead, n), ai.reshape(*lead, n)


@functools.lru_cache(maxsize=64)
def _ordered_chain(n: int, dtype: str) -> _plan.Plan:
    """The port's default stage chain for length n (radix <= 5)."""

    return _plan.new_setup(n, _plan.COMPLEX, dtype=dtype, strict=False)


def cfft_plan_split(
    plan: _plan.Plan,
    re: torch.Tensor,
    im: torch.Tensor,
    *,
    backward: bool,
    ordered: bool,
) -> SplitPair:
    """Plan-level complex FFT over the last axis, planar, batch-major.

    A plan with a ``local_split`` (the reference's four-step plans, which
    reach the port only through ``plan_from_reference`` / ``load_plan``)
    has factors (n1, n2) and the ordinary two-stage layout contract: its
    ordered output does not depend on the factorization, so it runs the
    port's default chain; its internal order is the k1-major order of
    (n1, n2).  As in the reference's four-step, ``ordered=False`` means
    internal-order output forward and internal-order input backward."""

    if plan.local_split is None:
        return cfft_stages_split(re, im, plan.stages, backward=backward, ordered=ordered)
    from . import stages as _stages

    chain = _ordered_chain(plan.engine_n, plan.dtype.name).stages
    if backward and not ordered:
        re = _stages.reorder_spectrum(re, plan.factors, to_canonical=True)
        im = _stages.reorder_spectrum(im, plan.factors, to_canonical=True)
    ar, ai = cfft_stages_split(re, im, chain, backward=backward, ordered=True)
    if ordered or backward:
        return ar, ai
    return (_stages.reorder_spectrum(ar, plan.factors, to_canonical=False),
            _stages.reorder_spectrum(ai, plan.factors, to_canonical=False))


# ---------------------------------------------------------------------------
# Real transform steps, time-major planes [H, B] and batch-major [..., H]
# (H = N/2).  One body per step, along ``axis`` 0 (time-major) or -1.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def real_split_twiddle(plan, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A real plan's split twiddles exp(-2i pi k / N), k < N/2, as (re, im)
    tensors [H] of the plan's dtype on ``device`` (cached per plan and
    device)."""

    tw = plan.real_twiddle
    return (
        torch.from_numpy(np.ascontiguousarray(tw.real, plan.dtype)).to(device),
        torch.from_numpy(np.ascontiguousarray(tw.imag, plan.dtype)).to(device),
    )


def _mirror(h: int, device) -> torch.Tensor:
    """Row index (H - k) % H."""

    return (h - torch.arange(h, device=device)) % h


def _mirrored(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x[(H - k) % H] along ``axis``."""

    return x.index_select(axis, _mirror(x.shape[axis], x.device))


def _twiddle_along(real_twiddle, axis: int):
    wr, wi = real_twiddle
    return (wr[:, None], wi[:, None]) if axis == 0 else (wr, wi)


def _bin0(x: torch.Tensor, axis: int) -> torch.Tensor:
    return x.select(axis, 0)


def _forward_split(zr, zi, real_twiddle, axis: int):
    """REAL_FINALIZE in the even/odd form along ``axis``."""

    cr, ci = _mirrored(zr, axis), -_mirrored(zi, axis)
    er, ei = 0.5 * (zr + cr), 0.5 * (zi + ci)
    orr, oi = 0.5 * (zi - ci), -0.5 * (zr - cr)
    wr, wi = _twiddle_along(real_twiddle, axis)
    xr = er + wr * orr - wi * oi
    xi = ei + wr * oi + wi * orr
    _bin0(xr, axis).copy_(_bin0(zr, axis) + _bin0(zi, axis))
    _bin0(xi, axis).copy_(_bin0(zr, axis) - _bin0(zi, axis))
    return xr, xi


def _backward_split(sr, si, real_twiddle, axis: int):
    """REAL_PREPROCESS in the even/odd form along ``axis``; returns 2*Z."""

    xar = sr
    xai = si.clone()
    _bin0(xai, axis).zero_()
    xbr = _mirrored(sr, axis)
    _bin0(xbr, axis).copy_(_bin0(si, axis))
    xbi = _mirrored(xai, axis)
    er, ei = xar + xbr, xai - xbi
    dr, di = xar - xbr, xai + xbi
    wr, wi = _twiddle_along(real_twiddle, axis)
    orr = wr * dr + wi * di
    oi = wr * di - wi * dr
    return er - oi, ei + orr


def _forward_split_flat(zr, zi, real_twiddle, axis: int):
    """REAL_FINALIZE in the flat form, one fused expression per output over
    Z[k] and Z[(H - k) % H]: the arithmetic, in the same order, of the split
    kernels (csrc/real.cuh ``real_finalize``)."""

    wr, wi = _twiddle_along(real_twiddle, axis)
    a = 0.5 * (1.0 + wi)
    b = 0.5 * wr
    c = 0.5 * (1.0 - wi)
    fr, fi = _mirrored(zr, axis), _mirrored(zi, axis)
    xr = a * zr + b * zi + c * fr + b * fi
    xi = -b * zr + a * zi + b * fr - c * fi
    _bin0(xr, axis).copy_(_bin0(zr, axis) + _bin0(zi, axis))
    _bin0(xi, axis).copy_(_bin0(zr, axis) - _bin0(zi, axis))
    return xr, xi


def _backward_split_flat(sr, si, real_twiddle, axis: int):
    """REAL_PREPROCESS in the flat form, the arithmetic of the split
    kernels (csrc/real.cuh ``real_prep``); returns 2*Z."""

    wr, wi = _twiddle_along(real_twiddle, axis)
    xar = sr
    xai = si.clone()
    _bin0(xai, axis).zero_()
    xbr = _mirrored(sr, axis)
    _bin0(xbr, axis).copy_(_bin0(si, axis))
    xbi = _mirrored(si, axis)
    _bin0(xbi, axis).zero_()
    p = 1.0 + wi
    q = 1.0 - wi
    zr = p * xar - wr * xai + q * xbr - wr * xbi
    zi = wr * xar + p * xai - wr * xbr - q * xbi
    return zr, zi


def pack_real_input_split_tmajor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, B] real -> planar [N/2, B] x2, z[m] = x[2m] + i x[2m+1].

    Two column slices of the free [H, 2B] view: row h of the view is
    x[2h] followed by x[2h+1].  The planes are views, not copies."""

    n, b = x.shape
    y = x.reshape(n // 2, 2 * b)
    return y[:, :b], y[:, b:]


def _reverse_conj_split_tmajor(zr, zi) -> Tuple[torch.Tensor, torch.Tensor]:
    """y[k] = conj(z[(H - k) mod H]) along axis 0."""

    return _mirrored(zr, 0), -_mirrored(zi, 0)


def real_forward_split_planar_tmajor(zr, zi, real_twiddle):
    """REAL_FINALIZE in the even/odd form: the length-H transform Z [H, B]
    x2 -> the packed real spectrum, bin0 = DC + i*Nyquist."""

    return _forward_split(zr, zi, real_twiddle, 0)


def real_backward_split_planar_tmajor(sr, si, real_twiddle):
    """REAL_PREPROCESS in the even/odd form: the packed spectrum [H, B] x2
    -> 2*Z, the input of the backward length-H transform."""

    return _backward_split(sr, si, real_twiddle, 0)


def real_forward_split_planar_tmajor_flat(zr, zi, real_twiddle):
    """REAL_FINALIZE in the flat form on [H, B] planes (csrc/real.cuh)."""

    return _forward_split_flat(zr, zi, real_twiddle, 0)


def real_backward_split_planar_tmajor_flat(sr, si, real_twiddle):
    """REAL_PREPROCESS in the flat form on [H, B] planes; returns 2*Z."""

    return _backward_split_flat(sr, si, real_twiddle, 0)


def interleave_to_real_split_tmajor(wr, wi) -> torch.Tensor:
    """Planar [H, B] x2 -> [N, B] real, x[2m] = re[m], x[2m+1] = im[m]:
    the columns side by side as [H, 2B], which is [N, B] row-major."""

    h, b = wr.shape
    return torch.cat([wr, wi], dim=1).reshape(2 * h, b)


def _reverse_conj_split(zr, zi) -> SplitPair:
    """y[k] = conj(z[(H - k) mod H]) along the last axis."""

    return _mirrored(zr, -1), -_mirrored(zi, -1)


def _set_bin0(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A copy of x with x[..., 0] = v."""

    out = x.clone()
    out[..., 0] = v
    return out


def pack_real_input_split(x: torch.Tensor) -> SplitPair:
    """[..., N] real -> contiguous planar [..., N/2] x2, z[m] = x[2m] + i x[2m+1].

    One copy: the even and odd samples de-interleaved into two planes."""

    lead = x.shape[:-1]
    t = x.reshape(*lead, x.shape[-1] // 2, 2).movedim(-1, 0).contiguous()
    return t[0], t[1]


def real_forward_split_planar(zr, zi, real_twiddle) -> SplitPair:
    """REAL_FINALIZE on [..., H] planes, the even/odd form (pffft bin0
    packing: DC + i*Nyquist)."""

    return _forward_split(zr, zi, real_twiddle, -1)


def real_backward_split_planar(sr, si, real_twiddle) -> SplitPair:
    """REAL_PREPROCESS on [..., H] planes, the even/odd form; returns 2*Z."""

    return _backward_split(sr, si, real_twiddle, -1)


def real_forward_split_planar_flat(zr, zi, real_twiddle) -> SplitPair:
    """REAL_FINALIZE on [..., H] planes in the flat form (csrc/real.cuh)."""

    return _forward_split_flat(zr, zi, real_twiddle, -1)


def real_backward_split_planar_flat(sr, si, real_twiddle) -> SplitPair:
    """REAL_PREPROCESS on [..., H] planes in the flat form; returns 2*Z."""

    return _backward_split_flat(sr, si, real_twiddle, -1)


def interleave_to_real_split(wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """Planar [..., H] x2 -> [..., N] real: x[2m] = re, x[2m+1] = im (one copy)."""

    lead = wr.shape[:-1]
    return torch.stack([wr, wi], dim=-1).reshape(*lead, 2 * wr.shape[-1])
