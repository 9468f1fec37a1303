"""The sliding-window polyphase FIR, the channelizer's hot loop.

Counterpart of ``pffft_tpu/ops/pfb_kernel.py``.  The Pallas kernel becomes
``csrc/pfb_fir.cu`` (B8), with two entry points:

  * :func:`pfb_fir`, the identity maps: rows [..., Q, M] -> [..., K, M],

        out[..., k, phi] = sum_{s<P} weights[s, phi] * rows[..., k + s, phi];

    one thread per (row set, column, chunk of outputs) keeps the last P
    inputs in registers, so each input is read once, as the TPU kernel's
    VMEM strip does;
  * :func:`pfb_fir_stream_tmajor`, the channelizer's stream map on both
    planes in one launch: each plane's history and chunk read in place as
    the virtual stream ext = [hist, chunk] (zero past its end), from a start
    offset o, the weighted frames written time-major [M, R*K] for the FFT
    over the phases:

        v[phi, r*K + k] = sum_s weights[s, phi] * ext[r, (P + k - s)*M - phi + o];

    a block computes a (phase, frame) tile with threads along the phases
    and stores it through shared memory with threads along the frames, so
    both its loads and its stores are coalesced.

The TPU's lane-block and VMEM gate (``supported``) has no counterpart:
the kernel serves any M and P >= 1 in f32.  Each wrapper takes its plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.  Each counts its launches in ``<wrapper>.launches``.

Both maps are differentiable with respect to the data, not the weights
(Function 4, :class:`_PfbFir` and :class:`_PfbStream`): each backward is
the identity maps' kernel on the padded gradient.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..utils import profiling as _profiling
from . import _build
from . import _grad
from . import pallas_fft as _pk

__all__ = ["pfb_fir", "pfb_fir_plain", "pfb_fir_stream_tmajor",
           "pfb_fir_stream_tmajor_plain", "pfb_ext_tmajor_plain", "STREAM_WARPS"]


def _check_weights(weights: torch.Tensor, k: int, device: torch.device) -> None:
    if weights.ndim != 2 or weights.shape[0] < 1:
        raise ValueError(f"weights must be [P, M] with P >= 1; got {tuple(weights.shape)}")
    if weights.device != device:
        raise ValueError(f"weights on {weights.device}; data on {device}")
    if k < 1:
        raise ValueError(f"K={k} must be at least 1")


def pfb_fir_plain(rows: torch.Tensor, weights: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the identity maps: the P-term
    multiply-accumulate of shifted row slices."""

    acc = rows[..., 0:k, :] * weights[0]
    for s in range(1, weights.shape[0]):
        acc = acc + rows[..., s:s + k, :] * weights[s]
    return acc


def _stream_rows_tmajor(ext: torch.Tensor, p: int, k: int, m: int) -> torch.Tensor:
    """[R, L] -> tf [M, R, P + K - 1] with tf[phi, r, q] = ext[r, (q+1)*M - phi]."""

    need = (p + k) * m
    if ext.shape[-1] < need:
        ext = torch.nn.functional.pad(ext, (0, need - ext.shape[-1]))
    t = ext[:, :need].reshape(ext.shape[0], p + k, m).permute(2, 0, 1)  # t[j, r, q] = ext[qM+j]
    row0 = t[0:1, :, 1:]  # phi = 0 reads frame q + 1
    return torch.cat([row0, t[1:, :, :-1].flip(0)], dim=0)


def pfb_ext_tmajor_plain(ext: torch.Tensor, weights: torch.Tensor, k: int) -> torch.Tensor:
    """The polyphase step on one history-prefixed plane ext [..., L] (zero
    past its end): the stream reshaped into phase rows (the reference's
    ``_polyphase_tmajor``), then the P-term multiply-accumulate; returns v
    [M, R*K]."""

    p, m = weights.shape
    e = ext.reshape(-1, ext.shape[-1])
    tf = _stream_rows_tmajor(e, p, k, m)
    acc = tf[..., p - 1:p - 1 + k] * weights[0][:, None, None]
    for s in range(1, p):
        acc = acc + tf[..., p - 1 - s:p - 1 - s + k] * weights[s][:, None, None]
    return acc.reshape(m, e.shape[0] * k)


def pfb_fir_stream_tmajor_plain(hist: Tuple[torch.Tensor, torch.Tensor],
                                x: Tuple[torch.Tensor, torch.Tensor], weights: torch.Tensor,
                                k: int, offset: int = 0):
    """Plain PyTorch version of the stream map: each plane's ext = [hist,
    chunk] built with ``torch.cat``, shifted by ``offset`` (zeros past the
    end), then :func:`pfb_ext_tmajor_plain`; returns (v_re, v_im)."""

    out = []
    for h, c in zip(hist, x, strict=True):
        ext = torch.cat([h, c], dim=-1)
        if offset:
            ext = torch.nn.functional.pad(ext[..., offset:], (0, offset))
        out.append(pfb_ext_tmajor_plain(ext, weights, k))
    return tuple(out)


def _launch(x: torch.Tensor, weights: torch.Tensor, y: torch.Tensor, k: int, rows: int,
            q: int) -> None:
    p, m = weights.shape
    lib, fn = _pk._kernel("pf_pfb_fir")
    err = fn(x.data_ptr(), weights.data_ptr(), y.data_ptr(), p, k, m, rows, q,
             x.device.index or 0, _pk._stream(x))
    _build.check(lib, err, f"polyphase FIR kernel (P={p}, K={k}, M={m}, rows={rows})")


def pfb_fir(rows: torch.Tensor, weights: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., k_, phi] = sum_s weights[s, phi] * rows[..., k_ + s, phi].

    rows [..., Q, M] (Q >= K + P - 1; extra rows are ignored), weights
    [P, M] -> [..., K, M]."""

    if rows.ndim < 2:
        raise ValueError(f"rows must be [..., Q, M]; got {tuple(rows.shape)}")
    _check_weights(weights, k, rows.device)
    p, m = weights.shape
    q = rows.shape[-2]
    if rows.shape[-1] != m:
        raise ValueError(f"rows have {rows.shape[-1]} columns; weights have M={m}")
    if q < k + p - 1:
        raise ValueError(f"rows axis {q} < K + P - 1 = {k + p - 1}")
    if _grad.needed(rows):
        return _PfbFir.apply(rows, weights, k)
    return _pfb_fir(rows, weights, k)


def _pfb_fir(rows: torch.Tensor, weights: torch.Tensor, k: int) -> torch.Tensor:
    if rows.device.type == "cpu":
        return pfb_fir_plain(rows, weights, k)
    _pk._check_cuda(rows, weights)
    m, q = weights.shape[1], rows.shape[-2]
    lead = rows.shape[:-2]
    r = math.prod(lead)
    out = torch.empty((*lead, k, m), dtype=rows.dtype, device=rows.device)
    if r == 0:
        return out
    with _profiling.span("launch", "pfb_fir"):
        _launch(rows, weights, out, k, r, q)
    pfb_fir.launches += 1
    return out


pfb_fir.launches = 0


# The stream map's warps a block (1..8): a block of 32 x STREAM_WARPS
# threads owns 32 phases x 32*STREAM_WARPS frames (32 a thread, fixed in the
# kernel); 4 was the fastest of chip_smoke.py's pfb_sweep on the H100
STREAM_WARPS = 4


def _rows_2d(t: torch.Tensor, what: str) -> torch.Tensor:
    """t [..., L] as [R, L] rows with unit inner stride, without a copy where
    the leading dims collapse (a slice of wider rows keeps its row stride)."""

    if t.dtype != torch.float32:
        raise ValueError(f"{what} must be float32; got {t.dtype}")
    if t.ndim == 1:
        t = t.unsqueeze(0)
    if t.ndim > 2:
        try:
            t = t.view(-1, t.shape[-1])
        except RuntimeError:
            t = t.reshape(-1, t.shape[-1]).contiguous()
    if t.shape[-1] > 1 and t.stride(-1) != 1 or t.shape[0] > 1 and t.stride(0) < t.shape[-1]:
        t = t.contiguous()
    return t


def pfb_fir_stream_tmajor(hist: Tuple[torch.Tensor, torch.Tensor],
                          x: Tuple[torch.Tensor, torch.Tensor], weights: torch.Tensor,
                          k: int, offset: int = 0, warps: Optional[int] = None):
    """The channelizer's polyphase step on both planes in one launch.

    ``hist`` = (hist_re, hist_im), each [..., P*M], the streaming history;
    ``x`` = (x_re, x_im), each [..., L] with the same leading dims, the new
    chunk (rows may be slices of wider rows); weights [P, M]; ``offset`` >=
    0 the start within the stream.  With ext = [hist, chunk] read in place
    (zero past its end) and R the product of the leading dims, returns
    (v_re, v_im), each [M, R*K] time-major with columns frame-fastest:

        v[phi, r*K + k_] = sum_s weights[s, phi] * ext[r, (P + k_ - s)*M - phi + offset].

    ``warps`` overrides the block's warps :data:`STREAM_WARPS`
    (measurement only)."""

    (hr, hi), (xr, xi) = hist, x
    _check_weights(weights, k, xr.device)
    p, m = weights.shape
    lead = xr.shape[:-1]
    for t in (hr, hi, xi):
        if t.shape[:-1] != lead or t.device != xr.device:
            raise ValueError(f"history and chunk planes must share leading dims {tuple(lead)} "
                             f"and device {xr.device}; got {tuple(t.shape)} on {t.device}")
    if hr.shape[-1] != p * m or hi.shape[-1] != p * m:
        raise ValueError(f"history length {hr.shape[-1]} != P*M = {p * m}")
    length = xr.shape[-1]
    if xi.shape[-1] != length:
        raise ValueError(f"chunk planes differ in length: {length}, {xi.shape[-1]}")
    if length < (k - 1) * m + 1:
        raise ValueError(f"stream length P*M + {length} < (P + K - 1)*M + 1 = "
                         f"{(p + k - 1) * m + 1}")
    if offset < 0:
        raise ValueError(f"offset {offset} < 0")
    if _grad.needed(hr, hi, xr, xi):
        return _PfbStream.apply(hr, hi, xr, xi, weights, k, offset, warps)
    return _pfb_fir_stream(hist, x, weights, k, offset, warps)


def _pfb_fir_stream(hist, x, weights: torch.Tensor, k: int, offset: int,
                    warps: Optional[int]):
    (hr, hi), (xr, xi) = hist, x
    p, m = weights.shape
    lead = xr.shape[:-1]
    length = xr.shape[-1]
    if xr.device.type == "cpu":
        return pfb_fir_stream_tmajor_plain(hist, x, weights, k, offset)
    _pk._check_cuda(weights)
    r = math.prod(lead)
    vr = torch.empty((m, r * k), dtype=torch.float32, device=xr.device)
    vi = torch.empty_like(vr)
    if r == 0:
        return vr, vi
    with _profiling.span("launch", "pfb_fir_stream_tmajor"):
        hr2, hi2, xr2, xi2 = (_rows_2d(t, "stream planes") for t in (hr, hi, xr, xi))
        if hr2.stride(0) != hi2.stride(0) or xr2.stride(0) != xi2.stride(0):
            hr2, hi2, xr2, xi2 = (_profiling.contiguous(t, "stream_rows")
                                  for t in (hr2, hi2, xr2, xi2))
        warps = warps or STREAM_WARPS
        lib, fn = _pk._kernel("pf_pfb_stream")
        err = fn(hr2.data_ptr(), xr2.data_ptr(), vr.data_ptr(), hi2.data_ptr(), xi2.data_ptr(),
                 vi.data_ptr(), weights.data_ptr(), p, k, m, r, p * m,
                 hr2.stride(0) if r > 1 else p * m, length, xr2.stride(0) if r > 1 else length,
                 offset, warps, xr.device.index or 0, _pk._stream(xr))
        _build.check(lib, err, f"polyphase FIR kernel, stream map (P={p}, K={k}, M={m}, rows={r}, "
                               f"offset={offset}, warps={warps})")
    pfb_fir_stream_tmajor.launches += 1
    return vr, vi


pfb_fir_stream_tmajor.launches = 0


class _PfbFir(torch.autograd.Function):
    """Function 4, the identity maps: a valid correlation along the rows
    for each column phi.  Its adjoint is the same map on the gradient
    padded with P - 1 zero rows at each end, with the weights reversed
    along s; rows past K + P - 1 get no gradient."""

    @staticmethod
    def forward(rows, weights, k):
        return _pfb_fir(rows, weights, k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        rows, weights, ctx.k = inputs
        ctx.q = rows.shape[-2]
        ctx.save_for_backward(weights)

    @staticmethod
    def backward(ctx, g):
        (weights,) = ctx.saved_tensors
        p = weights.shape[0]
        pad = torch.nn.functional.pad(g, (0, 0, p - 1, p - 1))
        gr = pfb_fir(pad, weights.flip(0), ctx.k + p - 1)
        return torch.nn.functional.pad(gr, (0, 0, 0, ctx.q - ctx.k - p + 1)), None, None

    @staticmethod
    def vmap(info, in_dims, rows, weights, k):
        # the mapped dimension joins the leading dims: one call
        _unmapped_weights(in_dims[1])
        rows = _grad.batched(rows, in_dims[0], info.batch_size, 0)
        return pfb_fir(rows.contiguous(), weights, k), 0


def _unmapped_weights(dim) -> None:
    """A vmap rule's check that the weights are shared by every mapped call
    (no public path maps them)."""

    if dim is not None:
        raise ValueError("vmap over the polyphase weights is not supported: map the data")


class _PfbStream(torch.autograd.Function):
    """Function 4, the stream map, v[phi, r*K + k] = sum_s w[s, phi] *
    ext[r, (P + k - s)*M - phi + o] on both planes.

    The adjoint sends v's gradient (time-major [M, R*K], moved to rows [R,
    K, M] with P - 1 zero frames at each end) through the identity map,
    u[j, phi] = sum_s w[s, phi] * grad[j + s - (P - 1), phi], whose value
    belongs to ext position (j + 1)*M - phi + o, that is o + 1 + j*M +
    (M - 1 - phi): u with its phases reversed is ext's gradient from o + 1
    on.  It is then split into the history's and the chunk's."""

    @staticmethod
    def forward(hr, hi, xr, xi, weights, k, offset, warps):
        return _pfb_fir_stream((hr, hi), (xr, xi), weights, k, offset, warps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        hr, _, xr, _, weights, ctx.k, ctx.offset, _ = inputs
        ctx.hist_shape, ctx.x_shape = hr.shape, xr.shape
        ctx.save_for_backward(weights)

    @staticmethod
    def backward(ctx, gvr, gvi):
        (weights,) = ctx.saved_tensors
        p, m = weights.shape
        k, hist = ctx.k, ctx.hist_shape[-1]
        total = hist + ctx.x_shape[-1]
        g = torch.stack((gvr, gvi)).view(2, m, -1, k).permute(0, 2, 3, 1)  # [2, R, K, M]
        u = pfb_fir(torch.nn.functional.pad(g, (0, 0, p - 1, p - 1)), weights, k + p - 1)
        seg = u.flip(-1).reshape(2, u.shape[1], -1)
        start = ctx.offset + 1
        ext = torch.nn.functional.pad(seg, (start, total - start - seg.shape[-1]))
        gh = ext[..., :hist].reshape(2, *ctx.hist_shape)
        gx = ext[..., hist:].reshape(2, *ctx.x_shape)
        return gh[0], gh[1], gx[0], gx[1], None, None, None, None

    @staticmethod
    def vmap(info, in_dims, hr, hi, xr, xi, weights, k, offset, warps):
        # the mapped dimension joins the rows as the leading one: columns
        # (v, r, k) frame-fastest, so v [M, V*R*K] is [M, V, R*K]; an unmapped
        # history is broadcast to every mapped chunk
        _unmapped_weights(in_dims[4])
        hr, hi, xr, xi = (_grad.batched(t, d, info.batch_size, 0)
                          for t, d in zip((hr, hi, xr, xi), in_dims))
        vr, vi = pfb_fir_stream_tmajor((hr, hi), (xr, xi), weights, k, offset, warps)
        m, v = vr.shape[0], info.batch_size
        return (vr.view(m, v, -1), vi.view(m, v, -1)), (1, 1)
