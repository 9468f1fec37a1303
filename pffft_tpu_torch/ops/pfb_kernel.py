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
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build
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
    if rows.device.type == "cpu":
        return pfb_fir_plain(rows, weights, k)
    _pk._check_cuda(rows, weights)
    lead = rows.shape[:-2]
    r = math.prod(lead)
    out = torch.empty((*lead, k, m), dtype=rows.dtype, device=rows.device)
    if r == 0:
        return out
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
    if xr.device.type == "cpu":
        return pfb_fir_stream_tmajor_plain(hist, x, weights, k, offset)
    _pk._check_cuda(weights)
    r = math.prod(lead)
    vr = torch.empty((m, r * k), dtype=torch.float32, device=xr.device)
    vi = torch.empty_like(vr)
    if r == 0:
        return vr, vi
    hr2, hi2, xr2, xi2 = (_rows_2d(t, "stream planes") for t in (hr, hi, xr, xi))
    if hr2.stride(0) != hi2.stride(0) or xr2.stride(0) != xi2.stride(0):
        hr2, hi2, xr2, xi2 = (t.contiguous() for t in (hr2, hi2, xr2, xi2))
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
