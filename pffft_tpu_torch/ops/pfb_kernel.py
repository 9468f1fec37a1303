"""The sliding-window polyphase FIR, the channelizer's hot loop.

Counterpart of ``pffft_tpu/ops/pfb_kernel.py``.  The Pallas kernel becomes
``csrc/pfb_fir.cu`` (B8):

    out[..., k, phi] = sum_{s<P} weights[s, phi] * rows[..., k + s, phi]

One thread per (row set, column, chunk of outputs) keeps the last P inputs
in registers, so each input is read once, as the TPU kernel's VMEM strip
does.  The kernel takes two map pairs:

  * :func:`pfb_fir`, the identity maps: rows [..., Q, M] -> [..., K, M];
  * :func:`pfb_fir_stream_tmajor`, the channelizer's maps: the
    history-prefixed stream ext [..., L] read directly, the weighted frames
    written time-major [M, R*K] for the FFT over the phases:

        v[phi, r*K + k] = sum_s weights[s, phi] * ext[r, (P + k - s)*M - phi].

The TPU's lane-block and VMEM gate (``supported``) has no counterpart:
the kernel serves any M and P >= 1 in f32.  Each wrapper takes its plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.  Each counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import math

import torch

from . import _build
from . import pallas_fft as _pk

__all__ = ["pfb_fir", "pfb_fir_plain", "pfb_fir_stream_tmajor",
           "pfb_fir_stream_tmajor_plain"]


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


def pfb_fir_stream_tmajor_plain(ext: torch.Tensor, weights: torch.Tensor,
                                k: int) -> torch.Tensor:
    """Plain PyTorch version of the channelizer's maps: the stream reshaped
    into phase rows (the reference's ``_polyphase_tmajor``), then the P-term
    multiply-accumulate; returns v [M, R*K]."""

    p, m = weights.shape
    e = ext.reshape(-1, ext.shape[-1])
    tf = _stream_rows_tmajor(e, p, k, m)
    acc = tf[..., p - 1:p - 1 + k] * weights[0][:, None, None]
    for s in range(1, p):
        acc = acc + tf[..., p - 1 - s:p - 1 - s + k] * weights[s][:, None, None]
    return acc.reshape(m, e.shape[0] * k)


def _launch(x: torch.Tensor, weights: torch.Tensor, y: torch.Tensor, k: int, rows: int,
            q: int, mapping: int, what: str) -> None:
    p, m = weights.shape
    lib, fn = _pk._kernel("pf_pfb_fir")
    err = fn(x.data_ptr(), weights.data_ptr(), y.data_ptr(), p, k, m, rows, q, mapping,
             x.device.index or 0, _pk._stream(x))
    _build.check(lib, err, f"{what} (P={p}, K={k}, M={m}, rows={rows})")


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
    _launch(rows, weights, out, k, r, q, 0, "polyphase FIR kernel")
    pfb_fir.launches += 1
    return out


pfb_fir.launches = 0


def pfb_fir_stream_tmajor(ext: torch.Tensor, weights: torch.Tensor, k: int) -> torch.Tensor:
    """The channelizer's polyphase step on the history-prefixed stream:
    ext [..., L] (L >= (P + K - 1)*M + 1, normally (P + K)*M), weights
    [P, M] -> v [M, R*K] time-major, R the product of the leading dims,
    columns frame-fastest:

        v[phi, r*K + k_] = sum_s weights[s, phi] * ext[r, (P + k_ - s)*M - phi]."""

    if ext.ndim < 1:
        raise ValueError("ext must be [..., L]")
    _check_weights(weights, k, ext.device)
    p, m = weights.shape
    length = ext.shape[-1]
    if length < (p + k - 1) * m + 1:
        raise ValueError(f"stream length {length} < (P + K - 1)*M + 1 = {(p + k - 1) * m + 1}")
    if ext.device.type == "cpu":
        return pfb_fir_stream_tmajor_plain(ext, weights, k)
    _pk._check_cuda(ext, weights)
    r = math.prod(ext.shape[:-1])
    out = torch.empty((m, r * k), dtype=ext.dtype, device=ext.device)
    if r == 0:
        return out
    _launch(ext, weights, out, k, r, length, 1, "polyphase FIR kernel (stream map)")
    pfb_fir_stream_tmajor.launches += 1
    return out


pfb_fir_stream_tmajor.launches = 0
