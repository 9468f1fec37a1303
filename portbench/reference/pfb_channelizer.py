"""Plain reference of ``pfb_channelizer``: the critically sampled polyphase channelizer.

For M channels and P taps a channel, prototype h of P*M taps held as the
polyphase weights w[s, phi] = h[s*M + phi], output frame g and channel c of
a complex stream x are

    Y[g, c] = sum_{s < P} sum_{phi < M} w[s, phi] x[(g - s)*M - phi] exp(+2i pi c phi / M),

with x zero before the stream's first sample: every channel mixed to
baseband, filtered by h and decimated by M.  A chunk of K frames a stream
holds frames g = c*K .. c*K + K - 1, and the carried history is the P*M
samples before the chunk.  The stream is periodic: sample i of a row is
``base[:, i % S]``.  All of it is worked out here again from the stream and
the weights, in float64 and complex128.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import tf32


def _sample_index(first_frame: int, frames: int, s: int, m: int, device) -> torch.Tensor:
    """[frames, M] stream indices (g - s)*M - phi of frames first_frame .. ."""

    g = torch.arange(first_frame, first_frame + frames, device=device, dtype=torch.int64)
    phi = torch.arange(m, device=device, dtype=torch.int64)
    return (g[:, None] - s) * m - phi[None, :]


def expected(base_re: torch.Tensor, base_im: torch.Tensor, weights: np.ndarray, frames: int,
             chunk: int) -> torch.Tensor:
    """Channels of chunk ``chunk`` (K = ``frames`` frames a stream): complex128
    [R, K, M]."""

    p, m = weights.shape
    period = base_re.shape[-1]
    w = torch.from_numpy(np.asarray(weights, np.float64)).to(base_re.device)
    v = torch.zeros((base_re.shape[0], frames, m), dtype=torch.complex128,
                    device=base_re.device)
    for s in range(p):
        idx = _sample_index(chunk * frames, frames, s, m, base_re.device)
        live = (idx >= 0).to(torch.float64)
        at = idx.remainder(period)
        x = torch.complex(base_re[:, at].double(), base_im[:, at].double())
        v += x * (w[s] * live)
    return torch.fft.ifft(v, dim=-1) * m


def control(state: Tuple[torch.Tensor, torch.Tensor], x_re: torch.Tensor, x_im: torch.Tensor,
            weights: np.ndarray):
    """The control: one step computed by this reference in TF32 -- the
    history, the chunk, the weights and the polyphase sums rounded to TF32
    where they enter a product -- in the program's format: ((y_re, y_im)
    float32 [R, K, M], (hist_re, hist_im) the last P*M samples)."""

    p, m = weights.shape
    k = x_re.shape[-1] // m
    ext = [torch.cat([h.to(torch.float32), x.to(torch.float32)], dim=-1)
           for h, x in zip(state, (x_re, x_im))]
    w = tf32(torch.from_numpy(np.asarray(weights, np.float32)).to(x_re.device)).double()
    g = torch.arange(k, device=x_re.device, dtype=torch.int64)
    phi = torch.arange(m, device=x_re.device, dtype=torch.int64)
    v = []
    for e in ext:
        e64 = tf32(e).double()
        acc = torch.zeros((e.shape[0], k, m), dtype=torch.float64, device=e.device)
        for s in range(p):
            acc += e64[:, (p + g[:, None] - s) * m - phi[None, :]] * w[s]
        v.append(tf32(acc.float()).double())
    y = torch.fft.ifft(torch.complex(*v), dim=-1) * m
    return ((y.real.float(), y.imag.float()),
            tuple(e[..., e.shape[-1] - p * m:].clone() for e in ext))
