"""Polyphase rational resampling (L/M) as one banded product.

Counterpart of ``pffft_tpu/resample.py``.  With the prototype h (designed
at the upsampled rate), output n is

    y[n] = sum_k h[phi_n + k*L] * x[b_n - k],
    phi_n = (n*M) mod L,  b_n = floor(n*M / L).

G*L consecutive outputs (a super-block, G = 128) share one frame of the
input: frames at stride S = G*M of width W = S + P + M (``Tensor.unfold``),
and every output of a super-block is one column of the banded bank
A [W, G*L], A[(o*M)//L + k, o] = taps_rev[k, (o*M) mod L].  So the
resampler is one ``torch.matmul`` of the frames with the bank, in full
fp32 (no TF32; the port leaves ``torch.get_float32_matmul_precision()``
at "highest").

numpy input goes to ``device`` (default "cuda"); tensors stay where they
are.  The bank is cached per device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .channelizer import design_lowpass
from .spectral import _signal, frame_signal

__all__ = ["Resampler", "resample"]


class Resampler:
    """Rational L/M resampler with a windowed-sinc prototype.

    taps_per_phase P sets the quality; the prototype has P*L taps at the
    upsampled rate with cutoff min(1/L, 1/M)/2 (anti-image and
    anti-alias)."""

    def __init__(self, up: int, down: int, taps_per_phase: int = 16,
                 prototype: Optional[np.ndarray] = None, device="cuda"):
        g = math.gcd(up, down)
        self.up = up // g
        self.down = down // g
        self.device = device
        l, m = self.up, self.down
        if prototype is None:
            cutoff = 0.5 / max(l, m)
            prototype = design_lowpass(taps_per_phase * l, cutoff) * l
        prototype = np.asarray(prototype, dtype=np.float64)
        if prototype.size % l:
            prototype = np.pad(prototype, (0, l - prototype.size % l))
        self.p = prototype.size // l
        # phase taps, reversed for the frame product: frame f ends at b_n,
        # so y = sum_k h[phi + kL] * f[P-1-k]
        taps = prototype.reshape(self.p, l)  # taps[k, phi] = h[kL + phi]
        self.taps_rev = taps[::-1].astype(np.float32)  # [P, L]
        # the super-block product: G outputs per phase, frame stride S = G*M
        self.g_blk = 128
        self.s_stride = self.g_blk * m
        self.w_frame = self.s_stride + self.p + m
        a = np.zeros((self.w_frame, self.g_blk * l), np.float32)
        for o in range(self.g_blk * l):
            d, phi = (o * m) // l, (o * m) % l
            a[d : d + self.p, o] = self.taps_rev[:, phi]
        self._bank = a  # [W, G*L]
        self._banks: Dict[torch.device, torch.Tensor] = {}

    def _bank_on(self, device: torch.device) -> torch.Tensor:
        b = self._banks.get(device)
        if b is None:
            b = self._banks[device] = torch.from_numpy(self._bank).to(device)
        return b

    def __call__(self, x) -> torch.Tensor:
        """[..., T] -> [..., floor(T * L / M)] resampled signal."""

        x = _signal(x, self.device)
        l, m, p = self.up, self.down, self.p
        t_in = x.shape[-1]
        n_out = (t_in * l) // m
        jn = -(-n_out // (self.g_blk * l))  # super-blocks
        # frame j covers padded indices [j*S, j*S + W): left-pad P-1 for
        # the causal warm-up, right-pad to the last frame's end
        left = p - 1
        need = (jn - 1) * self.s_stride + self.w_frame + left
        xp = torch.nn.functional.pad(x, (left, max(0, need - t_in - left)))
        fr = frame_signal(xp, self.w_frame, self.s_stride)[..., :jn, :]
        y = torch.matmul(fr, self._bank_on(x.device))  # [..., Jn, G*L], full fp32
        y = y.reshape(*x.shape[:-1], jn * self.g_blk * l)
        return y[..., :n_out]


def resample(x, up: int, down: int, taps_per_phase: int = 16, *,
             device: Optional[str] = None) -> torch.Tensor:
    """One-shot rational resampling: [..., T] -> [..., floor(T*up/down)]."""

    dev = x.device if isinstance(x, torch.Tensor) else (device or "cuda")
    return Resampler(up, down, taps_per_phase, device=dev)(x)
