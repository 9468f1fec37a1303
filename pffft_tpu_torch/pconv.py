"""Uniform partitioned convolution (frequency-domain delay line).

Counterpart of ``pffft_tpu/pconv.py``.  With block size B and Nfft = 2B,
an L-tap filter becomes P = ceil(L/B) partition spectra computed once;
each B-sample input block costs one forward transform into a P-deep
spectrum delay line (FDL), and the output block is the inverse transform
of sum_p FDL[p] * H[p].  Latency stays one block whatever L.

All K blocks of a call are transformed in one batched half-length REAL
transform (batch-major: the pack copy, B9 at H = B, then B6, and back the
same way).  The P-term accumulation over the block axis is, for every bin,
a correlation of the spectra's block sequence with the reversed partition
spectra: one depthwise ``conv1d`` over the block axis (each re/im channel
against the re and im partition spectra of its bin) at full fp32 (no TF32,
``ops/split._full_fp32``), for any P.  The reference contracts a stacked
window for P <= 16 and loops over partitions above; the sum is the same.
Packed bin0 (DC + i*Nyquist) accumulates componentwise.

Streaming convention: output n is sum_t h[t] x[n-t] with zero history
(np.convolve(x, h)[:len(x)] over the concatenated stream).  numpy input
and states go to the setup's ``device`` (default "cuda"); tensors stay on
their device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fft as _fft
from . import plan as _plan
from .ops import split as _split

__all__ = ["PartitionedConv", "PconvState", "state_from_arrays"]


class PconvState(NamedTuple):
    """The FDL state: past spectra planes [*lead, P-1, H] and the input
    tail [*lead, B]."""

    sr: torch.Tensor
    si: torch.Tensor
    tail: torch.Tensor


def state_from_arrays(sr, si, tail, device="cuda", dtype="float32") -> PconvState:
    """The port's state from arrays, e.g. a reference ``(sr, si, tail)`` as
    numpy: the stream carries on from there."""

    dt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    return PconvState(*(_fft._to_device(a, device, dt) for a in (sr, si, tail)))


class PartitionedConv:
    """Streaming long-FIR convolution with bounded (one-block) latency.

    >>> pc = PartitionedConv(h, block_len=512)
    >>> state = pc.init_state()
    >>> y1, state = pc.process(state, x1)   # len(x1) % 512 == 0
    >>> y2, state = pc.process(state, x2)
    # torch.cat([y1, y2]) == np.convolve(concat(x1, x2), h)[:total]

    Real input/filter only; leading axes of x are batch (channels).
    ``block_len`` must make 2*block_len a supported REAL transform size
    (block_len 2/3/5-smooth).  ``_h`` holds the partition spectra planes
    [P, H] (packed bin0) as numpy arrays of the setup's dtype.
    """

    def __init__(self, filter_coeffs, block_len: int = 512, dtype="float32",
                 device="cuda"):
        h = np.asarray(filter_coeffs, dtype=np.float64).reshape(-1)
        if h.size < 1:
            raise ValueError("empty filter")
        self.dtype = np.dtype(dtype)
        self.block = int(block_len)
        if self.block < 2:
            raise ValueError("block_len must be >= 2")
        self.nfft = 2 * self.block
        self.plan = _plan.Plan.create(self.nfft, _plan.REAL, dtype, strict=False)
        self.taps = h.size
        self.parts = -(-h.size // self.block)
        self.device = device
        # partition p = h[p*B : (p+1)*B], zero-padded to the 2B frame: the
        # last B output samples of each block are then exact
        hb = np.zeros((self.parts, self.block), dtype=np.float64)
        hb.reshape(-1)[: h.size] = h
        spec = np.fft.rfft(hb, n=self.nfft, axis=-1)  # [P, B + 1], float64
        hr = spec[:, :-1].real.copy()
        hr[:, 0] = spec[:, 0].real
        hi = spec[:, :-1].imag.copy()
        hi[:, 0] = spec[:, -1].real  # packed bin0: DC + i*Nyquist
        self._h = (hr.astype(self.dtype), hi.astype(self.dtype))
        self._w: Dict[torch.device, torch.Tensor] = {}

    @property
    def latency(self) -> int:
        """Samples of algorithmic delay: one block, independent of taps."""

        return self.block

    def init_state(self, lead: Tuple[int, ...] = (), device: Optional[str] = None) -> PconvState:
        """FDL state for a stream with leading (channel) shape ``lead`` on
        ``device`` (default the setup's): past-spectra planes
        [*lead, P-1, H] and the input tail [*lead, B]."""

        dev = torch.device(device or self.device)
        z = torch.zeros((*lead, max(self.parts - 1, 0), self.block),
                        dtype=_fft._real_dtype(self.plan), device=dev)
        return PconvState(z, torch.zeros_like(z), z.new_zeros((*lead, self.block)))

    def _weights(self, device: torch.device) -> torch.Tensor:
        """The depthwise conv1d weight [4H, 1, P] on ``device``: the reversed
        partition spectra, channel c = (plane s, bin h) at 2H*s + h, its
        two outputs 2c (against hr for re, hi for im) and 2c + 1 (hi for
        re, hr for im)."""

        w = self._w.get(device)
        if w is None:
            hr, hi = (np.ascontiguousarray(a[::-1].T) for a in self._h)  # [H, P]
            stack = np.stack([np.stack([hr, hi], 1), np.stack([hi, hr], 1)], 0)
            w = torch.from_numpy(stack.reshape(-1, 1, self.parts)).to(device)
            self._w[device] = w
        return w

    def _accumulate(self, ar: torch.Tensor, ai: torch.Tensor, k: int):
        """sum_p A[j + p] * Hrev[p] for output blocks j < k of the block
        history planes [..., P-1+K, H], with bin0 componentwise."""

        lead, (length, hb) = ar.shape[:-2], ar.shape[-2:]
        x = torch.cat([ar, ai], dim=-1).reshape(-1, length, 2 * hb).transpose(1, 2)
        with _split._full_fp32():
            o = F.conv1d(x, self._weights(ar.device), groups=2 * hb)  # [R, 4H, K]
        o = o.reshape(-1, 2, hb, 2, k)
        acc_r = o[:, 0, :, 0] - o[:, 1, :, 0]
        acc_i = o[:, 0, :, 1] + o[:, 1, :, 1]
        # packed bin0: DC (re * hr) and Nyquist (im * hi) componentwise
        acc_r[:, 0] = o[:, 0, 0, 0]
        acc_i[:, 0] = o[:, 1, 0, 0]
        return (acc_r.transpose(1, 2).reshape(*lead, k, hb),
                acc_i.transpose(1, 2).reshape(*lead, k, hb))

    def process(self, state, x):
        """Filter ``x`` [..., K*B]; returns (y [..., K*B], new_state).
        ``state`` may hold numpy arrays (e.g. the reference's state)."""

        dt = _fft._real_dtype(self.plan)
        x = _fft._to_device(x, self.device, dt)
        if x.shape[-1] == 0 or x.shape[-1] % self.block:
            raise ValueError(
                f"chunk length {x.shape[-1]} must be a non-zero multiple of "
                f"block_len {self.block} (pad the final chunk with zeros)")
        sr, si, tail = (_fft._to_device(a, x.device, dt) for a in state)
        b = self.block
        k = x.shape[-1] // b
        lead = x.shape[:-1]
        # frame j is the previous block and block j: [..., K, 2B]
        frames = torch.cat([tail, x], dim=-1).unfold(-1, 2 * b, b)
        xr, xi = _fft.transform_ordered_split(self.plan, frames, _plan.FORWARD)
        # the block-axis history [..., P-1+K, H]
        ar = torch.cat([sr, xr], dim=-2)
        ai = torch.cat([si, xi], dim=-2)
        acc_r, acc_i = self._accumulate(ar, ai, k)
        y = _fft.transform_ordered_split(self.plan, (acc_r, acc_i), _plan.BACKWARD)
        out = (y[..., b:] * (1.0 / self.nfft)).reshape(*lead, k * b)
        new = PconvState(ar[..., k:, :], ai[..., k:, :], x[..., -b:].clone())
        return out, new
