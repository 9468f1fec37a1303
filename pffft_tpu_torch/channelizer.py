"""Polyphase filter-bank channelizers on the card.

Counterpart of ``pffft_tpu/channelizer.py``:

  * :class:`Channelizer`, the critically sampled polyphase filter bank.
    For frame k and channel c,

        Y[k, c] = sum_j h[j] * x[k*M - j] * exp(+2i pi c j / M),

    every channel mixed to baseband, filtered by the prototype h and
    decimated by M.  It is computed as the weighted frames
    v[k, phi] = sum_s hb[s, phi] * ext[(P + k - s)*M - phi] of the
    history-prefixed stream ext (hb[s, phi] = h[s*M + phi]), then an
    unscaled backward DFT over the M phases.
  * :class:`OversampledChannelizer`, hop M/V: V interleaved critically
    sampled passes and a phase table per residue.

On the card the polyphase step is one launch of the kernel
``csrc/pfb_fir.cu`` for both planes (``ops/pfb_kernel.pfb_fir_stream_tmajor``):
it reads the history and the chunk in place, as one virtual stream, and
writes v time-major [M, B*K]; the DFT over the phases is the port's
time-major complex transform, backward and unscaled (the chain kernel for
M <= 2048, kern2 above).  ``process_split_tmajor`` returns that [M, B*K]
output as it is; ``process_split`` moves the channel axis back to
[..., K, M].

State is carried as in the reference: the last P*M input samples, planar,
in memory of its own, so a caller may refill a chunk's buffer after the
step (the kernel reads the history in place; only the new state is copied,
P*M samples a row).
numpy input goes to the channelizer's ``device`` (default "cuda"); tensors
stay where they are.  A float64 channelizer computes in float64 and
complex128 with no kernel, as the reference's float64 path does: the
polyphase step is the reference's time-major multiply-accumulate of P
shifted slices of the history-prefixed stream (``_mac_tmajor``), read from
each residue's offset, and the DFT over the phases runs on the float64
stage engine; ``process_split`` moves the channel axis back as in float32.

:class:`DDCChain` is the explicit-stage downconverter of BASELINE.json
config #4: the NCO mixer, an overlap-save lowpass (``conv.FastConv``) and
decimation, in float32 or float64.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import conv as _conv
from . import fft as _fft
from . import plan as _plan
from .dsp import mixer as _mixer
from .ops import _grad
from .ops import pfb_kernel as _pfb
from .utils import profiling as _profiling

__all__ = ["Channelizer", "OversampledChannelizer", "ChannelizerState", "design_lowpass",
           "state_from_arrays", "DDCChain", "DDCState", "ddc_state_from_arrays"]


def design_lowpass(num_taps: int, cutoff: float, window: str = "hamming") -> np.ndarray:
    """Windowed-sinc FIR lowpass prototype (cutoff in cycles/sample),
    float64 numpy, normalised to unit DC gain."""

    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * n)
    if window == "hamming":
        w = np.hamming(num_taps)
    elif window == "blackman":
        w = np.blackman(num_taps)
    elif window == "rect":
        w = np.ones(num_taps)
    else:
        raise ValueError(f"unknown window {window!r}")
    h *= w
    return (h / h.sum()).astype(np.float64)


def _planes(x, device, plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """A complex stream (numpy or tensor) as planes of the plan's dtype."""

    if isinstance(x, torch.Tensor):
        x = x.to(_fft._complex_dtype(plan))
        return x.real, x.imag
    x = np.asarray(x)
    return _fft._as_plane(np.real(x), device, plan), _fft._as_plane(np.imag(x), device, plan)


def _chunk_plane(x, device, plan) -> torch.Tensor:
    """A chunk plane in the plan's dtype with unit inner stride: a tensor
    that is a slice of wider rows stays a view (the kernel reads it in
    place); numpy arrays go to ``device``."""

    if not isinstance(x, torch.Tensor):
        return _fft._as_plane(x, device, plan)
    x = x.to(_fft._real_dtype(plan))
    return x if x.ndim and x.stride(-1) == 1 else _profiling.contiguous(x, "chunk_plane")


class ChannelizerState(NamedTuple):
    """Streaming history: the last P*M input samples, planar, in the
    channelizer's dtype."""

    hist_re: torch.Tensor  # [..., P*M]
    hist_im: torch.Tensor


def state_from_arrays(hist_re, hist_im, device="cuda") -> ChannelizerState:
    """The port's state from arrays, e.g. a reference ``ChannelizerState``
    as numpy: the stream carries on from there.  float64 arrays stay
    float64, others become float32; a channelizer casts the state to its
    own dtype."""

    def plane(h):
        dt = h.dtype if isinstance(h, torch.Tensor) else np.asarray(h).dtype
        return _fft._to_device(h, device, torch.float64 if dt in (np.float64, torch.float64)
                               else torch.float32)

    return ChannelizerState(plane(hist_re), plane(hist_im))


class Channelizer:
    """Critically sampled polyphase filter-bank channelizer.

    num_channels M: the DFT length across the phases (any 2/3/5-smooth
    size).  taps_per_channel P: polyphase depth; prototype length P*M.
    """

    def __init__(
        self,
        num_channels: int,
        taps_per_channel: int = 8,
        prototype: Optional[np.ndarray] = None,
        dtype="float32",
        device="cuda",
    ):
        m, p = int(num_channels), int(taps_per_channel)
        self.dtype = np.dtype(dtype)
        if prototype is None:
            prototype = design_lowpass(p * m, 0.5 / m)
        prototype = np.asarray(prototype, dtype=np.float64)
        if prototype.size != p * m:
            raise ValueError(f"prototype length {prototype.size} != P*M = {p * m}")
        self.m = m
        self.p = p
        self.device = device
        # polyphase branches: hb[s, phi] = h[s*M + phi]
        self.weights = prototype.reshape(p, m).astype(self.dtype)
        self._w: Dict[torch.device, torch.Tensor] = {}
        self.plan = _plan.Plan.create(m, _plan.COMPLEX, dtype, strict=False)

    @classmethod
    def from_weights(cls, weights, dtype="float32", device="cuda") -> "Channelizer":
        """A channelizer with polyphase weights [P, M] (hb[s, phi] =
        h[s*M + phi]), e.g. a reference channelizer's ``weights``."""

        w = np.asarray(weights)
        if w.ndim != 2:
            raise ValueError(f"weights must be [P, M]; got {w.shape}")
        p, m = w.shape
        return cls(m, p, prototype=w.reshape(-1), dtype=dtype, device=device)

    def _weights(self, device: torch.device) -> torch.Tensor:
        w = self._w.get(device)
        if w is None:
            w = self._w[device] = torch.from_numpy(self.weights).to(device)
        return w

    def init_state(self, channels_shape: Tuple[int, ...] = (), device=None) -> ChannelizerState:
        z = torch.zeros((*channels_shape, self.p * self.m), dtype=_fft._real_dtype(self.plan),
                        device=self.device if device is None else device)
        return ChannelizerState(hist_re=z, hist_im=z)

    # ------------------------------------------------------------------
    def _mac_tmajor(self, ext: torch.Tensor, k: int, offset: int = 0) -> torch.Tensor:
        """The float64 polyphase step, the reference's ``_polyphase_tmajor``:
        ext [..., P*M + L] (history-prefixed) read from ``offset`` < M -> v
        [M, R*K] with columns frame-fastest, v[phi, (r, k)] = sum_s hb[s,
        phi] ext[r, (P + k - s)*M - phi + offset].

        With e = ext[offset:], the phase rows tf[phi, r, q] = e[r, (q+1)*M -
        phi] are frame q+1's first sample for phi = 0 and frame q's sample
        M - phi above; v is sum_s hb[s] * tf[..., P-1-s : P-1-s+K].  Nothing
        past e[:, (P+K-1)*M] is read, so the residues need no zero padding."""

        m, p = self.m, self.p
        w = self._weights(ext.device)
        e = ext.reshape(-1, ext.shape[-1])[:, offset:]
        q = p + k - 1
        body = e[:, :q * m].reshape(-1, q, m).permute(2, 0, 1)  # body[j, r, q] = e[r, q*M + j]
        row0 = e[:, m:q * m + 1:m]  # e[r, (q+1)*M]
        tf = torch.cat([row0[None], body[1:].flip(0)], dim=0)
        acc = tf[..., p - 1:p - 1 + k] * w[0][:, None, None]
        for s in range(1, p):
            acc = acc + tf[..., p - 1 - s:p - 1 - s + k] * w[s][:, None, None]
        return acc.reshape(m, -1)

    def _pfb_split_tmajor(self, state: ChannelizerState, x, k: int, offsets=(0,)) -> list:
        """The history and the chunk planes x = (x_re, x_im) [..., K*M],
        read from each of ``offsets`` -> for each, the channels ([M, B*K])
        x2, channel-major, columns frame-fastest.  Float64 joins history and
        chunk once for all offsets; float32 reads both in place."""

        if self.dtype == np.float64:
            ext = [torch.cat([h, c], dim=-1) for h, c in zip(state, x)]
            vs = [tuple(self._mac_tmajor(e, k, off) for e in ext) for off in offsets]
        else:
            w = self._weights(x[0].device)
            vs = [_pfb.pfb_fir_stream_tmajor(state, x, w, k, off) for off in offsets]
        return [_fft.transform_ordered_split_tmajor(self.plan, v, _plan.BACKWARD) for v in vs]

    def _pfb_split(self, state: ChannelizerState, x, k: int, offsets=(0,)) -> list:
        """As :meth:`_pfb_split_tmajor` -> for each offset ([..., K, M]) x2."""

        lead = x[0].shape[:-1]
        return [tuple(_profiling.contiguous(y.reshape(self.m, *lead, k).movedim(0, -1), "movedim")
                      for y in ys)
                for ys in self._pfb_split_tmajor(state, x, k, offsets)]

    def _advance(self, state: ChannelizerState, x_re, x_im):
        """(state, (x_re, x_im), K, state'): the state in the channelizer's
        dtype, the chunk as planes on the device and the new state, the last
        P*M samples of [history, chunk], copied out of the chunk (one copy
        for both planes when it holds K >= P frames, else a concatenation of
        at most P*M samples), so the caller may reuse the chunk's buffer."""

        state = ChannelizerState(*(h.to(_fft._real_dtype(self.plan)) for h in state))
        x_re = _chunk_plane(x_re, self.device, self.plan)
        x_im = _chunk_plane(x_im, self.device, self.plan)
        if x_re.shape[-1] % self.m:
            raise ValueError(
                f"stream chunk length {x_re.shape[-1]} must be a multiple of M={self.m}")
        hist, length = self.p * self.m, x_re.shape[-1]
        if length >= hist:
            st = ChannelizerState(*_profiling.copy(
                "state", torch.stack, (x_re[..., length - hist:], x_im[..., length - hist:])
            ).unbind(0))
        else:
            st = ChannelizerState(*(
                _profiling.copy("state", torch.cat, [h[..., length:], x], dim=-1)
                for h, x in zip(state, (x_re, x_im))))
        return state, (x_re, x_im), length // self.m, st

    @_profiling.entry("Channelizer.process_split_tmajor")
    def process_split_tmajor(
        self, state: ChannelizerState, x_re, x_im
    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ChannelizerState]:
        """Channel-major stream step for time-major pipelines: planes
        [..., L] x2 -> (([M, B*K]) x2, state'), with no transpose back
        (columns run frame-fastest, batch-major over any leading dims)."""

        state, x, k, st = self._advance(state, x_re, x_im)
        return self._pfb_split_tmajor(state, x, k)[0], st

    @_profiling.entry("Channelizer.process_split")
    def process_split(
        self, state: ChannelizerState, x_re, x_im
    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ChannelizerState]:
        """Split-format stream step: planes [..., L] x2 ->
        (([..., L//M, M]) x2, state')."""

        state, x, k, st = self._advance(state, x_re, x_im)
        return self._pfb_split(state, x, k)[0], st

    def process(self, state: ChannelizerState, x) -> Tuple[torch.Tensor, ChannelizerState]:
        """Stream step: x [..., L] complex (L % M == 0) ->
        (Y [..., L//M, M] complex64, or complex128 in float64, state').
        Y[..., k, c] is channel c of output frame k at rate fs/M."""

        (yr, yi), st = self.process_split(state, *_planes(x, self.device, self.plan))
        return torch.complex(yr, yi), st

    @property
    def jitted_process(self):
        """The reference's ``jax.jit(self.process)``: ``process`` itself
        (there is no trace to compile)."""

        return self.process

    def one_shot(self, x) -> torch.Tensor:
        """Zero history, process, drop state."""

        dev = x.device if isinstance(x, torch.Tensor) else None
        y, _ = self.process(self.init_state(tuple(x.shape[:-1]), dev), x)
        return y

    def __repr__(self) -> str:  # pragma: no cover
        return f"Channelizer(M={self.m}, P={self.p}, {self.dtype.name})"


class OversampledChannelizer:
    """Oversampled PFB channelizer: per-channel output rate V*fs/M.

    Hop H = M/V (V | M).  For frame k and channel c,

        Y[k, c] = sum_j h[j] * x[k*H - j] * exp(+2i pi c (j - k*H) / M),

    the c-th DDC sampled at n = k*H: V interleaved critically sampled
    passes (residue r = k mod V uses frames offset by r*H), each the
    polyphase step of :class:`Channelizer`, times the phase table
    e^{-2i pi c r H / M} of its residue.
    """

    def __init__(self, num_channels: int, oversample: int = 2,
                 taps_per_channel: int = 8, prototype: Optional[np.ndarray] = None,
                 dtype="float32", device="cuda"):
        if num_channels % oversample:
            raise ValueError("oversample must divide num_channels")
        self.base = Channelizer(num_channels, taps_per_channel, prototype, dtype, device)
        self.v = int(oversample)
        self.hop = num_channels // self.v
        m = num_channels
        # phase[r, c] = exp(-2i pi c r H / M)
        r = np.arange(self.v)[:, None]
        c = np.arange(m)[None, :]
        ang = -2.0 * np.pi * (r * self.hop % m) * c / m
        self.ph_re = np.cos(ang).astype(self.base.dtype)
        self.ph_im = np.sin(ang).astype(self.base.dtype)

    @property
    def m(self) -> int:
        return self.base.m

    def init_state(self, channels_shape: Tuple[int, ...] = (), device=None) -> ChannelizerState:
        return self.base.init_state(channels_shape, device)

    @_profiling.entry("OversampledChannelizer.process_split")
    def process_split(self, state: ChannelizerState, x_re, x_im):
        """Planes [..., L] (L % M == 0) -> ([..., V*L//M, M]) x2, state'.
        Output frame k is stream time k*H (H = M/V)."""

        b = self.base
        state, x, k, st = b._advance(state, x_re, x_im)
        lead = x[0].shape[:-1]
        dev = x[0].device
        ph_re = torch.from_numpy(self.ph_re).to(dev)
        ph_im = torch.from_numpy(self.ph_im).to(dev)
        # residue r samples times k*M + r*H: the stream read from offset r*H
        offsets = [r * self.hop for r in range(self.v)]
        ys = [(vr * ph_re[r] - vi * ph_im[r], vr * ph_im[r] + vi * ph_re[r])
              for r, (vr, vi) in enumerate(b._pfb_split(state, x, k, offsets))]
        # interleave residues: output frame k*V + r = residue r's frame k
        return tuple(_profiling.copy("interleave", torch.stack, y, dim=-2).reshape(
            *lead, k * self.v, b.m) for y in zip(*ys)), st

    def process(self, state: ChannelizerState, x):
        (yr, yi), st = self.process_split(state, *_planes(x, self.base.device, self.base.plan))
        return torch.complex(yr, yi), st


class DDCState(NamedTuple):
    mixer: _mixer.MixerState
    tail: torch.Tensor  # [filterLen-1] complex64: the carried mixed samples


def ddc_state_from_arrays(phase_fp, rate_fp, tail, device="cuda") -> DDCState:
    """The port's state from a reference ``DDCState`` as numpy (its mixer's
    phase_fp and rate_fp, and its tail): the stream carries on from there."""

    return DDCState(_mixer.state_from_arrays(phase_fp, rate_fp, device),
                    _mixer._to_device(tail, device, torch.complex64))


class DDCChain:
    """Mixer -> FIR lowpass (overlap-save) -> decimate, streaming.

    Each call mixes the chunk with the NCO carrier, convolves it with the
    lowpass and keeps every ``decim``-th sample.  The carried state is what
    the reference APIs carry: the NCO phase and the last filterLen-1 mixed
    samples.  The lowpass convolves I and Q as the two real rows of one
    ``FastConv._conv_stream`` call (one launch of the conv kernel's stream
    map where nfft <= 16384); with dtype="float64" the conv runs in float64
    on the "tmajor" route (the mixer stays the float32 NCO, as in the
    reference).
    """

    def __init__(self, shift_rate: float, filter_taps, decim: int, dtype="float32",
                 device="cuda"):
        self.decim = int(decim)
        h = np.asarray(filter_taps, dtype=np.float64)
        self.filter_len = h.size
        self.device = device
        self.conv = _conv.FastConv(h, flags=_conv.ConvFlags.CPLX_INP_OUT, dtype=dtype,
                                   device=device)
        self.shift_rate = float(shift_rate)

    def init_state(self, device=None) -> DDCState:
        return DDCState(
            mixer=_mixer.mixer_init(self.shift_rate),
            tail=torch.zeros(self.filter_len - 1, dtype=torch.complex64,
                             device=self.device if device is None else device),
        )

    @_profiling.entry("DDCChain.process")
    def process(self, state: DDCState, x) -> Tuple[torch.Tensor, DDCState]:
        """x [L] complex chunk -> (y [L/decim] complex, state').

        L must be a multiple of ``decim`` so that the decimation phase is
        the same in every chunk (streaming == one-shot).  Under
        ``torch.func.vmap`` over streams, the state may be one per stream
        (``ddc_state_from_arrays`` of arrays) or shared; the new mixer
        state comes back as int64 tensors."""

        x = _mixer._to_device(x, self.device, torch.complex64)
        n = x.shape[0]
        if n % self.decim != 0:
            raise ValueError(
                f"chunk length {n} must be a multiple of decim="
                f"{self.decim} (keeps the decimation phase chunk-invariant)"
            )
        (mr, mi), mst = _mixer.mixer_apply_split(state.mixer, x.real, x.imag)
        if _grad._transforms_active():
            mst = _mixer.as_tensors(mst, x.device)
        # [I; Q] rows of the stream [tail, mixed chunk], in one pass
        f1 = self.filter_len - 1
        tail = torch.view_as_real(state.tail)
        ext = _profiling.copy("ext", torch.cat, [tail[:, 0], mr, tail[:, 1], mi]).view(2, f1 + n)
        y = self.conv._conv_stream(ext.to(_fft._real_dtype(self.conv.plan)), n)
        tail = ext[:, n:]
        return (torch.complex(y[0, :: self.decim], y[1, :: self.decim]),
                DDCState(mixer=mst, tail=torch.complex(tail[0], tail[1])))

    @property
    def jitted_process(self):
        """The reference's ``jax.jit(self.process)``: ``process`` itself
        (there is no trace to compile)."""

        return self.process
