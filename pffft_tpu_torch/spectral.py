"""Spectral analysis on the port's transforms: STFT, spectrogram, PSD.

Counterpart of ``pffft_tpu/spectral.py``, with its conventions: an
unnormalized forward STFT (the transforms are unscaled), spectra in the
packed real layout (bin0 = DC + i*Nyquist), and an ``istft`` that
reconstructs by overlap-add with the least-squares window normalization,
exact for COLA window/hop pairs.

Frames are ``Tensor.unfold`` views of the signal; the window multiply
writes them out once.  ``stft_split`` has two routes: the time-major
composition (frames [n_fft, B*K] through the real time-major transform,
``transform_ordered_split_tmajor``; for n_fft <= 4096 one launch of the
fused real kernel) and the batch-major one (frames [..., K, n_fft]
through ``transform_ordered_split``: the pack copy, the length-n_fft/2
transform, the batch-major split kernel).  ``_TMAJOR_STFT`` picks the
route; None means auto (see there).  ``istft`` runs the batch-major
backward and the overlap-add sum.

numpy input goes to ``device`` (default "cuda"); tensors stay where they
are.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import fft as _fft
from . import plan as _plan
from .ops import _grad

__all__ = ["frame_signal", "stft_split", "stft_split_tmajor", "stft",
           "istft", "spectrogram", "welch_psd", "hann", "hamming",
           "blackman", "blackmanharris", "flattop", "kaiser", "get_window"]


def _cosine_window(n: int, coefs, dtype) -> np.ndarray:
    """Periodic generalized-cosine window sum_k a_k cos(2 pi k t / n)
    (the scipy.signal.windows family with sym=False)."""

    t = 2.0 * np.pi * np.arange(n) / n
    w = np.zeros(n, dtype=np.float64)
    for k, a in enumerate(coefs):
        w += a * np.cos(k * t) * (-1.0 if k % 2 else 1.0)
    return w.astype(dtype)


def hann(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (COLA at hop n/2, n/4, ...)."""

    return _cosine_window(n, (0.5, 0.5), dtype)


def hamming(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hamming window (0.54/0.46, scipy convention)."""

    return _cosine_window(n, (0.54, 0.46), dtype)


def blackman(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Blackman window (a = 0.16)."""

    return _cosine_window(n, (0.42, 0.5, 0.08), dtype)


def blackmanharris(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic 4-term Blackman-Harris (-92 dB sidelobes)."""

    return _cosine_window(n, (0.35875, 0.48829, 0.14128, 0.01168), dtype)


def flattop(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic flat-top window (scipy coefficient set)."""

    return _cosine_window(
        n, (0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368), dtype)


def kaiser(n: int, beta: float = 8.6, dtype=np.float32) -> np.ndarray:
    """Periodic Kaiser window (I0 form, numpy's i0)."""

    t = np.arange(n, dtype=np.float64) / n  # periodic: denominator n
    w = np.i0(beta * np.sqrt(np.clip(1.0 - (2.0 * t - 1.0) ** 2, 0.0, None)))
    return (w / np.i0(beta)).astype(dtype)


_WINDOWS = {
    "hann": hann, "hamming": hamming, "blackman": blackman,
    "blackmanharris": blackmanharris, "flattop": flattop,
    "kaiser": kaiser, "boxcar": lambda n, dtype=np.float32: np.ones(n, dtype),
    "rect": lambda n, dtype=np.float32: np.ones(n, dtype),
}


def get_window(name, n: int, dtype=np.float32) -> np.ndarray:
    """Window by name (all periodic / DFT-even, scipy sym=False).

    Accepts ``(name, param)`` tuples for parameterized windows (currently
    ``("kaiser", beta)``)."""

    if isinstance(name, tuple):
        base, param = name
        if base != "kaiser":
            raise ValueError(f"unknown parameterized window {base!r}")
        return kaiser(n, float(param), dtype)
    try:
        return _WINDOWS[name](n, dtype=dtype)
    except KeyError:
        raise ValueError(
            f"unknown window {name!r}; available: {sorted(_WINDOWS)}") from None


def _coerce_window(window, n_fft: int) -> np.ndarray:
    """None -> periodic Hann; str / (name, param) -> get_window; else the
    array itself (cast to float32)."""

    if window is None:
        return hann(n_fft)
    if isinstance(window, (str, tuple)):
        return get_window(window, n_fft)
    return np.asarray(window, dtype=np.float32)


def _signal(x, device: Optional[str]) -> torch.Tensor:
    """A real signal as float32 (see ``fft._to_device``; tensors keep their
    strides)."""

    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return _fft._as_plane(x, device)


def frame_signal(x, frame_len: int, hop: int, *, device: Optional[str] = None) -> torch.Tensor:
    """[..., L] -> [..., K, frame_len] frames at stride ``hop``, a view
    (``Tensor.unfold``); K = floor((L - frame_len) / hop) + 1."""

    if not isinstance(x, torch.Tensor):
        x = _fft._as_tensor(x, device)
    length = x.shape[-1]
    if frame_len > length:
        raise ValueError(f"frame_len {frame_len} > signal length {length}")
    return x.unfold(-1, frame_len, hop)


# Time-major STFT route: None = auto, True/False = forced (tests, probes).
# The reference's auto choice asks for the TPU backend, a TPU measurement
# that does not carry over.  Auto takes the batch-major composition on every
# device, so None and False route alike and only True reaches the time-major
# branch: off the card as the reference does off the TPU, and on the card
# from chip_smoke.py's spectral phase on an NVIDIA H100 80GB HBM3 at 700 W, at
# bench_pipeline's STFT shape ([4, 2^22], n_fft 1024, hop 512): batch-major
# 0.58 ms, time-major 0.81 ms, 0.28 of it transposing the spectrum back to
# [..., K, H] (PERF.md §5).
_TMAJOR_STFT: Optional[bool] = None


def _window(w: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32)).to(device)


def _stft_split_tmajor(x: torch.Tensor, plan, hop: int, w: np.ndarray,
                       tmajor_out: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major STFT composition: windowed frames [n_fft, ..., K] (one
    pass, from the unfold view), the time-major REAL transform, and the
    half-size spectrum planes [H, ..., K], moved back to the public [..., K,
    H] layout unless ``tmajor_out``."""

    n_fft = plan.n
    lead = x.shape[:-1]
    fv = frame_signal(x, n_fft, hop).movedim(-1, 0)  # [n_fft, ..., K] view
    wv = _window(w, x.device).reshape((n_fft,) + (1,) * (fv.ndim - 1))
    if _grad.needed(fv):  # autograd takes no out=; the product then costs a copy more
        fr = (fv * wv).contiguous()
    else:
        fr = torch.empty(fv.shape, dtype=torch.float32, device=x.device)
        torch.mul(fv, wv, out=fr)
    k = fr.shape[-1]
    sr, si = _fft.transform_ordered_split_tmajor(plan, fr.reshape(n_fft, -1), _plan.FORWARD)
    h = plan.spectrum_size
    sr, si = sr.reshape((h,) + lead + (k,)), si.reshape((h,) + lead + (k,))
    if tmajor_out:
        return sr, si
    return sr.movedim(0, -1).contiguous(), si.movedim(0, -1).contiguous()


def stft_split_tmajor(x, n_fft: int, hop: int, window: Optional[np.ndarray] = None, *,
                      device: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-major STFT for time-major pipelines: [..., L] real ->
    ([H, ..., K]) x2 planes (H = n_fft/2 packed bins), with no transpose
    back to the public [..., K, H] layout."""

    plan = _plan.Plan.create(n_fft, _plan.REAL, strict=False)
    return _stft_split_tmajor(_signal(x, device), plan, hop, _coerce_window(window, n_fft),
                              tmajor_out=True)


def stft_split(x, n_fft: int, hop: int, window: Optional[np.ndarray] = None, *,
               device: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-format STFT of a real signal: [..., L] -> ([..., K, H]) x2
    planes (H = n_fft/2 packed bins, pffft bin0 convention)."""

    x = _signal(x, device)
    plan = _plan.Plan.create(n_fft, _plan.REAL, strict=False)
    w = _coerce_window(window, n_fft)
    if _TMAJOR_STFT:
        return _stft_split_tmajor(x, plan, hop, w)
    fr = frame_signal(x, n_fft, hop) * _window(w, x.device)
    return _fft.transform_ordered_split(plan, fr)


def stft(x, n_fft: int, hop: int, window: Optional[np.ndarray] = None, *,
         device: Optional[str] = None) -> torch.Tensor:
    """Complex-dtype STFT: [..., K, H] packed spectrum, complex64."""

    return torch.complex(*stft_split(x, n_fft, hop, window, device=device))


def istft(s, hop: int, window: Optional[np.ndarray] = None, length: Optional[int] = None, *,
          device: Optional[str] = None) -> torch.Tensor:
    """Inverse STFT by overlap-add with COLA normalization.

    s: [..., K, H] packed spectrum (complex).  Returns [..., L] real with
    L = (K-1)*hop + n_fft (trimmed to ``length`` if given)."""

    s = _fft._as_complex(s, device)
    h = s.shape[-1]
    n_fft = 2 * h
    k = s.shape[-2]
    plan = _plan.Plan.create(n_fft, _plan.REAL, strict=False)
    w = _coerce_window(window, n_fft)
    frames = _fft.transform_ordered(plan, s, _plan.BACKWARD) / n_fft  # [..., K, n_fft]
    frames = frames * _window(w, s.device)
    # overlap-add: frame i's chunk sft (hop samples) lands at (i + sft)*hop
    out_len = (k - 1) * hop + n_fft
    spans = -(-n_fft // hop)
    total = (k - 1 + spans) * hop
    fpad = torch.nn.functional.pad(frames, (0, spans * hop - n_fft))
    fchunks = fpad.reshape(*frames.shape[:-1], spans, hop)  # [..., K, spans, hop]
    acc = frames.new_zeros((*s.shape[:-2], total))
    for sft in range(spans):
        acc[..., sft * hop : sft * hop + k * hop] += fchunks[..., sft, :].reshape(
            *s.shape[:-2], k * hop)
    # the sum of squared windows at each position, summed in float64 on
    # the device as the frames are, then rounded to float32
    w2 = torch.zeros(spans * hop, dtype=torch.float64, device=s.device)
    w2[:n_fft] = torch.from_numpy(w.astype(np.float64) ** 2).to(s.device)
    wsq = torch.zeros(total, dtype=torch.float64, device=s.device)
    for sft in range(spans):
        wsq[sft * hop : sft * hop + k * hop] += w2[sft * hop : (sft + 1) * hop].repeat(k)
    out = acc / wsq.clamp_min(1e-12).to(torch.float32)
    out = out[..., :out_len]
    return out[..., :length] if length is not None else out


def spectrogram(x, n_fft: int, hop: int, window: Optional[np.ndarray] = None, *,
                device: Optional[str] = None) -> torch.Tensor:
    """Power spectrogram [..., K, H] (packed bins)."""

    sr, si = stft_split(x, n_fft, hop, window, device=device)
    return sr * sr + si * si


def welch_psd(x, n_fft: int, hop: Optional[int] = None, window: Optional[np.ndarray] = None,
              *, device: Optional[str] = None) -> torch.Tensor:
    """Welch power-spectral-density estimate: [..., H+1] (unpacked bins,
    numpy rfft layout), window-power normalized."""

    hop = hop or n_fft // 2
    w = _coerce_window(window, n_fft)
    sr, si = stft_split(x, n_fft, hop, w, device=device)
    pm = torch.mean(sr * sr + si * si, dim=-2)  # [..., H] packed
    # bin0 holds DC (re) and Nyquist (im)
    dc = torch.mean(sr[..., :, 0] ** 2, dim=-1)
    nyq = torch.mean(si[..., :, 0] ** 2, dim=-1)
    out = torch.cat([dc[..., None], pm[..., 1:], nyq[..., None]], dim=-1)
    return out / float(np.sum(w.astype(np.float64) ** 2))
