"""DCT/DST transforms through the batched FFT engine.

Counterpart of ``pffft_tpu/dct.py``.  Conventions match FFTPACK exactly
(unnormalized):

  dct1 (cost): X[k] = x[0] + (-1)^k x[N-1] + 2 sum_{0<j<N-1} x[j] cos(pi j k/(N-1))
  dst1 (sint): X[k] = 2 sum_j x[j] sin(pi (j+1)(k+1)/(N+1))
  dct2 (cosqb): X[k] = 2 sum_j x[j] cos(pi k (2j+1) / 2N)
  dct3 (cosqf): X[k] = x[0] + 2 sum_{j>=1} x[j] cos(pi j (2k+1) / 2N)
  dst2 (sinqb): X[k] = 2 sum_j x[j] sin(pi (k+1)(2j+1) / 2N)
  dst3 (sinqf): X[k] = (-1)^k x[N-1] + 2 sum_{j<N-1} x[j] sin(pi (j+1)(2k+1)/2N)

Inverse pairs: dct1 involutary up to 2(N-1); dst1 up to 2(N+1);
dct3(dct2(x)) == dst3(dst2(x)) == 2N x.

Constructions, as the reference's:
  dct1: N-term even extension -> 2(N-1)-point FFT real part.
  dst1: odd extension -> 2(N+1)-point FFT, -imag part.
  dct2: Makhoul even-odd permutation v = [x0, x2, .., x3, x1] ->
        N-point FFT -> modulate by e^{-i pi k/2N}.
  dct3: exact inverse of the dct2 construction (A[k] = x[k] - i x[N-k],
        V = e^{+i pi k/2N} A, unscaled backward FFT, un-permute).
  dst2(x) = flip(dct2(x * (-1)^n));  dst3(x) = (-1)^k * dct3(flip(x)).

The inner complex FFT of a smooth length runs through the port's
batch-major dispatcher (``ops/dispatch.cfft_dispatch``, ordered): B9 up to
16384, the ``"tmajor"`` route above, the stage engine where no kernel
covers the length and for float64.  The reference runs its stage engine
there; the function is the same.  A non-smooth inner length takes the
chirp-Z path (:mod:`pffft_tpu_torch.bluestein`), so every N works.

Input: a float32 or float64 tensor (other dtypes become float32; numpy goes
to ``device``, default "cuda"), batched over leading axes; the output has
its dtype and device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import bluestein as _bs
from . import fft as _fft
from . import plan as _plan
from .ops import dispatch as _dispatch

__all__ = ["dct1", "dst1", "dct2", "dct3", "dst2", "dst3",
           "cost", "sint", "cosqb", "cosqf", "sinqb", "sinqf"]


def _real(x, device: Optional[str]) -> torch.Tensor:
    """x as a float32 or float64 tensor (its own precision if it has one)."""

    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    wide = x.dtype in (torch.float64, np.dtype(np.float64))
    return _fft._to_device(x, device, torch.float64 if wide else torch.float32)


def _np_dtype(x: torch.Tensor) -> str:
    return "float64" if x.dtype == torch.float64 else "float32"


def _cfft_split(re, im, n, backward=False):
    """Ordered complex FFT of planes [..., n], unscaled."""

    dtype = _np_dtype(re)
    try:
        p = _plan.Plan.create(n, _plan.COMPLEX, dtype, strict=False)
    except ValueError:
        # non-smooth inner length -> chirp-Z engine: the constructions then
        # accept ANY N (the FFTPACK oracle's parity)
        bp = _bs.new_setup_any(n, _plan.COMPLEX, dtype)
        d = _plan.BACKWARD if backward else _plan.FORWARD
        return _bs.transform_any_split(bp, (re, im), d)
    return _dispatch.cfft_dispatch(p, re.contiguous(), im.contiguous(), backward=backward,
                                   time_major=False, ordered=True)


@functools.lru_cache(maxsize=256)
def _halfsec_tables(n: int, dtype_str: str, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """cos/sin(pi k / 2N) for k = 0..N-1 on ``device`` (float64 host
    conditioning)."""

    k = np.arange(n, dtype=np.float64)
    ang = np.pi * k / (2.0 * n)
    dt = np.dtype(dtype_str)
    return tuple(torch.from_numpy(t.astype(dt)).to(device) for t in (np.cos(ang), np.sin(ang)))


def _halfsec(n: int, x: torch.Tensor):
    """The half-sample modulation planes in x's dtype on x's device."""

    return _halfsec_tables(n, _np_dtype(x), x.device)


def _sgn(n: int, x: torch.Tensor) -> torch.Tensor:
    """(-1)^k, k = 0..n-1, in x's dtype on x's device."""

    s = torch.ones(n, dtype=x.dtype, device=x.device)
    s[1::2] = -1.0
    return s


def dct1(x, *, device: Optional[str] = None) -> torch.Tensor:
    """DCT-I (FFTPACK cost), batched over leading axes."""

    x = _real(x, device)
    n = x.shape[-1]
    ext = torch.cat([x, torch.flip(x[..., 1:-1], (-1,))], dim=-1)  # even extension, 2(N-1)
    re, _ = _cfft_split(ext, torch.zeros_like(ext), 2 * (n - 1))
    return re[..., :n].contiguous()


def dst1(x, *, device: Optional[str] = None) -> torch.Tensor:
    """DST-I (FFTPACK sint), batched."""

    x = _real(x, device)
    n = x.shape[-1]
    zero = x.new_zeros((*x.shape[:-1], 1))
    ext = torch.cat([zero, x, zero, -torch.flip(x, (-1,))], dim=-1)  # 2(N+1)
    _, im = _cfft_split(ext, torch.zeros_like(ext), 2 * (n + 1))
    return -im[..., 1:n + 1]


def dct2(x, *, device: Optional[str] = None) -> torch.Tensor:
    """DCT-II (FFTPACK cosqb without its factor 2), batched.  Any N: the
    Makhoul even-odd permutation [x0, x2, .., x_last_even, .., x3, x1] and
    the e^{-i pi k/2N} modulation hold for odd N too (the even-index half
    is one element longer)."""

    x = _real(x, device)
    n = x.shape[-1]
    v = torch.cat([x[..., 0::2], torch.flip(x[..., 1::2], (-1,))], dim=-1)
    vr, vi = _cfft_split(v, torch.zeros_like(v), n)
    cr, sr = _halfsec(n, x)
    # C[k] = 2 Re(e^{-i pi k/2N} V[k]) = 2 (cos*Re + sin*Im)
    return 2.0 * (cr * vr + sr * vi)


def dct3(x, *, device: Optional[str] = None) -> torch.Tensor:
    """DCT-III (FFTPACK cosqf), batched; dct3(dct2(x)) == 2N x.  Any N
    (see dct2; the un-permute interleave handles the odd case's extra
    even-index element)."""

    x = _real(x, device)
    n = x.shape[-1]
    cr, sr = _halfsec(n, x)
    # A[k] = x[k] - i x[N-k] (x[N] := 0);  V[k] = e^{+i pi k/2N} A[k]
    xs = torch.cat([torch.zeros_like(x[..., :1]), torch.flip(x[..., 1:], (-1,))], dim=-1)
    vr = cr * x + sr * xs
    vi = sr * x - cr * xs
    br, _ = _cfft_split(vr, vi, n, backward=True)  # unscaled IDFT * N
    # un-permute: out[2j] = v[j] (ceil(N/2) terms), out[2j+1] = v[N-1-j]
    nh = (n + 1) // 2
    ev = br[..., :nh]
    od = torch.flip(br[..., nh:], (-1,))
    pairs = torch.stack([ev[..., : n // 2], od], dim=-1).reshape(
        *x.shape[:-1], 2 * (n // 2))
    if n % 2 == 0:
        return pairs
    return torch.cat([pairs, ev[..., -1:]], dim=-1)


def dst2(x, *, device: Optional[str] = None) -> torch.Tensor:
    """DST-II (FFTPACK sinqb without its factor 2): flip(dct2(x * (-1)^n))."""

    x = _real(x, device)
    return torch.flip(dct2(x * _sgn(x.shape[-1], x)), (-1,))


def dst3(x, *, device: Optional[str] = None) -> torch.Tensor:
    """DST-III (FFTPACK sinqf): dst3(x) = (-1)^k * dct3(flip(x))."""

    x = _real(x, device)
    return _sgn(x.shape[-1], x) * dct3(torch.flip(x, (-1,)))


# FFTPACK names.  cosqf/sinqf are exactly DCT-III/DST-III; the backward
# quarter-wave transforms carry FFTPACK's factor 4 so cosqb(cosqf(x)) ==
# 4N*x.
cost = dct1
sint = dst1
cosqf = dct3
sinqf = dst3


def cosqb(x, *, device: Optional[str] = None) -> torch.Tensor:
    """FFTPACK cosqb = 2 * DCT-II (roundtrip cosqb(cosqf(x)) == 4N x)."""

    return 2.0 * dct2(x, device=device)


def sinqb(x, *, device: Optional[str] = None) -> torch.Tensor:
    """FFTPACK sinqb = 2 * DST-II (roundtrip sinqb(sinqf(x)) == 4N x)."""

    return 2.0 * dst2(x, device=device)
