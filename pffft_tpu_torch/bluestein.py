"""Transforms of any length: Bluestein's chirp-Z algorithm, the general CZT
and the spectral zoom.

Counterpart of ``pffft_tpu/bluestein.py``.  A length-N DFT is embedded in a
cyclic convolution of a 2/3/5-smooth length M >= 2N-1 (Bluestein 1968):

    jk = (j^2 + k^2 - (k-j)^2) / 2
    X[k] = e^{s i pi k^2/N} * sum_j (x[j] e^{s i pi j^2/N}) e^{-s i pi (k-j)^2/N}

with s = -1 forward / +1 backward, unscaled (backward(forward(x)) == N*x).
The chirp phases are reduced exactly in integers, so the tables equal the
reference's bit for bit.

The convolution runs on batch-major planes through the port's dispatcher
(``ops/dispatch.cfft_dispatch``): B9 (``csrc/fused2.cu``) for M <= 16384,
the ``"tmajor"`` route (B1 + B2 around two transposes) above, the stage
engine where no kernel covers M, and always for float64 plans.  Two
choices differ from the reference:

  * The default M of a float32 plan is the smallest smooth M >= 2N-1 that
    B9 or kern2 runs (:func:`kernel_smooth_size`, decided by the sm_90
    rules on every device, so the CPU and the card use one M); the
    reference takes the smallest smooth M (:func:`next_smooth_size`),
    which may fall onto the stage engine.  Any M >= 2N-1 gives the same
    transform.  ``m=`` still forces an exact length; float64 plans keep the
    reference's M.
  * The convolution uses ORDERED transforms and an ordered kernel
    spectrum: the port's kernels compute canonical order, and the
    pointwise product does not depend on the order.  The kernel spectrum
    is taken in float64 on the host (``np.fft``) and rounded once to the
    plan's dtype; its device copy carries the 1/M of the inverse.

numpy input goes to ``device`` (default "cuda"); tensors stay on their
device.  Device tables are cached per plan and device.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import fft as _fft
from . import plan as _plan
from .ops import dispatch as _dispatch
from .ops import fused_stage as _fs
from .ops import pallas_fft as _pk
from .ops import split as _split

__all__ = [
    "BluesteinPlan",
    "next_smooth_size",
    "kernel_smooth_size",
    "new_setup_any",
    "transform_any",
    "transform_any_split",
    "rfft_any",
    "irfft_any",
    "CztPlan",
    "czt",
    "czt_split",
    "zoom_fft",
    "zoom_fft_setup",
]


def next_smooth_size(n: int) -> int:
    """Smallest 2/3/5-smooth integer >= n (no SIMD-granularity contract —
    this is the inner-engine size, not a pffft_is_valid_size size)."""

    m = max(int(n), 2)
    while True:
        try:
            _plan.decompose_smooth(m)
            return m
        except ValueError:
            m += 1


# The longest length a batch-major kernel route runs: kern2 with the chain's
# longest length as pass A and the widest combine radix.
_KERNEL_M_MAX = max(_fs.MAX_N, _pk.chain_max_n() * max(_pk.COMBINE_RADICES))


def _kernel_covers(m: int) -> bool:
    """Whether B9 or kern2 (the ``"tmajor"`` route) runs length m, by the
    sm_90 limits (no device asked)."""

    return _fs.fused2_tile(m) is not None or _dispatch._kern2_conf(m) is not None


def kernel_smooth_size(n: int) -> int:
    """Smallest 2/3/5-smooth m >= n that a batch-major f32 kernel runs: B9
    up to 16384, kern2 behind the ``"tmajor"`` route up to 65536; else
    :func:`next_smooth_size` (the stage engine)."""

    m = next_smooth_size(n)
    while m <= _KERNEL_M_MAX:
        if _kernel_covers(m):
            return m
        m = next_smooth_size(m + 1)
    return next_smooth_size(n)


def _default_m(n: int, dtype: np.dtype) -> int:
    """The inner length for a convolution of n >= 2 outputs: the kernel rule
    for float32, the reference's smallest smooth length for float64."""

    return kernel_smooth_size(n) if dtype == np.float32 else next_smooth_size(n)


def _chirp_tables(n: int, m: int, dtype: np.dtype):
    """Forward-direction chirp and cyclic kernel, exact integer phases.

    Returns (c_re, c_im) [n] with c[j] = e^{-i pi j^2 / n} and
    (b_re, b_im) [m] with the conjugate chirp laid out cyclically
    (B[j] = B[m-j] = e^{+i pi j^2 / n}, zero in the dead middle).
    The backward direction is the elementwise conjugate of both.
    """

    two_n = 2 * n
    # exact in int64: j^2 <= (2^25)^2 = 2^50 < 2^63 under the N cap
    j = np.arange(n, dtype=np.int64)
    ph = ((j * j) % two_n).astype(np.float64)
    ph *= math.pi / n
    c_re = np.cos(ph)
    c_im = -np.sin(ph)
    b_re = np.zeros(m, dtype=np.float64)
    b_im = np.zeros(m, dtype=np.float64)
    b_re[:n] = c_re
    b_im[:n] = -c_im
    # wrap negative lags: kernel index (k - j) mod m for k < n, j < n
    b_re[m - n + 1:] = c_re[1:][::-1]
    b_im[m - n + 1:] = -c_im[1:][::-1]
    return (
        c_re.astype(dtype),
        c_im.astype(dtype),
        b_re.astype(dtype),
        b_im.astype(dtype),
    )


def _spectrum(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """Ordered forward spectrum of a float64 kernel, complex128."""

    return np.fft.fft(re.astype(np.float64) + 1j * im.astype(np.float64))


class _ChirpConv:
    """The chirp-Z pipeline shared by both plan types: pre-chirp, zero pad
    to M, ordered forward transform, product with the kernel spectrum,
    ordered backward transform, the first ``n_out`` samples, post-chirp.

    Subclasses set ``n``, ``m``, ``dtype``, ``inner`` and the host tables
    ``_pre``, ``_post`` (numpy planes) and ``_kern`` (the complex128
    kernel spectrum, unscaled)."""

    def _device_tables(self, device: torch.device, backward: bool):
        """(pre, kern / M, post) as plane pairs on ``device``; backward
        conjugates all three."""

        key = (device, backward)
        tabs = self._dev.get(key)
        if tabs is None:
            sign = -1.0 if backward else 1.0
            kern = self._kern / self.m

            def pair(re, im):
                return (torch.from_numpy(np.ascontiguousarray(re, self.dtype)).to(device),
                        torch.from_numpy(np.ascontiguousarray(sign * im, self.dtype)).to(device))

            tabs = (pair(*self._pre), pair(kern.real, kern.imag), pair(*self._post))
            self._dev[key] = tabs
        return tabs

    def _run(self, re: torch.Tensor, im: torch.Tensor, backward: bool, n_out: int):
        pre, kern, post = self._device_tables(re.device, backward)
        ar, ai = _split.split_mul((re, im), pre)
        pad = (0, self.m - re.shape[-1])
        ar, ai = F.pad(ar, pad), F.pad(ai, pad)
        sr, si = _dispatch.cfft_dispatch(self.inner, ar, ai, time_major=False)
        sr, si = _split.split_mul((sr, si), kern)
        cr, ci = _dispatch.cfft_dispatch(self.inner, sr, si, backward=True, time_major=False)
        return _split.split_mul((cr[..., :n_out], ci[..., :n_out]),
                                (post[0][:n_out], post[1][:n_out]))


class BluesteinPlan(_ChirpConv):
    """Chirp-Z plan: complex transform of ANY length n >= 2.

    Mirrors the Plan surface where it makes sense (n, dtype, kind,
    spectrum_size); the convolution engine is an ordinary smooth COMPLEX
    :class:`pffft_tpu_torch.plan.Plan` of length ``m`` (``inner``).
    ``_chirp`` holds the chirp planes and ``_bhat`` the kernel spectrum
    planes, ordered, as numpy arrays of the plan's dtype.
    """

    kind = _plan.COMPLEX

    def __init__(self, n: int, dtype="float32", *, m: Optional[int] = None):
        n = int(n)
        if n < 2:
            raise ValueError(f"N={n}: Bluestein transform needs N >= 2")
        if n > (1 << 25):
            raise ValueError(
                f"N={n} exceeds the 2^25 Bluestein cap (inner length 2N)")
        self.n = n
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise ValueError(f"unsupported dtype {dtype}")
        self.m = int(m) if m is not None else _default_m(2 * n - 1, self.dtype)
        if self.m < 2 * n - 1:
            raise ValueError(f"m={self.m} < 2N-1={2 * n - 1}")
        _plan.decompose_smooth(self.m)  # raises if a custom m is not smooth
        self.inner = _plan.Plan.create(self.m, _plan.COMPLEX, self.dtype, strict=False)
        c_re, c_im, _, _ = _chirp_tables(n, self.m, self.dtype)
        self._chirp = (c_re, c_im)
        self._pre = self._post = self._chirp
        _, _, b_re, b_im = _chirp_tables(n, self.m, np.float64)
        self._kern = _spectrum(b_re, b_im)
        self._bhat = (self._kern.real.astype(self.dtype), self._kern.imag.astype(self.dtype))
        self._dev: Dict = {}

    @property
    def spectrum_size(self) -> int:
        return self.n

    def __repr__(self) -> str:  # pragma: no cover
        return (f"BluesteinPlan(N={self.n}, m={self.m}, "
                f"{self.dtype.name})")


def transform_any_split(bplan: BluesteinPlan, x, direction=_plan.FORWARD, *,
                        device: Optional[str] = None):
    """Split-format ordered transform for any-N plans.

    x = (re, im) planes [..., N] -> (re, im) planes [..., N].
    Unscaled: backward(forward(x)) == N * x.
    """

    d = _plan._coerce_direction(direction)
    re, im = (_fft._as_plane(a, device, bplan) for a in x)
    if re.shape[-1] != bplan.n or im.shape[-1] != bplan.n:
        raise ValueError(
            f"last axis must be N={bplan.n}, got {re.shape[-1]}/{im.shape[-1]}")
    _fft._check_pair(re, im)
    return bplan._run(re, im, d == _plan.BACKWARD, bplan.n)


def _complex_input(x, device: Optional[str], plan) -> torch.Tensor:
    """x as a tensor of the plan's complex dtype (real input gets a zero
    imaginary part)."""

    return _fft._as_tensor(x, device, plan).to(_fft._complex_dtype(plan))


def transform_any(bplan: BluesteinPlan, x, direction=_plan.FORWARD, *,
                  device: Optional[str] = None):
    """Complex-dtype convenience for :func:`transform_any_split`."""

    z = _complex_input(x, device, bplan)
    return torch.complex(*transform_any_split(bplan, _split.to_split(z), direction))


def new_setup_any(n: int, kind=_plan.COMPLEX, dtype="float32", *,
                  m: Optional[int] = None, **plan_kw):
    """new_setup for ANY length: a smooth (strict=False) Plan when the
    engine supports N directly, a :class:`BluesteinPlan` otherwise.

    Both returned types work with transform_ordered /
    transform_ordered_split.  REAL kind requires a smooth even N (use
    :func:`rfft_any` for arbitrary-length real input).  ``m`` forces the
    Bluestein path with that smooth inner length; other keywords
    (max_factor, factors) apply to the smooth-plan path only.
    """

    kind = _plan._coerce_kind(kind)
    if m is None:
        try:
            return _plan.Plan.create(n, kind, dtype, strict=False, **plan_kw)
        except ValueError:
            pass
    if kind == _plan.REAL:
        raise ValueError(
            f"N={n} is not 2/3/5-smooth-even; arbitrary-N real input "
            f"goes through rfft_any / irfft_any (Bluestein)")
    if m is not None:
        return BluesteinPlan(n, dtype, m=m)
    # cached: repeated setup of the same (n, dtype) reuses the chirp
    # tables, the kernel spectrum and their device copies
    return _bluestein_cached(int(n), np.dtype(dtype).name)


def _real_plan_or_none(n: int, dtype: str):
    """Smooth-even-N packed REAL plan, or None (then Bluestein it is)."""

    try:
        return _plan.Plan.create(n, _plan.REAL, dtype, strict=False)
    except ValueError:
        return None


def _real_torch(dtype: str) -> torch.dtype:
    return torch.float64 if dtype == "float64" else torch.float32


def rfft_any(x, dtype="float32", *, device: Optional[str] = None):
    """Forward real transform of ANY length: [..., N] real ->
    [..., N//2 + 1] complex bins (numpy rfft convention, unscaled).

    Smooth even N rides the half-length packed REAL engine (one
    N/2-point transform: the pack copy, B9 and B6 on the card); everything
    else the complex Bluestein path.
    """

    dtype = np.dtype(dtype).name
    x = _fft._to_device(x, device, _real_torch(dtype))
    n = int(x.shape[-1])
    if n == 1:  # degenerate length (np.fft.rfft parity): X[0] = x[0]
        return x.to(torch.complex128 if dtype == "float64" else torch.complex64)
    p = _real_plan_or_none(n, dtype)
    if p is not None:
        return _fft.spectrum_unpack(_fft.transform_ordered(p, x, _plan.FORWARD))
    bplan = _bluestein_cached(n, dtype)
    h = n // 2 + 1
    return torch.complex(*bplan._run(x, torch.zeros_like(x), False, h))


def irfft_any(s, n: int, dtype="float32", *, device: Optional[str] = None):
    """Backward of :func:`rfft_any`: [..., N//2+1] complex -> [..., N]
    real.  Unscaled (irfft_any(rfft_any(x), N) == N * x)."""

    dtype = np.dtype(dtype).name
    n = int(n)
    h = n // 2 + 1
    s = _fft._to_device(s, device, torch.complex128 if dtype == "float64"
                        else torch.complex64)
    if s.shape[-1] != h:
        raise ValueError(f"expected {h} bins for N={n}, got {s.shape[-1]}")
    if n == 1:  # unscaled inverse of the degenerate forward
        return s.real.contiguous()
    p = _real_plan_or_none(n, dtype)
    if p is not None:
        return _fft.transform_ordered(p, _fft.spectrum_pack(s), _plan.BACKWARD)
    bplan = _bluestein_cached(n, dtype)
    # rebuild the full Hermitian spectrum: X[n-k] = conj(X[k]), k=1..n-h
    sr, si = s.real, s.imag
    tail = slice(1, n - h + 1)
    fr = torch.cat([sr, torch.flip(sr[..., tail], (-1,))], dim=-1)
    fi = torch.cat([si, -torch.flip(si[..., tail], (-1,))], dim=-1)
    return bplan._run(fr, fi, True, n)[0]


@functools.lru_cache(maxsize=64)
def _bluestein_cached(n: int, dtype: str) -> BluesteinPlan:
    return BluesteinPlan(n, dtype)


# --------------------------------------------------------------------------
# General chirp-Z transform (CZT) and spectral zoom
# --------------------------------------------------------------------------

def _exact_phase_mod2(scale: float, idx) -> np.ndarray:
    """(scale * idx) mod 2, computed exactly.

    ``scale`` (a float) is exactly the binary rational p/2^k, so the
    product and the mod-2 reduction can be done in integer arithmetic —
    no precision loss at large idx (float64 j^2 phases lose ~2^-13 of a
    turn by j ~ 2^20, far above the f32 noise floor).
    """

    frac = float(scale).as_integer_ratio()
    p, q = frac
    two_q = 2 * q
    out = np.empty(len(idx), dtype=np.float64)
    for i, j in enumerate(idx):
        out[i] = ((p * int(j)) % two_q) / q
    return out


def _chirp_planes(phase_turns: np.ndarray, dtype: np.dtype):
    ang = math.pi * phase_turns  # phase_turns is in half-turn units mod 2
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


class CztPlan(_ChirpConv):
    """Chirp-Z transform along the unit circle (Rabiner-Schafer-Rader).

        X[k] = sum_j x[j] * A^{-j} * W^{jk},   k = 0..m-1

    with W = e^{-2 pi i w_phase} and A = e^{+2 pi i a_phase} — the
    unit-modulus CZT (scipy.signal.czt with |w| = |a| = 1).  Defaults give
    the ordinary DFT (w_phase = 1/n, a_phase = 0, m = n).

    The sum is a linear convolution of length n+m-1, run as a cyclic
    convolution of smooth length ``self.m`` (the rule of
    :class:`BluesteinPlan`).  Chirp phases w_phase * j^2 / 2 are reduced
    mod 2 in exact integer arithmetic (a float w_phase is exactly p/2^k).
    ``_pre`` / ``_post`` hold the chirp planes and ``_vhat`` the kernel
    spectrum planes, ordered, as numpy arrays of the plan's dtype.
    """

    kind = _plan.COMPLEX

    def __init__(self, n: int, m: Optional[int] = None, *,
                 w_phase: Optional[float] = None, a_phase: float = 0.0,
                 dtype="float32"):
        self.n = int(n)
        self.m_out = int(m) if m is not None else self.n
        if self.n < 1 or self.m_out < 1:
            raise ValueError("CZT needs n >= 1 and m >= 1")
        if self.n * self.m_out > (1 << 44):
            raise ValueError("CZT size cap exceeded")
        self.w_phase = float(w_phase) if w_phase is not None else 1.0 / self.n
        self.a_phase = float(a_phase)
        self.dtype = np.dtype(dtype)
        n_, m_ = self.n, self.m_out
        self.m = _default_m(n_ + m_ - 1, self.dtype)
        self.inner = _plan.Plan.create(self.m, _plan.COMPLEX, self.dtype, strict=False)

        j = np.arange(max(n_, m_), dtype=object)
        # chirp phase (w_phase/2) * j^2, exact mod 2
        sq = _exact_phase_mod2(self.w_phase, [int(v) * int(v) for v in j])
        # pre[j] = A^{-j} W^{j^2/2}: phase = -(a_phase*j) - (w/2) j^2 turns
        lin = _exact_phase_mod2(2.0 * self.a_phase, [int(v) for v in j[:n_]])
        pre_turns = (-lin - sq[:n_]) % 2.0
        self._pre = _chirp_planes(pre_turns, self.dtype)
        # post[k] = W^{k^2/2}: phase = -(w/2) k^2 turns
        post_turns = (-sq[:m_]) % 2.0
        self._post = _chirp_planes(post_turns, self.dtype)
        # kernel v[d] = W^{-d^2/2} (phase +(w/2) d^2), d = -(n-1)..(m-1),
        # laid out cyclically: V[d mod M]
        vr = np.zeros(self.m, dtype=np.float64)
        vi = np.zeros(self.m, dtype=np.float64)
        kr, ki = _chirp_planes(sq, np.float64)
        vr[:m_], vi[:m_] = kr[:m_], ki[:m_]
        if n_ > 1:
            vr[-(n_ - 1):] = kr[1:n_][::-1]
            vi[-(n_ - 1):] = ki[1:n_][::-1]
        self._kern = _spectrum(vr, vi)
        self._vhat = (self._kern.real.astype(self.dtype), self._kern.imag.astype(self.dtype))
        self._dev: Dict = {}

    def __repr__(self) -> str:  # pragma: no cover
        return (f"CztPlan(n={self.n}, m={self.m_out}, w={self.w_phase!r}, "
                f"a={self.a_phase!r}, {self.dtype.name})")


def czt_split(cplan: CztPlan, x, *, device: Optional[str] = None):
    """Split-format CZT: (re, im) planes [..., n] -> (re, im) [..., m]."""

    re, im = (_fft._as_plane(a, device, cplan) for a in x)
    if re.shape[-1] != cplan.n:
        raise ValueError(f"last axis must be n={cplan.n}, got {re.shape[-1]}")
    _fft._check_pair(re, im)
    return cplan._run(re, im, False, cplan.m_out)


def czt(cplan: CztPlan, x, *, device: Optional[str] = None):
    """Complex-dtype CZT convenience."""

    z = _complex_input(x, device, cplan)
    return torch.complex(*czt_split(cplan, _split.to_split(z)))


def zoom_fft_setup(n: int, fn, m: Optional[int] = None, *, fs: float = 2.0,
                   endpoint: bool = False, dtype="float32") -> CztPlan:
    """Spectral-zoom plan (scipy.signal.zoom_fft conventions).

    Evaluates the DTFT of an n-sample signal at m frequencies spanning
    [f0, f1] (``fn`` scalar means [0, fn]) for sample rate ``fs``:
    bin k sits at f0 + k*(f1-f0)/m (or /(m-1) with endpoint=True).
    """

    if np.ndim(fn) == 0:
        f0, f1 = 0.0, float(fn)
    else:
        f0, f1 = (float(v) for v in fn)
    m = int(m) if m is not None else int(n)
    step = (f1 - f0) / (m - 1 if endpoint and m > 1 else m)
    return CztPlan(n, m, w_phase=step / fs, a_phase=f0 / fs, dtype=dtype)


def zoom_fft(x, fn, m: Optional[int] = None, *, fs: float = 2.0,
             endpoint: bool = False, dtype="float32", device: Optional[str] = None):
    """One-shot spectral zoom of x along its last axis (complex out)."""

    n = int(x.shape[-1]) if isinstance(x, torch.Tensor) else int(np.shape(x)[-1])
    cplan = _zoom_cached(n,
                         float(fn) if np.ndim(fn) == 0 else (float(fn[0]), float(fn[1])),
                         None if m is None else int(m), float(fs),
                         bool(endpoint), np.dtype(dtype).name)
    return czt(cplan, x, device=device)


@functools.lru_cache(maxsize=64)
def _zoom_cached(n, fn, m, fs, endpoint, dtype) -> CztPlan:
    return zoom_fft_setup(n, fn, m, fs=fs, endpoint=endpoint, dtype=dtype)

