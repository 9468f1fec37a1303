"""Validation oracle: independent scalar reference transforms (fftpack role).

Counterpart of ``pffft_tpu/oracle.py``, copied so that the port imports
nothing of the JAX package; its functions equal the reference's bit for
bit.  PFFFT carries a scalar FFTPACK port as its in-tree oracle
(``src/fftpack.{h,c}``): an implementation with no code shared with the
engine under test, used by ``bench_pffft --validate``.  This module plays
that role for the port: a pure-numpy float64 recursive mixed-radix FFT
written from the DFT definition (no np.fft, no torch, no shared code with
pffft_tpu_torch.ops), plus the FFTPACK auxiliary transform surface
(DCT/DST families: cost/sint/cosqf/cosqb/sinqf/sinqb, fftpack.h:62-86)
expressed through it.

Conventions match FFTPACK:
  * cfftf = unscaled forward (e^{-2pi i nk/N}), cfftb = unscaled backward;
    cfftb(cfftf(x)) == N*x.
  * rfftf packs [r0, r1, i1, r2, i2, ..., rN/2] (N even), rfftb inverts
    unscaled.
  * cost (DCT-I), sint (DST-I), cosqf/cosqb (quarter-wave DCT-III/II),
    sinqf/sinqb (quarter-wave DST-III/II), all unnormalized like FFTPACK:
    applying forward then backward multiplies by the documented factor.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "cfftf", "cfftb", "rfftf", "rfftb",
    "cost", "sint", "cosqf", "cosqb", "sinqf", "sinqb",
    "dct1", "dst1", "dct2", "dct3", "dst2", "dst3",
    "packed_spectrum", "unpacked_spectrum",
]


# ---------------------------------------------------------------------------
# Core recursive mixed-radix complex FFT (float64, by the DFT definition)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=512)
def _dft_dense(n: int, sign: int) -> np.ndarray:
    k = np.arange(n)
    m = np.exp(sign * 2j * np.pi * np.outer(k, k % n) / n)
    return m


def _smallest_factor(n: int) -> int:
    for p in (2, 3, 5, 7, 11, 13):
        if n % p == 0:
            return p
    # fall back to dense DFT for prime/unusual n
    return n


def _cfft_rec(x: np.ndarray, sign: int) -> np.ndarray:
    """Recursive Cooley-Tukey over the last axis; O(N^2) dense fallback."""

    n = x.shape[-1]
    if n == 1:
        return x
    p = _smallest_factor(n)
    if p == n:
        return x @ _dft_dense(n, sign).T
    m = n // p
    # decimation in time: split residues mod p
    sub = np.stack([_cfft_rec(x[..., r::p], sign) for r in range(p)], axis=-2)  # [.., p, m]
    k = np.arange(m)
    tw = np.exp(sign * 2j * np.pi * np.outer(np.arange(p), k) / n)  # [p, m]
    sub = sub * tw
    # combine: X[k + m*t] = sum_r e^{sign 2pi i r t / p} sub[r, k]
    comb = np.exp(sign * 2j * np.pi * np.outer(np.arange(p), np.arange(p)) / p)  # [r, t]
    out = np.einsum("...rk,rt->...tk", sub, comb)
    return out.reshape(*x.shape[:-1], n)


def cfftf(x) -> np.ndarray:
    """FFTPACK cfftf: unscaled forward complex FFT (float64)."""

    return _cfft_rec(np.asarray(x, dtype=np.complex128), -1)


def cfftb(x) -> np.ndarray:
    """FFTPACK cfftb: unscaled backward; cfftb(cfftf(x)) == N*x."""

    return _cfft_rec(np.asarray(x, dtype=np.complex128), +1)


# ---------------------------------------------------------------------------
# Real transforms (FFTPACK packing)
# ---------------------------------------------------------------------------


def rfftf(x) -> np.ndarray:
    """FFTPACK rfftf: [..., N] real -> [..., N] packed
    [r0, r1, i1, ..., rN/2] (N even) / [r0, r1, i1, ...] (N odd)."""

    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    spec = cfftf(x.astype(np.complex128))[..., : n // 2 + 1]
    out = np.empty_like(x)
    out[..., 0] = spec[..., 0].real
    if n % 2 == 0:
        out[..., 1:-1:2] = spec[..., 1:-1].real
        out[..., 2::2] = spec[..., 1:-1].imag
        out[..., -1] = spec[..., -1].real
    else:
        out[..., 1::2] = spec[..., 1:].real
        out[..., 2::2] = spec[..., 1:].imag
    return out


def rfftb(p) -> np.ndarray:
    """FFTPACK rfftb: unscaled inverse of rfftf (returns N * x)."""

    p = np.asarray(p, dtype=np.float64)
    n = p.shape[-1]
    h = n // 2 + 1
    spec = np.zeros((*p.shape[:-1], n), dtype=np.complex128)
    spec[..., 0] = p[..., 0]
    if n % 2 == 0:
        spec[..., 1 : h - 1] = p[..., 1:-1:2] + 1j * p[..., 2::2]
        spec[..., h - 1] = p[..., -1]
    else:
        spec[..., 1:h] = p[..., 1::2] + 1j * p[..., 2::2]
    # hermitian mirror
    spec[..., h:] = np.conj(spec[..., 1 : n - h + 1][..., ::-1])
    return cfftb(spec).real


def packed_spectrum(x) -> np.ndarray:
    """Real input -> pffft packed complex spectrum [..., N/2]
    (bin0 = F(0) + i F(N/2), pffft.h:144-155) — the oracle for
    pffft_tpu_torch.rfft_packed."""

    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    spec = cfftf(x.astype(np.complex128))[..., : n // 2 + 1]
    out = spec[..., :-1].copy()
    out[..., 0] = spec[..., 0].real + 1j * spec[..., -1].real
    return out


def unpacked_spectrum(x) -> np.ndarray:
    """Real input -> standard rfft layout [..., N/2+1] (numpy convention)."""

    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    return cfftf(x.astype(np.complex128))[..., : n // 2 + 1]


# ---------------------------------------------------------------------------
# DCT / DST families (FFTPACK cost/sint/cosq/sinq surface)
# ---------------------------------------------------------------------------


def dct1(x) -> np.ndarray:
    """DCT-I, FFTPACK 'cost' convention (unnormalized, self-inverse up to
    2*(N-1)): X[k] = x[0] + (-1)^k x[N-1] + 2 sum_{j=1}^{N-2} x[j] cos(pi j k/(N-1))."""

    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    # even extension of length 2(N-1), via complex FFT
    ext = np.concatenate([x, x[..., -2:0:-1]], axis=-1)
    return cfftf(ext)[..., :n].real


def dst1(x) -> np.ndarray:
    """DST-I, FFTPACK 'sint' convention:
    X[k] = 2 sum_{j=0}^{N-1} x[j] sin(pi (j+1)(k+1)/(N+1))."""

    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    z = np.zeros((*x.shape[:-1], 2 * (n + 1)), dtype=np.float64)
    z[..., 1 : n + 1] = x
    z[..., n + 2 :] = -x[..., ::-1]
    return -cfftf(z)[..., 1 : n + 1].imag


def dct2(x) -> np.ndarray:
    """DCT-II (FFTPACK cosqb's transpose family):
    X[k] = 2 sum_j x[j] cos(pi k (2j+1) / (2N))."""

    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    z = np.zeros((*x.shape[:-1], 4 * n), dtype=np.float64)
    z[..., 1:2 * n:2] = x
    z[..., 2 * n + 1 :: 2] = x[..., ::-1]
    return cfftf(z)[..., :n].real


def dct3(x) -> np.ndarray:
    """DCT-III: X[k] = x[0] + 2 sum_{j>=1} x[j] cos(pi j (2k+1) / (2N)).
    Inverse pair: dct3(dct2(x)) == 2N * x."""

    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    j = np.arange(n)
    k = np.arange(n)
    c = np.cos(np.pi * np.outer(2 * k + 1, j) / (2 * n))
    return x[..., 0:1] * 1.0 + 2.0 * np.einsum("...j,kj->...k", x[..., 1:], c[:, 1:]) \
        if n > 1 else x.copy()


def dst2(x) -> np.ndarray:
    """DST-II: X[k] = 2 sum_j x[j] sin(pi (k+1)(2j+1) / (2N))."""

    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    j = np.arange(n)
    k = np.arange(n)
    s = np.sin(np.pi * np.outer(k + 1, 2 * j + 1) / (2 * n))
    return 2.0 * np.einsum("...j,kj->...k", x, s)


def dst3(x) -> np.ndarray:
    """DST-III: X[k] = (-1)^k x[N-1] + 2 sum_{j<N-1} x[j] sin(pi (j+1)(2k+1)/(2N)).
    Inverse pair: dst3(dst2(x)) == 2N * x."""

    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    j = np.arange(n - 1)
    k = np.arange(n)
    s = np.sin(np.pi * np.outer(2 * k + 1, j + 1) / (2 * n))
    sgn = (-1.0) ** k
    return sgn * x[..., -1:] + 2.0 * np.einsum("...j,kj->...k", x[..., :-1], s) \
        if n > 1 else x.copy()


# FFTPACK names (fftpack.h:72-86).  Conventions cross-validated against
# scipy.fftpack and the FFTPACK docs (fftpack.h): cosqf == DCT-III and
# sinqf == DST-III exactly, but the *backward* quarter-wave transforms
# carry FFTPACK's factor 4 (x(i) = sum 4*x(k)*cos(...), so that
# cosqb(cosqf(x)) == 4n*x, not the 2n of plain DCT-II o DCT-III).
cost = dct1
sint = dst1
cosqf = dct3   # quarter-wave forward


def cosqb(x) -> np.ndarray:
    """FFTPACK cosqb: X[k] = 4 sum_j x[j] cos(pi (2j+1) k / (2N)) = 2*DCT-II.
    cosqb(cosqf(x)) == 4N * x (fftpack.h cosqb doc)."""

    return 2.0 * dct2(x)


sinqf = dst3


def sinqb(x) -> np.ndarray:
    """FFTPACK sinqb: X[k] = 4 sum_j x[j] sin(pi (2j+1)(k+1)/(2N)) = 2*DST-II.
    sinqb(sinqf(x)) == 4N * x (fftpack.h sinqb doc)."""

    return 2.0 * dst2(x)
