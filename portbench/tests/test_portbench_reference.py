"""Each plain reference against a direct float64 sum, across chunks and a stream wrap."""

import numpy as np
import pytest
import torch

from portbench.reference import fastconv_fir as fir
from portbench.reference import pfb_channelizer as pfb
from portbench.reference import tf32


def direct_fir(base: np.ndarray, h: np.ndarray, start: int, n: int) -> np.ndarray:
    s, f = base.shape[-1], len(h)
    y = np.zeros((base.shape[0], n))
    for i in range(n):
        for j in range(f):
            y[:, i] += base[:, (start + i + j) % s] * h[f - 1 - j]
    return y


def test_pffastconv_counts_by_hand():
    # F = 1024: nfft = 2 * next_pow2(1023) = 2048, u = 1025; a first chunk of
    # 2^22: ceil((4194304 - 2047) / 1025) = 4091 blocks
    assert fir.block_len(1024) == 2048 and fir.block_len(4096) == 8192
    assert fir.block_len(17) == 32 and fir.block_len(18) == 64
    assert fir.consumed(4194304, 1024) == 4091 * 1025 == 4193275
    assert fir.consumed(2047, 1024) == 0 and fir.consumed(2048, 1024) == 1025
    # F = 4096: u = 4097, ceil((4194304 - 8191) / 4097) = 1022 blocks
    assert fir.consumed(4194304, 4096) == 1022 * 4097
    sched = fir.schedule(3, 4194304, 1024)
    assert sched[0] == (0, 4194304, 4193275)
    assert sched[1] == (4193275, 4194304 + 1029, fir.consumed(4194304 + 1029, 1024))


def test_fir_reference_across_chunks_and_the_wrap():
    rng = np.random.default_rng(5)
    base = rng.standard_normal((2, 96)).astype(np.float32)
    h = rng.standard_normal(5)
    chunk = 40  # nfft 32, u 28: tails carried, and the stream wraps at 96
    sched = fir.schedule(8, chunk, len(h))
    assert sched[-1][0] + sched[-1][2] > 2 * 96
    bt = torch.from_numpy(base)
    for start, length, n in sched:
        assert 0 <= length - n < fir.block_len(len(h))
        got = fir.expected(bt, h, start, n).numpy()
        want = direct_fir(base.astype(np.float64), h, start, n)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_fir_control_is_the_reference_on_tf32_operands():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 70)).astype(np.float32))
    h = rng.standard_normal(5)
    got = fir.control(x, h)
    h32 = tf32(torch.from_numpy(h.astype(np.float32))).double().numpy()
    want = direct_fir(tf32(x).double().numpy(), h32, 0, fir.consumed(70, 5))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert float((got.double() - torch.from_numpy(direct_fir(x.double().numpy(), h, 0,
                                                               got.shape[-1]))).abs().max()) > 0


def direct_pfb(base: np.ndarray, w: np.ndarray, frames: int, chunk: int) -> np.ndarray:
    p, m = w.shape
    s = base.shape[-1]
    y = np.zeros((base.shape[0], frames, m), dtype=np.complex128)
    for k in range(frames):
        g = chunk * frames + k
        for c in range(m):
            acc = np.zeros(base.shape[0], dtype=np.complex128)
            for sb in range(p):
                for phi in range(m):
                    i = (g - sb) * m - phi
                    if i >= 0:
                        acc += w[sb, phi] * base[:, i % s] * np.exp(2j * np.pi * c * phi / m)
            y[:, k, c] = acc
    return y


def test_channelizer_reference_across_chunks_and_the_wrap():
    rng = np.random.default_rng(7)
    m, p, frames = 8, 3, 4
    base = (rng.standard_normal((2, 96)) + 1j * rng.standard_normal((2, 96))).astype(np.complex64)
    w = rng.standard_normal((p, m))
    re, im = (torch.from_numpy(np.ascontiguousarray(a)) for a in (base.real, base.imag))
    for chunk in range(5):  # 96 = 3 chunks of 32: chunks 3 and 4 wrap
        got = pfb.expected(re, im, w, frames, chunk).numpy()
        want = direct_pfb(base.astype(np.complex128), w, frames, chunk)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_channelizer_control_carries_the_history(chunk):
    rng = np.random.default_rng(8)
    m, p, frames = 8, 3, 4
    re = torch.from_numpy(rng.standard_normal((2, 96)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((2, 96)).astype(np.float32))
    w = rng.standard_normal((p, m))
    state = (torch.zeros(2, p * m), torch.zeros(2, p * m))
    for c in range(chunk + 1):
        a = c * frames * m % 96
        (yr, yi), state = pfb.control(state, re[:, a:a + frames * m], im[:, a:a + frames * m], w)
    ref = pfb.expected(re, im, w, frames, chunk)
    err = max(float((yr.double() - ref.real).abs().max()), float((yi.double() - ref.imag).abs().max()))
    scale = float(ref.abs().max())
    assert 1e-6 * scale < err < 1e-2 * scale  # TF32's rounding, nothing worse
