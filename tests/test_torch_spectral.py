"""The port's STFT front end and resampler, pffft_tpu_torch.spectral and
pffft_tpu_torch.resample, against pffft_tpu.spectral and pffft_tpu.resample
on the same seeded numpy inputs.  Both STFT routes of the port (time-major
and batch-major) are held to the reference's STFT."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pffft_tpu import resample as rrs
from pffft_tpu import spectral as rsp
import pffft_tpu_torch as pt
from pffft_tpu_torch import resample as trs
from pffft_tpu_torch import spectral as tsp

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
# relative to max|ref|: f32 transforms on both sides, through other engines
TOL = 1e-5
WINDOWS = ["hann", "hamming", "blackman", "blackmanharris", "flattop", "kaiser", "boxcar",
           "rect", ("kaiser", 5.0)]


def _rel(got, ref):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _signal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(params=[False, True], ids=["bmajor", "tmajor"])
def route(request, monkeypatch):
    """The port's STFT route, forced."""

    monkeypatch.setattr(tsp, "_TMAJOR_STFT", request.param)
    return request.param


# ---------------------------------------------------------------------------
# Windows and framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", WINDOWS)
@pytest.mark.parametrize("n", [64, 255])
def test_windows_match_reference(name, n):
    for dtype in (np.float32, np.float64):
        want = rsp.get_window(name, n, dtype)
        got = tsp.get_window(name, n, dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for fn in ("hann", "hamming", "blackman", "blackmanharris", "flattop", "kaiser"):
        np.testing.assert_array_equal(getattr(tsp, fn)(n), getattr(rsp, fn)(n))


def test_window_errors_and_coercion():
    with pytest.raises(ValueError, match="unknown window"):
        tsp.get_window("nope", 16)
    with pytest.raises(ValueError, match="parameterized"):
        tsp.get_window(("tukey", 0.5), 16)
    for w in (None, "blackman", ("kaiser", 7.0), np.linspace(0, 1, 32)):
        np.testing.assert_array_equal(tsp._coerce_window(w, 32), rsp._coerce_window(w, 32))


@pytest.mark.parametrize("n,hop", [(64, 16), (64, 48), (128, 128), (96, 32), (32, 40)])
def test_frame_signal_matches_reference(n, hop):
    x = _signal((2, 1000), n + hop)
    want = np.asarray(rsp.frame_signal(jnp.asarray(x), n, hop))
    got = tsp.frame_signal(x, n, hop, device=CPU)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="frame_len"):
        tsp.frame_signal(x, 2000, hop, device=CPU)


# ---------------------------------------------------------------------------
# STFT
# ---------------------------------------------------------------------------

STFT_CASES = [
    ((4000,), 256, 128, None),
    ((3, 2100), 128, 64, "hamming"),
    ((2, 2, 1500), 64, 64, "blackman"),
    ((1337,), 96, 48, ("kaiser", 6.0)),
    ((2, 4096), 512, 128, "blackmanharris"),
    ((20000,), 8192, 4096, None),
]


@pytest.mark.parametrize("shape,n_fft,hop,window", STFT_CASES)
def test_stft_split_matches_reference(route, shape, n_fft, hop, window):
    x = _signal(shape, n_fft + hop)
    wr, wi = rsp.stft_split(jnp.asarray(x), n_fft, hop, window)
    gr, gi = tsp.stft_split(x, n_fft, hop, window, device=CPU)
    assert gr.shape == wr.shape and gi.shape == wi.shape
    scale = max(np.abs(np.asarray(wr)).max(), np.abs(np.asarray(wi)).max())
    err = max(np.abs(gr.numpy() - np.asarray(wr)).max(), np.abs(gi.numpy() - np.asarray(wi)).max())
    assert err <= TOL * scale
    want = rsp.stft(jnp.asarray(x), n_fft, hop, window)
    got = tsp.stft(torch.from_numpy(x), n_fft, hop, window)
    assert got.dtype == torch.complex64 and _rel(got, want) <= TOL


@pytest.mark.parametrize("shape,n_fft,hop,window", STFT_CASES[:4])
def test_stft_split_tmajor_matches_reference(shape, n_fft, hop, window):
    x = _signal(shape, n_fft)
    wr, wi = rsp.stft_split_tmajor(jnp.asarray(x), n_fft, hop, window)
    gr, gi = tsp.stft_split_tmajor(x, n_fft, hop, window, device=CPU)
    assert gr.shape == wr.shape == (n_fft // 2, *shape[:-1], (shape[-1] - n_fft) // hop + 1)
    assert max(_rel(gr, wr), _rel(gi, wi)) <= TOL


@pytest.mark.parametrize("n_fft,hop,window", [(128, 32, None), (512, 128, "hamming"),
                                              (512, 128, "blackmanharris"), (96, 48, "hann")])
def test_istft_matches_reference(n_fft, hop, window):
    x = _signal((2, 4096), n_fft + 1)
    w = None if window is None else rsp.get_window(window, n_fft)
    s = np.asarray(rsp.stft(jnp.asarray(x), n_fft, hop, w))
    want = np.asarray(rsp.istft(jnp.asarray(s), hop, w, length=4000))
    got = tsp.istft(s, hop, w, length=4000, device=CPU).numpy()
    assert got.shape == want.shape
    # where a window's square is near 0 (the first samples under a Hann
    # window) the normalization divides both sides' rounding by it; so the
    # whole output is compared as the overlap-add sum (times the sum of
    # squared windows), and the interior as it is
    wv = tsp._coerce_window(w, n_fft).astype(np.float64) ** 2
    wsq = np.zeros(4096 + n_fft)
    for i in range((4096 - n_fft) // hop + 1):
        wsq[i * hop : i * hop + n_fft] += wv
    assert _rel(got * wsq[:4000], want * wsq[:4000]) <= TOL
    assert _rel(got[..., n_fft:-n_fft], want[..., n_fft:-n_fft]) <= TOL
    # the round trip through the port alone: the interior is reconstructed
    y = tsp.istft(tsp.stft(x, n_fft, hop, w, device=CPU), hop, w)
    core = slice(n_fft, y.shape[-1] - n_fft)
    assert np.abs(y[..., core].numpy() - x[..., core]).max() <= 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("n_fft,hop,window", [(256, None, None), (512, 128, ("kaiser", 10.0)),
                                              (128, 64, "flattop")])
def test_welch_and_spectrogram_match_reference(route, n_fft, hop, window):
    x = _signal((2, 8192), n_fft)
    assert _rel(tsp.welch_psd(x, n_fft, hop, window, device=CPU),
                rsp.welch_psd(jnp.asarray(x), n_fft, hop, window)) <= TOL
    h = hop or n_fft // 2
    assert _rel(tsp.spectrogram(x, n_fft, h, window, device=CPU),
                rsp.spectrogram(jnp.asarray(x), n_fft, h, window)) <= TOL


def test_stft_auto_route_is_batch_major(monkeypatch):
    """Auto (None) takes the batch-major composition: the pack copy, the
    half-length transform and the batch-major split step."""

    assert tsp._TMAJOR_STFT is None
    calls = []
    monkeypatch.setattr(tsp._fft, "transform_ordered_split",
                        lambda *a, **k: calls.append(1) or (torch.zeros(1), torch.zeros(1)))
    tsp.stft_split(_signal(600, 1), 128, 64, device=CPU)
    assert calls == [1]
    assert pt.spectral is tsp and pt.resample is trs
    assert sorted(tsp.__all__) == sorted(rsp.__all__)


# ---------------------------------------------------------------------------
# Resampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l,m", [(3, 2), (2, 3), (5, 4), (1, 4), (4, 1), (7, 5), (4, 6)])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_resampler_matches_reference(l, m, lead):
    x = _signal((*lead, 700), l * 10 + m)
    rr = rrs.Resampler(l, m, taps_per_phase=8)
    tr = trs.Resampler(l, m, taps_per_phase=8, device=CPU)
    assert (tr.up, tr.down, tr.p) == (rr.up, rr.down, rr.p)
    np.testing.assert_array_equal(tr._bank, np.asarray(rr._bank))
    np.testing.assert_array_equal(tr.taps_rev, np.asarray(rr.taps_rev))
    want = rr(jnp.asarray(x))
    got = tr(x)
    assert got.shape == want.shape and _rel(got, want) <= TOL


def test_resampler_prototype_and_one_shot():
    rng = np.random.default_rng(5)
    proto = rng.standard_normal(37)  # not a multiple of L: padded
    x = _signal(1000, 6)
    want = rrs.Resampler(3, 2, prototype=proto)(jnp.asarray(x))
    got = trs.Resampler(3, 2, prototype=proto, device=CPU)(x)
    assert _rel(got, want) <= TOL
    want = rrs.resample(jnp.asarray(x), 3, 7)
    got = trs.resample(torch.from_numpy(x), 3, 7)
    assert got.shape == want.shape == ((1000 * 3) // 7,) and _rel(got, want) <= TOL
