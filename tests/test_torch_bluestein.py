"""The port's any-length transforms, pffft_tpu_torch.bluestein, against
pffft_tpu.bluestein on the same seeded numpy inputs: Bluestein plans in
both directions, the real any-N transforms, the CZT and the spectral zoom;
the chirp and CZT tables bit for bit, the kernel spectra after reordering
the reference's internal layout, and the port's inner-length rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu import bluestein as rbs
import pffft_tpu_torch as pt
from pffft_tpu_torch import bluestein as tbs
from pffft_tpu_torch.ops import dispatch as D

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-5       # f32, relative to max|ref|: both sides f32, other engines
TOL64 = 1e-12    # f64, the reference's own tolerance (tests/test_bluestein.py)


def _rand_c(shape, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _both(n, dtype="float32"):
    """The port's plan and the reference's at the port's inner length."""

    tp = tbs.BluesteinPlan(n, dtype)
    return tp, rbs.BluesteinPlan(n, dtype, m=tp.m)


# ---------------------------------------------------------------------------
# Bluestein plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 7, 17, 31, 97, 105, 241, 997, 4099])
def test_forward_and_backward_match_reference(n):
    tp = tbs.BluesteinPlan(n)
    rp = rbs.BluesteinPlan(n)
    x = _rand_c((4, n), n)
    for td, rd in ((pt.FORWARD, pf.FORWARD), (pt.BACKWARD, pf.BACKWARD)):
        want = np.asarray(pf.transform_ordered(rp, jnp.asarray(x), rd))
        got = pt.transform_ordered(tp, x, td, device=CPU)
        assert got.dtype == torch.complex64 and got.shape == (4, n)
        assert _rel(got, want) <= TOL, td


@pytest.mark.parametrize("n", [13, 101, 1009])
def test_float64_matches_reference(n):
    tp, rp = tbs.BluesteinPlan(n, "float64"), rbs.BluesteinPlan(n, "float64")
    assert tp.m == rp.m  # float64 plans keep the reference's inner length
    x = _rand_c((2, n), n, np.complex128)
    for td, rd in ((pt.FORWARD, pf.FORWARD), (pt.BACKWARD, pf.BACKWARD)):
        want = np.asarray(pf.transform_ordered(rp, jnp.asarray(x), rd))
        got = pt.transform_ordered(tp, x, td, device=CPU)
        assert got.dtype == torch.complex128
        assert _rel(got, want) <= TOL64
    assert _rel(pt.transform_ordered(tp, x, device=CPU), np.fft.fft(x, axis=-1)) <= TOL64


@pytest.mark.parametrize("n", [5, 19, 129, 677])
def test_roundtrip_unscaled(n):
    p = tbs.BluesteinPlan(n)
    x = torch.from_numpy(_rand_c((3, n), n))
    keep = x.clone()
    back = pt.transform_ordered(p, pt.transform_ordered(p, x), pt.BACKWARD)
    assert (back / n - x).abs().max() < 2e-6 * max(1.0, float(x.abs().max()))
    assert torch.equal(x, keep)


def test_split_planar_path():
    n = 37
    tp, rp = tbs.BluesteinPlan(n), rbs.BluesteinPlan(n)
    x = _rand_c((2, 3, n), 37)
    want = pf.transform_ordered_split(rp, (jnp.asarray(x.real), jnp.asarray(x.imag)))
    gr, gi = pt.transform_ordered_split(tp, (x.real, x.imag), device=CPU)
    assert gr.dtype == torch.float32 and gr.shape == (2, 3, n)
    scale = np.abs(np.asarray(want[0]) + 1j * np.asarray(want[1])).max()
    for g, w in zip((gr, gi), want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= TOL * scale
    # the split module entry point is the same call
    hr, hi = tbs.transform_any_split(tp, (x.real, x.imag), device=CPU)
    assert torch.equal(hr, gr) and torch.equal(hi, gi)


@pytest.mark.parametrize("n,dtype", [(7, np.float32), (97, np.float32), (4099, np.float32),
                                     (1009, np.float64)])
def test_chirp_tables_equal_reference_bit_for_bit(n, dtype):
    m = tbs.next_smooth_size(2 * n - 1)
    for t, r in zip(tbs._chirp_tables(n, m, dtype), rbs._chirp_tables(n, m, dtype)):
        assert t.dtype == r.dtype
        np.testing.assert_array_equal(t, r)
    tp, rp = _both(n, np.dtype(dtype).name)
    for t, r in zip(tp._chirp, rp._chirp):
        np.testing.assert_array_equal(t, np.asarray(r))


@pytest.mark.parametrize("n", [17, 97, 4099])
def test_kernel_spectrum_matches_reference_after_reorder(n):
    """The port keeps the kernel spectrum in canonical order; the
    reference's is in its inner plan's internal order."""

    tp, rp = _both(n)
    bh = np.asarray(rp._bhat[0]) + 1j * np.asarray(rp._bhat[1])
    want = np.asarray(pf.zreorder(rp.inner, jnp.asarray(bh.astype(np.complex64)), pf.FORWARD))
    got = tp._bhat[0] + 1j * tp._bhat[1]
    assert tp._bhat[0].dtype == np.float32
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_inner_length_rule():
    # where both rules agree the port's M is the reference's
    for n in (97, 4099):
        assert tbs.BluesteinPlan(n).m == rbs.BluesteinPlan(n).m
    assert tbs.BluesteinPlan(4099).m == 8640
    # N = 12289: the reference's smallest smooth M (25000) has no kernel
    # route; the port takes 25600 = 1600 * 16, which kern2 runs
    assert rbs.BluesteinPlan(12289).m == 25000
    assert tbs.BluesteinPlan(12289).m == 25600
    for n in (12289, 16411, 30011, 4099, 1000):
        m = tbs.kernel_smooth_size(2 * n - 1)
        assert m >= 2 * n - 1 and m >= rbs.next_smooth_size(2 * n - 1)
        pt.decompose_smooth(m)
        engines = D.available_engines(pt.new_setup(m, strict=False), 1, False)
        assert {"fused2", "tmajor"} & set(engines), (n, m, engines)
    # past every kernel length (65536) the rule falls back to the smallest
    # smooth M: N = 32771 gets the reference's 65610
    assert tbs.BluesteinPlan(32771).m == rbs.BluesteinPlan(32771).m == 65610


def test_transform_at_a_kernel_length_the_reference_does_not_pick():
    n = 12289
    tp = tbs.BluesteinPlan(n)
    x = _rand_c((2, n), n)
    want = np.asarray(pf.transform_ordered(rbs.BluesteinPlan(n), jnp.asarray(x)))
    assert _rel(pt.transform_ordered(tp, x, device=CPU), want) <= TOL


def test_new_setup_any_dispatch_and_caching():
    assert isinstance(pt.new_setup_any(100), pt.Plan)
    assert isinstance(pt.new_setup_any(1024), pt.Plan)
    assert isinstance(pt.new_setup_any(101), pt.BluesteinPlan)
    assert isinstance(pt.new_setup_any(2 * 3 * 7), pt.BluesteinPlan)
    assert isinstance(pt.new_setup_any(96, pt.REAL), pt.Plan)
    with pytest.raises(ValueError, match="rfft_any") as te:
        pt.new_setup_any(101, pt.REAL)
    with pytest.raises(ValueError) as rf:
        pf.new_setup_any(101, pf.REAL)
    assert str(te.value) == str(rf.value)
    a = pt.new_setup_any(101)
    assert a is pt.new_setup_any(101)
    b = pt.new_setup_any(101, m=540)
    assert isinstance(b, pt.BluesteinPlan) and b.m == 540 and b is not a
    x = _rand_c((2, 101), 5)
    ga = pt.transform_ordered(a, x, device=CPU)
    gb = pt.transform_ordered(b, x, device=CPU)
    assert _rel(gb, ga.numpy()) < TOL
    want = np.asarray(pf.transform_ordered(pf.new_setup_any(101, m=540), jnp.asarray(x)))
    assert _rel(gb, want) <= TOL


def test_next_smooth_size_matches_reference():
    for n in (1, 2, 7, 11, 97, 1000, 2048, 4097, 8197):
        assert tbs.next_smooth_size(n) == rbs.next_smooth_size(n)


@pytest.mark.parametrize("n", [8, 9, 34, 101, 240, 96, 4096])
def test_rfft_any_matches_reference(n):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    want = np.asarray(pf.rfft_any(x))
    got = pt.rfft_any(x, device=CPU)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= TOL
    assert _rel(got, np.fft.rfft(x.astype(np.float64), axis=-1)) <= TOL


@pytest.mark.parametrize("n", [10, 33, 101, 96])
def test_irfft_any_matches_reference(n):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    s = np.fft.rfft(x, axis=-1).astype(np.complex64)
    want = np.asarray(pf.irfft_any(jnp.asarray(s), n))
    got = pt.irfft_any(s, n, device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= TOL
    back = pt.irfft_any(pt.rfft_any(x, device=CPU), n) / n
    assert (back - torch.from_numpy(x)).abs().max() < 2e-6


def test_real_any_float64_and_length_one():
    x = np.random.default_rng(3).standard_normal((2, 101))
    got = pt.rfft_any(x, "float64", device=CPU)
    assert got.dtype == torch.complex128
    assert _rel(got, np.asarray(pf.rfft_any(x, "float64"))) <= TOL64
    back = pt.irfft_any(got, 101, "float64")
    assert _rel(back, np.asarray(pf.irfft_any(pf.rfft_any(x, "float64"), 101, "float64"))) <= TOL64
    one = np.array([[3.0], [2.5]], np.float32)
    g = pt.rfft_any(one, device=CPU)
    assert g.shape == (2, 1) and np.abs(g.numpy() - one).max() == 0
    assert np.abs(pt.irfft_any(g, 1).numpy() - one).max() == 0


def test_error_paths_match_reference():
    cases = [
        (lambda m: m.BluesteinPlan(1), ValueError),
        (lambda m: m.BluesteinPlan(17, m=20), ValueError),
        (lambda m: m.BluesteinPlan(17, m=37), ValueError),
        (lambda m: m.BluesteinPlan(1 << 26), ValueError),
        (lambda m: m.BluesteinPlan(17, "int32"), ValueError),
    ]
    for make, exc in cases:
        with pytest.raises(exc) as te:
            make(tbs)
        with pytest.raises(exc) as rf:
            make(rbs)
        assert str(te.value) == str(rf.value)
    z = np.zeros((2, 16), np.float32)
    with pytest.raises(ValueError, match="last axis") as te:
        pt.transform_ordered_split(tbs.BluesteinPlan(17), (z, z), device=CPU)
    with pytest.raises(ValueError) as rf:
        pf.transform_ordered_split(rbs.BluesteinPlan(17), (jnp.asarray(z), jnp.asarray(z)))
    assert str(te.value) == str(rf.value)
    with pytest.raises(ValueError, match="expected") as te:
        pt.irfft_any(np.zeros(5, np.complex64), 12, device=CPU)
    with pytest.raises(ValueError) as rf:
        pf.irfft_any(jnp.zeros(5, jnp.complex64), 12)
    assert str(te.value) == str(rf.value)


def test_tone_detection_prime_n():
    n, k = 499, 123
    x = np.exp(2j * np.pi * k * np.arange(n) / n).astype(np.complex64)
    spec = pt.transform_ordered(tbs.BluesteinPlan(n), x, device=CPU).abs().numpy()
    assert spec.argmax() == k
    assert np.delete(spec, k).max() < spec[k] * 1e-5


def test_foreign_plan_types_raise_reference_text():
    x = np.ones(8, np.complex64)
    for call, rcall in ((pt.transform_ordered, pf.transform_ordered),
                        (pt.transform_ordered_split, pf.transform_ordered_split)):
        arg = x if call is pt.transform_ordered else (x.real, x.imag)
        rarg = jnp.asarray(x) if call is pt.transform_ordered else (
            jnp.asarray(x.real), jnp.asarray(x.imag))
        with pytest.raises(TypeError, match="CztPlan") as te:
            call(tbs.CztPlan(8), arg, device=CPU)
        with pytest.raises(TypeError) as rf:
            rcall(rbs.CztPlan(8), rarg)
        assert str(te.value) == str(rf.value)


# ---------------------------------------------------------------------------
# CZT and the spectral zoom
# ---------------------------------------------------------------------------


def test_exact_phase_helper_matches_reference():
    idx = [0, 1, 2, 7, 16, 10 ** 9 + 1, 12345678901]
    for scale in (0.375, 0.013, 1.0 / 4096, -0.083):
        np.testing.assert_array_equal(tbs._exact_phase_mod2(scale, idx),
                                      rbs._exact_phase_mod2(scale, idx))
    assert tbs._exact_phase_mod2(0.375, [0, 1, 2, 7, 16, 10 ** 9 + 1]).tolist() == [
        0.0, 0.375, 0.75, 0.625, 0.0, 0.375]


@pytest.mark.parametrize("n,m,wp,ap,dtype", [
    (53, 29, 0.013, 0.21, "float32"),
    (4096, 512, 0.1 / 512 / 2, 0.1, "float32"),
    (100, 57, 0.0061, -0.083, "float64"),
])
def test_czt_tables_match_reference(n, m, wp, ap, dtype):
    tp = tbs.CztPlan(n, m, w_phase=wp, a_phase=ap, dtype=dtype)
    rp = rbs.CztPlan(n, m, w_phase=wp, a_phase=ap, dtype=dtype)
    for t, r in zip(tp._pre + tp._post, rp._pre + rp._post):
        assert t.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(t, np.asarray(r))
    if tp.m == rp.m:
        vh = np.asarray(rp._vhat[0]) + 1j * np.asarray(rp._vhat[1])
        want = np.asarray(pf.zreorder(rp.inner, jnp.asarray(vh), pf.FORWARD))
        got = tp._vhat[0] + 1j * tp._vhat[1]
        tol = TOL if dtype == "float32" else TOL64
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("n,m,wp,ap", [(37, None, None, 0.0), (53, 29, 0.013, 0.21),
                                       (96, 384, 1.0 / 384, 0.0), (1, 5, 0.1, 0.0)])
def test_czt_matches_reference_f32(n, m, wp, ap):
    tp = tbs.CztPlan(n, m, w_phase=wp, a_phase=ap)
    rp = rbs.CztPlan(n, m, w_phase=wp, a_phase=ap)
    x = _rand_c((3, n), n)
    got = pt.czt(tp, x, device=CPU)
    want = np.asarray(rbs.czt(rp, jnp.asarray(x)))
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= TOL
    gr, gi = pt.czt_split(tp, (x.real, x.imag), device=CPU)
    assert torch.equal(torch.complex(gr, gi), got)


def test_czt_general_vs_reference_and_direct_sum_f64():
    n, m, wp, ap = 53, 29, 0.013, 0.21
    x = _rand_c((3, n), 11, np.complex128)
    tp = tbs.CztPlan(n, m, w_phase=wp, a_phase=ap, dtype="float64")
    got = pt.czt(tp, x, device=CPU)
    want = np.asarray(rbs.czt(rbs.CztPlan(n, m, w_phase=wp, a_phase=ap, dtype="float64"),
                              jnp.asarray(x)))
    assert got.dtype == torch.complex128 and _rel(got, want) <= TOL64
    j, k = np.arange(n), np.arange(m)
    mat = (np.exp(2j * np.pi * ap) ** (-j))[None, :] * (np.exp(-2j * np.pi * wp) ** np.outer(k, j))
    assert _rel(got, x @ mat.T) <= TOL64


@pytest.mark.parametrize("endpoint", [False, True])
@pytest.mark.parametrize("fn", [0.31, (0.25, 0.40)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_zoom_fft_matches_reference(fn, endpoint, dtype):
    x = np.random.default_rng(640).standard_normal(640)
    if dtype == "float32":
        x = x.astype(np.float32)
    got = pt.zoom_fft(x, fn, 333, fs=2.0, endpoint=endpoint, dtype=dtype, device=CPU)
    want = np.asarray(pf.zoom_fft(x, fn, 333, fs=2.0, endpoint=endpoint, dtype=dtype))
    assert _rel(got, want) <= (TOL if dtype == "float32" else TOL64)


def test_zoom_setup_and_cache():
    tp = tbs.zoom_fft_setup(4096, (0.2, 0.3), 512)
    rp = rbs.zoom_fft_setup(4096, (0.2, 0.3), 512)
    assert (tp.n, tp.m_out, tp.w_phase, tp.a_phase, tp.m) == (
        rp.n, rp.m_out, rp.w_phase, rp.a_phase, rp.m) == (4096, 512, rp.w_phase, 0.1, 4608)
    assert tbs._zoom_cached(64, 0.5, None, 2.0, False, "float32") is tbs._zoom_cached(
        64, 0.5, None, 2.0, False, "float32")


def test_czt_error_paths_match_reference():
    for args in ((0,), (4, 0)):
        with pytest.raises(ValueError) as te:
            tbs.CztPlan(*args)
        with pytest.raises(ValueError) as rf:
            rbs.CztPlan(*args)
        assert str(te.value) == str(rf.value)
    z = np.zeros((2, 15), np.float32)
    with pytest.raises(ValueError, match="last axis") as te:
        pt.czt_split(tbs.CztPlan(16, 8), (z, z), device=CPU)
    with pytest.raises(ValueError) as rf:
        rbs.czt_split(rbs.CztPlan(16, 8), (jnp.asarray(z), jnp.asarray(z)))
    assert str(te.value) == str(rf.value)


def test_device_tables_are_cached_per_device():
    p = tbs.BluesteinPlan(97)
    x = torch.zeros((1, 97))
    pt.transform_ordered_split(p, (x, x))
    tabs = p._device_tables(torch.device(CPU), False)
    assert p._device_tables(torch.device(CPU), False) is tabs
    # backward conjugates every table
    bwd = p._device_tables(torch.device(CPU), True)
    for f, b in zip(tabs, bwd):
        assert torch.equal(f[0], b[0]) and torch.equal(f[1], -b[1])
