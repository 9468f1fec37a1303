"""Float64 plans in the port against pffft_tpu's on the same numpy inputs:
the complex and real transforms in both layouts, forward and backward, the
complex128 API, the internal order, the 215 dB carrier bound, the engines
a float64 plan may take, and the float64 FastConv.

tests/conftest.py turns JAX's x64 on, so the reference runs its XLA
float64 stage engine on the CPU (its double-float route is TPU-only).  The
port runs its einsum stage engine in float64: every kernel is f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu import conv as rconv
import pffft_tpu_torch as pt
from pffft_tpu_torch import conv as tconv
from pffft_tpu_torch.ops import dispatch as D

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
F64 = "float64"
SIZES = [16, 96, 1024, 2400, 4096]
REAL_SIZES = [32, 192, 2048, 8192]
# relative to max|ref|: two float64 stage engines, rounding in other orders
TOL = 1e-12
# the reference's float64 carrier bound (tests/test_accuracy.py)
CARRIER_DB = 215.0


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, dtype=None):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if dtype is not None:
        assert got.dtype == dtype, got.dtype
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def _pair(p):
    return _np(p[0]) + 1j * _np(p[1])


@pytest.mark.parametrize("n", SIZES)
def test_complex_tmajor_matches_reference(n):
    plan, rplan = pt.new_setup(n, dtype=F64), pf.new_setup(n, dtype=F64)
    z = _cplx((n, 5), n)
    for rdir, tdir in ((pf.FORWARD, pt.FORWARD), (pf.BACKWARD, pt.BACKWARD)):
        want = pf.fft.transform_ordered_split_tmajor(
            rplan, (jnp.asarray(z.real), jnp.asarray(z.imag)), rdir)
        got = pt.transform_ordered_split_tmajor(plan, (z.real, z.imag), tdir, device=CPU)
        assert got[0].dtype == torch.float64
        _close(_pair(got), _pair(want))


@pytest.mark.parametrize("n", SIZES)
def test_complex_bmajor_matches_reference(n):
    plan, rplan = pt.new_setup(n, dtype=F64), pf.new_setup(n, dtype=F64)
    z = _cplx((2, 3, n), n + 1)
    for rdir, tdir in ((pf.FORWARD, pt.FORWARD), (pf.BACKWARD, pt.BACKWARD)):
        want = pf.transform_ordered(rplan, jnp.asarray(z), rdir)
        _close(pt.transform_ordered(plan, z, tdir, device=CPU), want, np.complex128)
        got = pt.transform_ordered_split(plan, (z.real, z.imag), tdir, device=CPU)
        assert got[0].dtype == torch.float64
        _close(_pair(got), want)
    _close(pt.cfft(plan, z, device=CPU), np.fft.fft(z, axis=-1), np.complex128)
    _close(pt.icfft(plan, z, device=CPU), np.fft.ifft(z, axis=-1) * n, np.complex128)


@pytest.mark.parametrize("n", SIZES)
def test_internal_order_matches_reference(n):
    factors = pt.new_setup(n).factors
    plan = pt.new_setup(n, dtype=F64, factors=factors)
    rplan = pf.new_setup(n, dtype=F64, factors=factors)
    z = _cplx((3, n), n + 2)
    want = pf.transform(rplan, jnp.asarray(z), pf.FORWARD)
    got = pt.transform(plan, z, device=CPU)
    _close(got, want, np.complex128)
    _close(pt.zreorder(plan, got), pf.zreorder(rplan, want, pf.FORWARD))
    _close(pt.transform(plan, got, pt.BACKWARD), pf.transform(rplan, want, pf.BACKWARD))
    _close(pt.zconvolve_no_accu(plan, got, got, 0.5),
           pf.zconvolve_no_accu(rplan, want, want, 0.5), np.complex128)


@pytest.mark.parametrize("n", REAL_SIZES)
def test_real_tmajor_matches_reference(n):
    plan, rplan = pt.new_setup(n, pt.REAL, dtype=F64), pf.new_setup(n, pf.REAL, dtype=F64)
    x = _real((n, 5), n)
    want = pf.fft.transform_ordered_split_tmajor(rplan, jnp.asarray(x), pf.FORWARD)
    got = pt.transform_ordered_split_tmajor(plan, x, device=CPU)
    assert got[0].dtype == torch.float64 and got[0].shape == (n // 2, 5)
    _close(_pair(got), _pair(want))
    rback = pf.fft.transform_ordered_split_tmajor(rplan, want, pf.BACKWARD)
    back = pt.transform_ordered_split_tmajor(plan, got, pt.BACKWARD)
    _close(back, rback, np.float64)
    assert np.abs(back.numpy() / n - x).max() <= 1e-13


@pytest.mark.parametrize("n", REAL_SIZES)
def test_real_bmajor_matches_reference(n):
    plan, rplan = pt.new_setup(n, pt.REAL, dtype=F64), pf.new_setup(n, pf.REAL, dtype=F64)
    x = _real((2, 3, n), n + 1)
    want = pf.transform_ordered(rplan, jnp.asarray(x), pf.FORWARD)
    s = pt.rfft_packed(plan, x, device=CPU)
    _close(s, want, np.complex128)
    _close(_pair(pt.transform_ordered_split(plan, x, device=CPU)), want)
    rback = pf.transform_ordered(rplan, want, pf.BACKWARD)
    _close(pt.irfft_packed(plan, s), rback, np.float64)
    split = pt.transform_ordered_split(plan, (s.real, s.imag), pt.BACKWARD)
    _close(split, rback, np.float64)
    # the packed spectrum unpacks to numpy's rfft, and packs back
    _close(pt.spectrum_unpack(s), np.fft.rfft(x, axis=-1), np.complex128)
    _close(pt.spectrum_pack(pt.spectrum_unpack(s)), s, np.complex128)


@pytest.mark.parametrize("n", [32, 2048])
def test_spectrum_helpers_keep_numpy_complex128(n):
    rplan = pf.new_setup(n, pf.REAL, dtype=F64)
    packed = np.asarray(pf.transform_ordered(rplan, jnp.asarray(_real((3, n), n + 3)),
                                             pf.FORWARD))
    assert packed.dtype == np.complex128
    got = pt.spectrum_unpack(packed, device=CPU)
    _close(got, pf.spectrum_unpack(jnp.asarray(packed)), np.complex128)
    _close(pt.spectrum_pack(got.numpy(), device=CPU), packed, np.complex128)
    # complex64 input stays complex64
    assert pt.spectrum_unpack(packed.astype(np.complex64), device=CPU).dtype == torch.complex64


def _carrier_rows(n, cplx):
    """The test_pffft.c carrier sweep as rows (tests/test_accuracy.py)."""

    ks = list(range(0, n if cplx else n // 2 + 1, max(1, n // 16)))
    rows = []
    for j, k in enumerate(ks):
        amp = 1.0 if j % 3 == 0 else 1.1
        freq = (k if k < n / 2 else k - n) / n
        phi = (j % 4) * 0.125 * np.pi + 2.0 * np.pi * freq * np.arange(n, dtype=np.float64)
        rows.append(amp * (np.exp(1j * phi) if cplx else np.cos(phi)))
    return np.stack(rows), ks


def _worst_db(power, ks):
    worst = np.inf
    for j, k in enumerate(ks):
        p = power[j].copy()
        car = p[k]
        p[k] = 0.0
        worst = min(worst, 10.0 * np.log10(car / max(p.max(), 1e-300)))
    return worst


@pytest.mark.parametrize("n", [32, 256, 4096, 65536])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "cplx"])
def test_carrier_dynamic_range(n, cplx):
    x, ks = _carrier_rows(n, cplx)
    plan = pt.new_setup(n, pt.COMPLEX if cplx else pt.REAL, dtype=F64)
    if cplx:
        power = np.abs(pt.transform_ordered(plan, x, device=CPU).numpy()) ** 2
        # and through the time-major planes
        yr, yi = pt.transform_ordered_split_tmajor(plan, (x.real.T, x.imag.T), device=CPU)
        power_t = (yr.numpy() ** 2 + yi.numpy() ** 2).T
    else:
        y = pt.rfft_packed(plan, x, device=CPU).numpy()
        yr, yi = pt.transform_ordered_split_tmajor(plan, x.T.copy(), device=CPU)
        power, power_t = (np.empty((len(ks), n // 2 + 1)) for _ in range(2))
        for p, re, im in ((power, y.real, y.imag), (power_t, yr.numpy().T, yi.numpy().T)):
            p[:, 0], p[:, n // 2] = re[:, 0] ** 2, im[:, 0] ** 2
            p[:, 1:n // 2] = re[:, 1:] ** 2 + im[:, 1:] ** 2
    assert _worst_db(power, ks) >= CARRIER_DB
    assert _worst_db(power_t, ks) >= CARRIER_DB


@pytest.mark.parametrize("kind", [pt.COMPLEX, pt.REAL])
@pytest.mark.parametrize("n", [2048, 4096, 65536])
def test_float64_plans_take_only_the_stage_engine(kind, n):
    plan = pt.new_setup(n, kind, dtype=F64)
    assert D.available_engines(plan, 256) == ("stages",)
    assert D.available_engines(plan, 256, time_major=False) == ("stages",)
    assert D.select_engine(plan, 256) == "stages"
    if plan.is_real:
        for backward in (False, True):
            assert D.real_split_kernel_route(plan, backward) is None
            assert D.real_split_bmajor_route(plan, backward) is None
        assert D.fused_real_fwd_route(plan, 256) is None
        assert D.packed_fwd_route(plan, 256) is None


def test_float64_calls_launch_no_kernel(monkeypatch):
    # every kernel wrapper raises if called: a float64 call reaches none
    from pffft_tpu_torch.ops import conv_kernel, fused_stage, pallas_fft, real_kernel

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called on a float64 plan")

    for mod, name in ((pallas_fft, "cfft_chain_tmajor"), (pallas_fft, "cfft_combine_tmajor"),
                      (pallas_fft, "cfft_chain_tmajor_packed"),
                      (pallas_fft, "rfft_chain_tmajor_fused"),
                      (pallas_fft, "rfft_bwd_chain_tmajor_fused"),
                      (pallas_fft, "real_split_tmajor"), (fused_stage, "cfft_fused2"),
                      (real_kernel, "real_split"), (conv_kernel, "zconv_tmajor"),
                      (conv_kernel, "zconv_stream"),
                      (D, "cfft_ksplit2_tmajor")):
        monkeypatch.setattr(mod, name, refuse)
    n = 2048
    z = _cplx((n, 4), 1)
    pt.transform_ordered_split_tmajor(pt.new_setup(n, dtype=F64), (z.real, z.imag), device=CPU)
    pt.transform_ordered(pt.new_setup(n, dtype=F64), z.T.copy(), device=CPU)
    rplan = pt.new_setup(2 * n, pt.REAL, dtype=F64)
    s = pt.transform_ordered_split_tmajor(rplan, _real((2 * n, 4), 2), device=CPU)
    pt.transform_ordered_split_tmajor(rplan, s, pt.BACKWARD)
    pt.irfft_packed(rplan, pt.rfft_packed(rplan, _real((4, 2 * n), 3), device=CPU))
    tconv.FastConv(np.ones(64), dtype=F64, device=CPU).apply_batched(_real((2, 1000), 4))


@pytest.mark.parametrize("taps", [4, 64, 1024])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "cplx_inp_out"])
def test_float64_fastconv_matches_reference(taps, cplx):
    flags = tconv.ConvFlags.CPLX_INP_OUT if cplx else tconv.ConvFlags.NONE
    rng = np.random.default_rng(taps)
    h = rng.standard_normal(taps)
    length = 6 * taps + 1000
    x = rng.standard_normal(length) + (1j * rng.standard_normal(length) if cplx else 0)
    ref = rconv.FastConv(h, flags=rconv.ConvFlags(int(flags)), dtype=F64)
    fc = tconv.FastConv(h, flags=flags, dtype=F64, device=CPU)
    for flush in (False, True):
        want, wn = ref.apply(jnp.asarray(x), flush)
        got, gn = fc.apply(x, flush)
        assert gn == wn
        assert got.dtype == (torch.complex128 if cplx else torch.float64)
        _close(got, want)
    # apply_batched: one column set for the rows, each row as apply gives it
    xs = np.stack([x, x[::-1].copy()])
    got = fc.apply_batched(xs)
    for r in range(2):
        _close(got[r], ref.apply(jnp.asarray(xs[r]), True)[0])
    want = np.convolve(x, h, "valid")
    _close(fc.apply(x, True)[0], want)
