"""The port's PFDSP modules, pffft_tpu_torch.dsp (NCO mixers, the ALGO A-J
surface, carriers, the CIC downconverter), against pffft_tpu.dsp on the
same seeded numpy inputs, including a reference state carried into the
port mid-stream."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pffft_tpu import dsp as rdsp
import pffft_tpu_torch as pt
from pffft_tpu_torch import dsp as tdsp

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
# relative to max|ref|: the same f32 angles on both sides, then cos/sin and
# the complex product, a few ulp apart between the two libraries
MIXER_TOL = 2e-6
# ALGO C/E/I/J: the same f32 carries, then the block products; their drift
# grows with n, so n <= 4096
SEQ_TOL = 1e-5
# the CIC: a product of 3R-2 taps summed in another order on each side
CIC_TOL = 1e-5
RATES = [0.0, 0.125, 0.1234567, -0.3, 0.49]


def _rel(got, ref):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _ref_state(st):
    return int(np.asarray(st.phase_fp)), int(np.asarray(st.rate_fp))


# ---------------------------------------------------------------------------
# The integer NCO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("phase0", [0.0, 0.7, -2.5])
def test_mixer_apply_matches_reference(rate, phase0):
    x = _cplx(4096, 11)
    st_r = rdsp.mixer_init(rate, phase0)
    st_t = tdsp.mixer_init(rate, phase0)
    assert (st_t.phase_fp, st_t.rate_fp) == _ref_state(st_r)
    want, st_r2 = rdsp.mixer_apply(st_r, jnp.asarray(x))
    got, st_t2 = tdsp.mixer_apply(st_t, x, device=CPU)
    assert got.dtype == torch.complex64 and got.shape == (4096,)
    assert _rel(got, want) <= MIXER_TOL
    assert (st_t2.phase_fp, st_t2.rate_fp) == _ref_state(st_r2)


def test_nco_angles_match_reference_bit_for_bit():
    """The int64 phase, masked and rounded to float32, gives the reference's
    uint32 angles exactly, also where the phase wraps."""

    for phase_fp, rate_fp in ((0xFFFFFFF0, 0x7FFFFFFF), (12345, 0xFFFFFFFF), (0, 0x9E3779B9)):
        n = 5000
        k = jnp.arange(n, dtype=jnp.uint32)
        ph = jnp.uint32(phase_fp) + k * jnp.uint32(rate_fp)
        want = np.asarray(ph.astype(jnp.float32) * jnp.float32(2.0 * np.pi / 2.0**32))
        got = tdsp.mixer.nco_angles(phase_fp, rate_fp, n, CPU).numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="2\\^31"):
        tdsp.mixer.nco_angles(0, 1, 1 << 31, CPU)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_mixer_multichannel_and_split(lead):
    """Every channel shares the NCO; the planar mixer equals the complex one."""

    x = _cplx((*lead, 1000), 12)
    st = rdsp.mixer_init(0.217, 1.1)
    want, st_r = rdsp.mixer_apply(st, jnp.asarray(x))
    (wr, wi), _ = rdsp.mixer_apply_split(st, jnp.asarray(x.real), jnp.asarray(x.imag))
    tst = tdsp.mixer_init(0.217, 1.1)
    got, st_t = tdsp.mixer_apply(tst, torch.from_numpy(x))
    (gr, gi), st_s = tdsp.mixer_apply_split(tst, x.real.copy(), x.imag.copy(), device=CPU)
    assert _rel(got, want) <= MIXER_TOL
    assert max(_rel(gr, wr), _rel(gi, wi)) <= MIXER_TOL
    assert st_t == st_s and (st_t.phase_fp, st_t.rate_fp) == _ref_state(st_r)


def test_mixer_state_carried_from_reference_mid_stream():
    """A reference stream stopped after two chunks carries on in the port."""

    x = _cplx(6000, 13)
    st = rdsp.mixer_init(0.01717, 0.3)
    outs = []
    for a, b in ((0, 1500), (1500, 3000)):
        y, st = rdsp.mixer_apply(st, jnp.asarray(x[a:b]))
        outs.append(np.asarray(y))
    want, st_r = rdsp.mixer_apply(st, jnp.asarray(x[3000:]))
    tst = tdsp.mixer.state_from_arrays(np.asarray(st.phase_fp), np.asarray(st.rate_fp))
    got, st_t = tdsp.mixer_apply(tst, x[3000:], device=CPU)
    assert _rel(got, want) <= MIXER_TOL
    assert (st_t.phase_fp, st_t.rate_fp) == _ref_state(st_r)


def test_mixer_carrier_and_class():
    st = rdsp.mixer_init(-0.123, 2.0)
    want, st_r = rdsp.mixer.mixer_carrier(st, 777)
    got, st_t = tdsp.mixer.mixer_carrier(tdsp.mixer_init(-0.123, 2.0), 777, device=CPU)
    assert _rel(got, want) <= MIXER_TOL and (st_t.phase_fp, st_t.rate_fp) == _ref_state(st_r)
    x = _cplx(3000, 14)
    rm, tm = rdsp.Mixer(0.0371, 0.4), tdsp.Mixer(0.0371, 0.4, device=CPU)
    for a in range(0, 3000, 1000):
        assert _rel(tm.shift(x[a:a + 1000]), rm.shift(jnp.asarray(x[a:a + 1000]))) <= MIXER_TOL
        assert tm.phase == rm.phase
    assert _rel(tm.carrier(64), rm.carrier(64)) <= MIXER_TOL
    assert tm.phase == rm.phase


# ---------------------------------------------------------------------------
# ALGO A-J
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", RATES)
def test_shift_math_and_table_match_reference(rate):
    x = _cplx(2048, 15)
    want, nxt_r = rdsp.shift_math_cc(jnp.asarray(x), rate, 0.9)
    got, nxt_t = tdsp.shift_math_cc(x, rate, 0.9, device=CPU)
    assert _rel(got, want) <= MIXER_TOL and nxt_t == nxt_r
    for size in (65536, 1024):
        want, nxt_r = rdsp.shift_table_cc(jnp.asarray(x), rate, rdsp.shift_table_init(size), 0.9)
        got, nxt_t = tdsp.shift_table_cc(x, rate, tdsp.shift_table_init(size), 0.9, device=CPU)
        assert _rel(got, want) <= MIXER_TOL and nxt_t == nxt_r


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("n", [256, 4096])
def test_shift_addfast_and_unroll_match_reference(rate, n):
    """ALGO C (the blocked phasor, no renormalization) and ALGO D (the
    rotator table)."""

    x = _cplx(n, 16)
    want, nxt_r = rdsp.shift_addfast_cc(jnp.asarray(x), rdsp.shift_addfast_init(rate), 0.3)
    got, nxt_t = tdsp.shift_addfast_cc(x, tdsp.shift_addfast_init(rate), 0.3, device=CPU)
    assert _rel(got, want) <= SEQ_TOL and nxt_t == nxt_r
    want, nxt_r = rdsp.shift_unroll_cc(jnp.asarray(x), rdsp.shift_unroll_init(rate, n), 0.3)
    got, nxt_t = tdsp.shift_unroll_cc(x, tdsp.shift_unroll_init(rate, n), 0.3, device=CPU)
    assert _rel(got, want) <= MIXER_TOL and nxt_t == nxt_r
    with pytest.raises(ValueError, match="ALGO D"):
        tdsp.shift_unroll_cc(np.zeros(n + 8, np.complex64), tdsp.shift_unroll_init(rate, n),
                             device=CPU)
    with pytest.raises(ValueError, match="ALGO C"):
        tdsp.shift_addfast_cc(np.zeros(6, np.complex64), tdsp.shift_addfast_init(rate),
                              device=CPU)


@pytest.mark.parametrize("rate", RATES)
def test_shift_limited_unroll_matches_reference_streaming(rate):
    """ALGO E (and its F/G/H aliases): the renormalized phasor, carried in
    the state object across chunks; a reference state carried in."""

    x = _cplx(4096, 17)
    rd = rdsp.shift_limited_unroll_init(rate, 0.5)
    td = tdsp.shift_limited_unroll_init(rate, 0.5)
    for a, b in ((0, 1024), (1024, 1536)):
        want = rdsp.shift_limited_unroll_cc(jnp.asarray(x[a:b]), rd)
        got = tdsp.shift_limited_unroll_cc(x[a:b], td, device=CPU)
        assert _rel(got, want) <= SEQ_TOL
        assert np.allclose(td.phasor, rd.phasor, rtol=0, atol=1e-6)
    # the reference's state carried into the port mid-stream
    td.phasor = rd.phasor
    want = rdsp.shift_limited_unroll_cc(jnp.asarray(x[1536:]), rd)
    got = tdsp.mixer.shift_limited_unroll_C_sse_inp_c(x[1536:], td, device=CPU)
    assert _rel(got, want) <= SEQ_TOL
    assert np.allclose(td.phasor, rd.phasor, rtol=0, atol=SEQ_TOL)
    assert tdsp.mixer.shift_limited_unroll_A_sse_init is tdsp.shift_limited_unroll_init
    with pytest.raises(ValueError, match="ALGO E"):
        tdsp.shift_limited_unroll_cc(np.zeros(100, np.complex64), td, device=CPU)


@pytest.mark.parametrize("rate", RATES)
def test_shift_recursive_osc_matches_reference(rate):
    """ALGO I / J: the 8-lane recursion, carried across chunks, and the
    generator; update_rate keeps lane 0's phasor."""

    x = _cplx(4096, 18)
    ro = rdsp.shift_recursive_osc_init(rate, 0.25)
    to = tdsp.shift_recursive_osc_init(rate, 0.25)
    np.testing.assert_array_equal(to.u, ro.u)
    assert (to.k1, to.k2) == (ro.k1, ro.k2)
    for a, b in ((0, 2048), (2048, 4096)):
        want = rdsp.shift_recursive_osc_cc(jnp.asarray(x[a:b]), ro)
        got = tdsp.mixer.shift_recursive_quadrature_osc_cc(x[a:b], to, device=CPU)
        assert _rel(got, want) <= SEQ_TOL
    np.testing.assert_allclose(to.u, ro.u, atol=SEQ_TOL)
    want = rdsp.gen_recursive_osc_c(1024, ro)
    got = tdsp.gen_recursive_osc_c(1024, to, device=CPU)
    assert got.dtype == torch.complex64 and _rel(got, want) <= SEQ_TOL
    rdsp.mixer.shift_recursive_osc_update_rate(0.1, ro)
    tdsp.mixer.shift_recursive_osc_update_rate(0.1, to)
    assert (to.k1, to.k2) == (ro.k1, ro.k2)
    with pytest.raises(ValueError, match="ALGO I"):
        tdsp.gen_recursive_osc_c(12, to, device=CPU)
    assert tdsp.have_sse_shift_mixer_impl()


# ---------------------------------------------------------------------------
# Carriers
# ---------------------------------------------------------------------------

CARRIERS = [n for n in tdsp.carrier.__all__]


@pytest.mark.parametrize("name", CARRIERS)
@pytest.mark.parametrize("size", [4, 64])
def test_carrier_matches_reference_exactly(name, size):
    r, t = getattr(rdsp, name), getattr(tdsp, name)
    layouts = [{}] if name.endswith("_f") else [{"interleaved": False}, {"interleaved": True}]
    for kw in layouts:
        want = np.asarray(r(size, **kw))
        got = t(size, device=CPU, **kw).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="multiple of 4"):
        t(6, device=CPU)


# ---------------------------------------------------------------------------
# CIC
# ---------------------------------------------------------------------------

CIC_FACTORS = [1, 2, 4, 8, 16, 64]


def _cic_input(fmt, n, seed):
    rng = np.random.default_rng(seed)
    if fmt == "s16":
        return rng.integers(-32000, 32000, size=n).astype(np.int16)
    if fmt == "cs16":
        return rng.integers(-32000, 32000, size=2 * n).astype(np.int16)
    if fmt == "cu8":
        return rng.integers(0, 256, size=2 * n).astype(np.uint8)
    return _cplx(n, seed)


@pytest.mark.parametrize("factor", CIC_FACTORS)
@pytest.mark.parametrize("fmt", ["f", "s16", "cs16", "cu8"])
def test_cic_matches_reference(factor, fmt):
    """Every fmt and factor, two chunks with the state carried (the second
    chunk's length not a multiple of the 128-output row)."""

    k1, k2 = 160, 37
    x = _cic_input(fmt, (k1 + k2) * factor, factor + len(fmt))
    per = 1 if fmt in ("f", "s16") else 2  # array elements per sample
    rd, rs = rdsp.cicddc_init(factor)
    td, ts = tdsp.cicddc_init(factor, device=CPU)
    for a, b in ((0, k1 * factor), (k1 * factor, (k1 + k2) * factor)):
        want, rs = rdsp.cicddc_apply(rd, rs, jnp.asarray(x[a * per:b * per]), 0.1239, fmt=fmt)
        got, ts = tdsp.cicddc_apply(td, ts, x[a * per:b * per], 0.1239, fmt=fmt)
        assert got.dtype == torch.complex64 and got.shape == ((b - a) // factor,)
        assert _rel(got, want) <= CIC_TOL
    assert ts.phase_fp == int(np.asarray(rs.phase_fp))
    assert _rel(ts.hist_re, rs.hist_re) <= CIC_TOL and _rel(ts.hist_im, rs.hist_im) <= CIC_TOL


@pytest.mark.parametrize("factor", [4, 16])
def test_cic_state_carried_from_reference_mid_stream(factor):
    x = _cplx(300 * factor, 21)
    rd, rs = rdsp.cicddc_init(factor)
    _, rs = rd.apply(rs, jnp.asarray(x[: 100 * factor]), 0.05, fmt="f")
    want, rs2 = rd.apply(rs, jnp.asarray(x[100 * factor:]), 0.05, fmt="f")
    td = tdsp.CicDDC(factor, device=CPU)
    ts = tdsp.cic.state_from_arrays(np.asarray(rs.phase_fp), np.asarray(rs.hist_re),
                                    np.asarray(rs.hist_im), device=CPU)
    got, ts2 = td.apply(ts, x[100 * factor:], 0.05, fmt="f")
    assert _rel(got, want) <= CIC_TOL and ts2.phase_fp == int(np.asarray(rs2.phase_fp))


def test_cic_split_and_weights_match_reference():
    factor = 8
    rng = np.random.default_rng(22)
    xr, xi = (rng.standard_normal(256 * factor).astype(np.float32) for _ in range(2))
    rd, td = rdsp.CicDDC(factor), tdsp.CicDDC(factor, device=CPU)
    np.testing.assert_array_equal(td.block_w, np.asarray(rd.block_w))
    (wr, wi), _ = rd.apply_split(rd.init_state(), jnp.asarray(xr), jnp.asarray(xi), -0.2, 0.5)
    (gr, gi), _ = td.apply_split(td.init_state(), xr, xi, -0.2, 0.5)
    assert max(_rel(gr, wr), _rel(gi, wi)) <= CIC_TOL
    with pytest.raises(ValueError, match="multiple of factor"):
        td.apply_split(td.init_state(), xr[:-1], xi[:-1], 0.1)
    with pytest.raises(ValueError, match="unknown fmt"):
        td.apply(td.init_state(), xr, 0.1, fmt="u16")
    with pytest.raises(ValueError, match="factor"):
        tdsp.CicDDC(0)


def test_dsp_exports_match_reference():
    assert sorted(tdsp.__all__) == sorted(rdsp.__all__)
    assert pt.dsp is tdsp
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdsp.mixer_apply(tdsp.mixer_init(0.1), np.zeros(8, np.complex64))
