"""The port's batch-major transform API against pffft_tpu's on the same
numpy inputs: the complex-dtype API (``transform_ordered``, ``transform``,
``zreorder``, the ``zconvolve`` functions, ``cfft`` / ``icfft``,
``rfft_packed`` / ``irfft_packed``, the spectrum helpers, the frequency
grids and shifts), the split-format and in-place forms, reference plans
carried across with ``save_plan`` / ``load_plan``, the batch-major stage
engine of ``ops/split.py`` and ``ops/stages.py``, errors, the unscaled
round trip and the 140 dB carrier bound on the batch-major path.

On the CPU the port's kernel wrappers run their plain versions, over the
routes the card takes ("fused2" up to N = 16384, "tmajor" above)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu.ops import split as rsplit
from pffft_tpu.ops import stages as rstages
import pffft_tpu_torch as pt
from pffft_tpu_torch.ops import split as tsplit
from pffft_tpu_torch.ops import stages as tstages

# One intra-op thread: the suite runs in several worker processes that share
# the cores, and an oversubscribed OpenMP pool slows each torch call by
# tens of times.
torch.set_num_threads(1)

SIZES = [16, 96, 160, 1024, 2400, 4096, 8192, 65536]
REAL_SIZES = [32, 192, 1920, 2048, 8192, 65536]
LEAD = (2, 3)
# transforms, relative to max|ref|: f32 FFTs of the same input through
# different stage chains (radix <= 5 dense einsums in the reference, the
# radix-16/8 butterfly chain here)
TOL = 1e-5
# pointwise products: the same f32 complex multiply on both sides
MUL_TOL = 1e-6
CARRIER_DB = 140.0
CPU = "cpu"


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=TOL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _close_pair(got, ref, tol=TOL):
    got = [_np(g) for g in got]
    ref = [_np(r) for r in ref]
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref, strict=True):
        assert g.shape == r.shape and g.dtype == np.float32
        assert np.abs(g - r).max() <= tol * scale


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# ---------------------------------------------------------------------------
# Complex plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_complex_api_matches_reference(n):
    x = _cplx((*LEAD, n), n)
    plan, rplan = pt.new_setup(n), pf.new_setup(n)
    for rdir, tdir in ((pf.FORWARD, pt.FORWARD), (pf.BACKWARD, pt.BACKWARD)):
        got = pt.transform_ordered(plan, x, tdir, device=CPU)
        assert got.dtype == torch.complex64 and got.shape == x.shape
        _close(got, pf.transform_ordered(rplan, jnp.asarray(x), rdir))
    _close(pt.cfft(plan, x, device=CPU), pf.cfft(rplan, jnp.asarray(x)))
    _close(pt.icfft(plan, x, device=CPU), pf.icfft(rplan, jnp.asarray(x)))


@pytest.mark.parametrize("n", SIZES)
def test_split_api_matches_reference(n):
    re, im = x = (_real((*LEAD, n), n), _real((*LEAD, n), n + 1))
    plan, rplan = pt.new_setup(n), pf.new_setup(n)
    for rdir, tdir in ((pf.FORWARD, pt.FORWARD), (pf.BACKWARD, pt.BACKWARD)):
        _close_pair(pt.transform_ordered_split(plan, x, tdir, device=CPU),
                    pf.transform_ordered_split(rplan, _j(re, im), rdir))


def _factor_sets(n):
    """The default chain and a two-stage chain of length n: the "fused2"
    engine's own internal order where its factors are at most 128."""

    for cap in (128, 64, 32, 16, 8):
        two = pt.plan_factors(n, max_factor=cap)
        if len(two) == 2 and max(two) <= 128:
            break
    else:
        two = pt.plan_factors(n, max_factor=256)
    return [pt.new_setup(n).factors, two]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("which", [0, 1])
def test_internal_order_matches_reference(n, which):
    factors = _factor_sets(n)[which]
    plan, rplan = pt.new_setup(n, factors=factors), pf.new_setup(n, factors=factors)
    x = _cplx((*LEAD, n), n)
    re, im = x.real.copy(), x.imag.copy()
    for rdir, tdir in ((pf.FORWARD, pt.FORWARD), (pf.BACKWARD, pt.BACKWARD)):
        _close(pt.transform(plan, x, tdir, device=CPU),
               pf.transform(rplan, jnp.asarray(x), rdir))
        _close_pair(pt.transform_split(plan, (re, im), tdir, device=CPU),
                    pf.transform_split(rplan, _j(re, im), rdir))
        # a permutation: exact
        got = pt.zreorder(plan, torch.from_numpy(x), tdir)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(pf.zreorder(rplan, jnp.asarray(x), rdir)))
    # internal order is a round trip through zreorder
    z = pt.transform(plan, x, device=CPU)
    _close(pt.zreorder(plan, z, pt.FORWARD), pt.transform_ordered(plan, x, device=CPU))


def test_inplace_forms_write_into_the_callers_planes():
    n = 1024
    plan = pt.new_setup(n, factors=(32, 32))
    rplan = pf.new_setup(n, factors=(32, 32))
    re, im = _real((4, n), 1), _real((4, n), 2)
    for fn, rfn in ((pt.transform_ordered_split_inplace, pf.transform_ordered_split),
                    (pt.transform_split_inplace, pf.transform_split)):
        tr, ti = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
        out = fn(plan, (tr, ti), pt.FORWARD)
        assert out[0] is tr and out[1] is ti
        _close_pair(out, rfn(rplan, _j(re, im), pf.FORWARD))
        # numpy planes cannot alias a tensor: the result comes back
        got = fn(plan, (re, im), pt.FORWARD, device=CPU)
        _close_pair(got, out, 0.0)
    # real plans change the shape and fall back to the pure call
    rp = pt.new_setup(2 * n, pt.REAL)
    x = torch.from_numpy(_real((4, 2 * n), 3))
    sr, si = pt.transform_ordered_split_inplace(rp, x)
    assert sr.shape == (4, n) and not sr.data_ptr() == x.data_ptr()


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_zconvolve_matches_reference(kind):
    n = 192 if kind == "real" else 96
    plan = pt.new_setup(n, pt.REAL if kind == "real" else pt.COMPLEX)
    rplan = pf.new_setup(n, pf.REAL if kind == "real" else pf.COMPLEX)
    h = plan.spectrum_size
    a, b, ab = _cplx((3, h), 1), _cplx((3, h), 2), _cplx((3, h), 3)
    _close(pt.zconvolve_no_accu(plan, a, b, 0.5, device=CPU),
           pf.zconvolve_no_accu(rplan, *_j(a, b), 0.5), MUL_TOL)
    _close(pt.zconvolve_accumulate(plan, a, b, ab, 0.25, device=CPU),
           pf.zconvolve_accumulate(rplan, *_j(a, b, ab), 0.25), MUL_TOL)
    pa, pb, pab = ((z.real.copy(), z.imag.copy()) for z in (a, b, ab))
    for acc in (None, pab):
        got = pt.zconvolve_split(plan, pa, pb, 0.5, acc, device=CPU)
        ref = pf.zconvolve_split(rplan, _j(*pa), _j(*pb), 0.5,
                                 None if acc is None else _j(*acc))
        _close_pair(got, ref, MUL_TOL)


# ---------------------------------------------------------------------------
# Real plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", REAL_SIZES)
def test_real_api_matches_reference(n):
    plan, rplan = pt.new_setup(n, pt.REAL), pf.new_setup(n, pf.REAL)
    x = _real((*LEAD, n), n)
    spec = pt.rfft_packed(plan, x, device=CPU)
    rspec = np.asarray(pf.rfft_packed(rplan, jnp.asarray(x)))
    assert spec.dtype == torch.complex64 and spec.shape == (*LEAD, n // 2)
    _close(spec, rspec)
    _close(pt.transform(plan, x, device=CPU), rspec)
    back = pt.irfft_packed(plan, rspec, device=CPU)
    assert back.dtype == torch.float32 and back.shape == x.shape
    _close(back, pf.irfft_packed(rplan, jnp.asarray(rspec)))
    _close(pt.transform(plan, rspec, pt.BACKWARD, device=CPU), back, 0.0)
    sr, si = rspec.real.copy(), rspec.imag.copy()
    _close_pair(pt.transform_ordered_split(plan, x, device=CPU),
                pf.transform_ordered_split(rplan, jnp.asarray(x)))
    _close(pt.transform_ordered_split(plan, (sr, si), pt.BACKWARD, device=CPU),
           pf.transform_ordered_split(rplan, _j(sr, si), pf.BACKWARD))
    _close(pt.transform_split(plan, (sr, si), pt.BACKWARD, device=CPU), back, 0.0)
    assert pt.zreorder(plan, spec) is spec
    # spectrum packing: data movement, exact
    unpacked = pt.spectrum_unpack(rspec, device=CPU)
    np.testing.assert_array_equal(unpacked.numpy(),
                                  np.asarray(pf.spectrum_unpack(jnp.asarray(rspec))))
    np.testing.assert_array_equal(pt.spectrum_pack(unpacked).numpy(),
                                  np.asarray(pf.spectrum_pack(jnp.asarray(unpacked.numpy()))))


def test_frequency_grids_and_shifts_are_exact():
    for n, d in ((16, 1.0), (15, 0.25), (1024, 1e-3)):
        np.testing.assert_array_equal(pt.fftfreq(n, d), pf.fftfreq(n, d))
        np.testing.assert_array_equal(pt.rfftfreq(n, d), pf.rfftfreq(n, d))
    x = _cplx((3, 5, 8), 7)
    for axes in (None, 1, -1, (0, 2)):
        for tfn, rfn in ((pt.fftshift, pf.fftshift), (pt.ifftshift, pf.ifftshift)):
            got = tfn(torch.from_numpy(x), axes)
            np.testing.assert_array_equal(got.numpy(), np.asarray(rfn(jnp.asarray(x), axes)))
            np.testing.assert_array_equal(tfn(x.real, axes, device=CPU).numpy(),
                                          np.asarray(rfn(jnp.asarray(x.real), axes)))


# ---------------------------------------------------------------------------
# Round trip, carrier bound, errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [96, 2400, 65536])
def test_round_trip_is_unscaled(n):
    x = torch.from_numpy(_cplx((2, n), n))
    keep = x.clone()
    plan = pt.new_setup(n)
    back = pt.icfft(plan, pt.cfft(plan, x))
    assert torch.allclose(back / n, x, atol=1e-5)
    assert torch.equal(x, keep)  # the caller's tensor is not modified
    rplan = pt.new_setup(2 * n, pt.REAL)
    xr = torch.from_numpy(_real((2, 2 * n), n))
    assert torch.allclose(pt.irfft_packed(rplan, pt.rfft_packed(rplan, xr)) / (2 * n), xr,
                          atol=1e-5)


def _carrier_rows(n):
    """tests/test_accuracy.py's carrier sweep as batch-major rows."""

    ks = list(range(0, n, max(1, n // 16)))
    rows = []
    for j, k in enumerate(ks):
        amp = 1.0 if j % 3 == 0 else 1.1
        phi = (j % 4) * 0.125 * np.pi + 2.0 * np.pi * ((k if k < n / 2 else k - n) / n) \
            * np.arange(n, dtype=np.float64)
        rows.append(amp * np.exp(1j * phi))
    return np.stack(rows).astype(np.complex64), ks


@pytest.mark.parametrize("n", [1024, 4096, 65536])
def test_carrier_dynamic_range(n):
    x, ks = _carrier_rows(n)
    y = pt.transform_ordered(pt.new_setup(n), x, device=CPU).to(torch.complex128).numpy()
    for j, k in enumerate(ks):
        p = np.abs(y[j]) ** 2
        carrier = p[k]
        p[k] = 0.0
        db = 10.0 * (np.log10(carrier) - np.log10(max(p.max(), 1e-300)))
        assert db >= CARRIER_DB, (n, k, db)


def test_errors_match_reference():
    n = 96
    plan, rplan = pt.new_setup(n), pf.new_setup(n)
    x = _cplx((2, n + 1), 1)
    for tfn, rfn in ((pt.transform_ordered, pf.transform_ordered),
                     (pt.transform, pf.transform)):
        with pytest.raises(ValueError) as te:
            tfn(plan, x, device=CPU)
        with pytest.raises(ValueError) as rf:
            rfn(rplan, jnp.asarray(x))
        assert str(te.value) == str(rf.value)
    with pytest.raises(ValueError, match="expected 96"):
        pt.transform_ordered_split(plan, (x.real, x.imag), device=CPU)
    with pytest.raises(ValueError, match="re and im planes differ"):
        pt.transform_ordered_split(plan, (x.real[:, :n], x.imag[:1, :n]), device=CPU)
    for direction, exc in (("sideways", ValueError), (2.5, TypeError)):
        with pytest.raises(exc) as te:
            pt.transform_ordered(plan, x[:, :n], direction, device=CPU)
        with pytest.raises(exc) as rf:
            pf.transform_ordered(rplan, jnp.asarray(x[:, :n]), direction)
        assert str(te.value) == str(rf.value)


def test_unported_plans_raise():
    # the port's Bluestein plan runs and matches the reference
    x = (np.random.default_rng(97).standard_normal((3, 97))
         + 1j * np.random.default_rng(98).standard_normal((3, 97))).astype(np.complex64)
    want = np.asarray(pf.transform_ordered(pf.bluestein.new_setup_any(97), jnp.asarray(x)))
    got = pt.transform_ordered(pt.new_setup_any(97), x, device=CPU)
    assert got.dtype == torch.complex64
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    # plan objects of the JAX package are foreign types: the reference's text
    bplan = pf.bluestein.new_setup_any(97)
    with pytest.raises(TypeError) as te:
        pt.transform_ordered(bplan, np.zeros(97, np.complex64), device=CPU)
    with pytest.raises(TypeError) as rf:
        pf.transform_ordered(pf.bluestein.CztPlan(97), jnp.zeros(97, jnp.complex64))
    assert str(te.value) == str(rf.value).replace("CztPlan for", "BluesteinPlan for")
    with pytest.raises(TypeError, match="unsupported plan type BluesteinPlan"):
        pt.transform_ordered_split(bplan, (np.zeros(97), np.zeros(97)), device=CPU)
    # float64 plans are ported (tests/test_torch_f64.py): they run
    x = np.zeros((2, 64), np.float32)
    assert pt.rfft_packed(pt.new_setup(64, pt.REAL, dtype="float64"), x,
                          device=CPU).dtype == torch.complex128
    got = pt.transform_split(pt.new_setup(64, dtype="float64"), (x, x), device=CPU)
    assert got[0].dtype == torch.float64


def test_numpy_input_goes_to_the_card_by_default():
    x = np.zeros((2, 16), np.complex64)
    if torch.cuda.is_available():
        assert pt.transform_ordered(pt.new_setup(16), x).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.transform_ordered(pt.new_setup(16), x)


# ---------------------------------------------------------------------------
# Reference plans carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4096, 65536])
def test_saved_reference_plan_runs_in_the_port(n, tmp_path):
    rplan = pf.new_setup(n, max_factor=64)
    assert (rplan.local_split is not None) == (n == 65536)
    path = tmp_path / "plan.npz"
    pf.plan.save_plan(rplan, path)
    plan = pt.load_plan(path)
    assert plan.factors == rplan.factors
    assert (plan.local_split is not None) == (rplan.local_split is not None)
    arrays: dict = {}
    pf.plan._plan_to_arrays(rplan, "p_", arrays)
    assert pt.plan_from_reference(arrays) == plan
    re, im = _real((3, n), 5), _real((3, n), 6)
    for rdir, tdir in ((pf.FORWARD, pt.FORWARD), (pf.BACKWARD, pt.BACKWARD)):
        _close_pair(pt.transform_ordered_split(plan, (re, im), tdir, device=CPU),
                    pf.transform_ordered_split(rplan, _j(re, im), rdir))
        _close_pair(pt.transform_split(plan, (re, im), tdir, device=CPU),
                    pf.transform_split(rplan, _j(re, im), rdir))


# ---------------------------------------------------------------------------
# The batch-major stage engine and the internal layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [96, 1024, 2400])
def test_stage_engine_matches_reference(n):
    plan, rplan = pt.new_setup(n), pf.new_setup(n)
    x = _cplx((*LEAD, n), n)
    re, im = x.real.copy(), x.imag.copy()
    for ordered in (True, False):
        for backward in (False, True):
            got = tsplit.cfft_stages_split(torch.from_numpy(re), torch.from_numpy(im),
                                           plan.stages, backward=backward, ordered=ordered)
            ref = rsplit.cfft_stages_split(*_j(re, im), rplan.stages, backward=backward,
                                           ordered=ordered)
            _close_pair(got, ref)
            _close(tstages.cfft_stages(torch.from_numpy(x), plan.stages, backward=backward,
                                       ordered=ordered),
                   rstages.cfft_stages(jnp.asarray(x), rplan.stages, backward=backward,
                                       ordered=ordered))
            _close(tstages.cfft_plan(torch.from_numpy(x), plan, backward=backward,
                                     ordered=ordered),
                   rstages.cfft_plan(jnp.asarray(x), rplan, backward=backward,
                                     ordered=ordered))
    assert tstages.internal_order_shape(plan.factors) == rstages.internal_order_shape(
        rplan.factors)
    for canon in (True, False):
        np.testing.assert_array_equal(
            tstages.reorder_spectrum(torch.from_numpy(x), plan.factors, canon).numpy(),
            np.asarray(rstages.reorder_spectrum(jnp.asarray(x), rplan.factors, canon)))


def test_local_split_plan_stage_engine_matches_reference():
    n = 65536
    rplan = pf.new_setup(n, max_factor=64)
    arrays: dict = {}
    pf.plan._plan_to_arrays(rplan, "p_", arrays)
    plan = pt.plan_from_reference(arrays)
    re, im = _real((2, n), 8), _real((2, n), 9)
    for ordered in (True, False):
        for backward in (False, True):
            got = tsplit.cfft_plan_split(plan, torch.from_numpy(re), torch.from_numpy(im),
                                         backward=backward, ordered=ordered)
            ref = rsplit.cfft_plan_split(rplan, *_j(re, im), backward=backward,
                                         ordered=ordered)
            _close_pair(got, ref)


def test_planar_arithmetic_matches_reference():
    x, y = _cplx((3, 40), 1), _cplx((3, 40), 2)
    re, im = tsplit.to_split(torch.from_numpy(x))
    assert re.is_contiguous() and im.is_contiguous()
    np.testing.assert_array_equal(re.numpy(), x.real)
    np.testing.assert_array_equal(im.numpy(), x.imag)
    np.testing.assert_array_equal(tsplit.from_split((re, im)).numpy(), x)
    a = tsplit.to_split(torch.from_numpy(x))
    b = tsplit.to_split(torch.from_numpy(y))
    for tfn, rfn in ((tsplit.split_mul, rsplit.split_mul),
                     (tsplit.split_conj_mul, rsplit.split_conj_mul)):
        _close_pair(tfn(a, b), rfn(_j(x.real, x.imag), _j(y.real, y.imag)), MUL_TOL)
