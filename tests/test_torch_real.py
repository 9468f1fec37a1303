"""The port's real time-major transform against pffft_tpu's.

* the plain versions of the three real kernels (the packed-input chain,
  the fused real transform, the split step) against the Pallas kernels
  they replace, run with ``interpret=True`` as the reference's own tests
  run them on the CPU;
* the real step functions of ``ops/split.py`` against their JAX
  counterparts;
* the public ``transform_ordered_split_tmajor`` on REAL plans against
  pffft_tpu's, its routes, errors, round trip and the 140 dB carrier bound.

The CUDA kernels are held against these plain versions in
``test_torch_cuda.py``.  All inputs are seeded numpy arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu import plan as rp
from pffft_tpu.ops import dispatch as rdp
from pffft_tpu.ops import pallas_fft as rpk
from pffft_tpu.ops import split as rsplit
import pffft_tpu_torch as pt
from pffft_tpu_torch import plan as tp
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import pallas_fft as pk
from pffft_tpu_torch.ops import split as tsplit

# One intra-op thread: the suite runs in several worker processes that share
# the cores, and an oversubscribed OpenMP pool slows each torch call by
# tens of times.
torch.set_num_threads(1)

# plain kernel vs the interpret-mode Pallas kernel, relative to max|ref|:
# the same stages, twiddles and split arithmetic in f32; XLA may fuse or
# reorder a few sums
KERNEL_TOL = 2e-6
# the split twiddles against the reference's float64 fallback tables (used
# where its native long-double planner did not load), which differ from the
# port's long-double tables only at exact zeros (cos(pi/2) = 6.1e-17);
# unit-modulus entries, so an absolute bound
TABLE_TOL = 1e-15
# the split steps: the same elementwise f32 expressions on both sides
STEP_TOL = 2e-6
# the public transform, relative to max|ref|: f32 FFTs of the same input
# through different stage chains (radix <= 5 in the reference, 16/8 here)
TOL = 1e-5
CARRIER_DB = 140.0
CPU = "cpu"
B = 256   # batch of the interpret-mode cases
TB = 128  # the Pallas kernels' tile


def _rng_planes(shape, seed, count=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


def _port_plan(ref_plan):
    d: dict = {}
    rp._plan_to_arrays(ref_plan, "p_", d)
    return tp.plan_from_reference(d)


def _tw(real_plan):
    """The reference plan's split twiddles as the port's tensor pair."""

    tw = real_plan.real_twiddle
    return (torch.from_numpy(np.ascontiguousarray(tw.real, np.float32)),
            torch.from_numpy(np.ascontiguousarray(tw.imag, np.float32)))


def _assert_close(got, ref, tol):
    got = [np.asarray(g) for g in got]
    ref = [np.asarray(r) for r in ref]
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref, strict=True):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= tol * scale


# ---------------------------------------------------------------------------
# Plain kernels against the interpret-mode Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", [256, 1024])
def test_plain_fused_real_matches_pallas_interpret(h):
    rplan = pf.new_setup(2 * h, pf.REAL)
    ref_chain = rdp._thin_plan(h)
    port_chain = _port_plan(ref_chain)
    tw = _tw(rplan)
    (x,) = _rng_planes((2 * h, B), h, 1)
    y = x.reshape(h, 2 * B)
    er, ei = rpk.rfft_pallas_tmajor_fused(ref_chain, jnp.asarray(y), rplan.real_twiddle,
                                          tb=TB, interpret=True)
    got = pk.rfft_chain_tmajor_fused_plain(port_chain, torch.from_numpy(y), tw)
    _assert_close([g.numpy() for g in got], [er, ei], KERNEL_TOL)

    sr, si = _rng_planes((h, B), h + 1)
    er, ei = rpk.rfft_bwd_pallas_tmajor_fused(ref_chain, jnp.asarray(sr), jnp.asarray(si),
                                              rplan.real_twiddle, tb=TB, interpret=True)
    got = pk.rfft_bwd_chain_tmajor_fused_plain(port_chain, torch.from_numpy(sr),
                                               torch.from_numpy(si), tw)
    # the real [N, B] signal is the pair side by side in [H, 2B]
    pair = got.view(h, 2 * B)
    _assert_close([pair[:, :B].numpy(), pair[:, B:].numpy()], [er, ei], KERNEL_TOL)


@pytest.mark.parametrize("h", [96, 256, 1024])
def test_plain_interleaved_backward_matches_reference(h):
    """The fused backward's real [N, B] signal (which the kernel writes on
    the "chain" route) against the reference's pair, then its interleave.  The reference's fused kernel needs a power-of-two H;
    at H = 96 its flat split step and its chain kernel give the same pair."""

    rplan = pf.new_setup(2 * h, pf.REAL)
    ref_chain = rdp._thin_plan(h)
    sr, si = _rng_planes((h, B), 7 * h)
    if h & (h - 1):
        zr, zi = rsplit.real_backward_split_planar_tmajor_flat(
            jnp.asarray(sr), jnp.asarray(si), rplan.real_twiddle)
        er, ei = rpk.cfft_pallas_tmajor(ref_chain, zr, zi, backward=True, tb=TB,
                                        interpret=True)
    else:
        er, ei = rpk.rfft_bwd_pallas_tmajor_fused(ref_chain, jnp.asarray(sr), jnp.asarray(si),
                                                  rplan.real_twiddle, tb=TB, interpret=True)
    ref = rsplit.interleave_to_real_split_tmajor(er, ei)
    got = pk.rfft_bwd_chain_tmajor_fused_plain(_port_plan(ref_chain), torch.from_numpy(sr),
                                               torch.from_numpy(si), _tw(rplan))
    assert got.shape == (2 * h, B)
    _assert_close([got.numpy()], [ref], KERNEL_TOL)


@pytest.mark.parametrize("h,conf", [(256, None), (1024, None), (1024, (128, 8))])
def test_plain_packed_chain_matches_pallas_interpret(h, conf):
    """slabs=1 on the [H, 2B] buffer, slabs=r on kern2's [m, r*2B] view;
    bit-exact with the planar chain on the sliced planes."""

    (x,) = _rng_planes((2 * h, B), 3 * h, 1)
    if conf is None:
        ref_plan, slabs, rows = rdp._thin_plan(h), 1, h
    else:
        ref_plan, slabs, rows = rdp._build_ksplit(h, *conf)[0], conf[1], conf[0]
    port_plan = _port_plan(ref_plan)
    y = x.reshape(rows, slabs * 2 * B)
    er, ei = rpk.cfft_pallas_tmajor_packed(ref_plan, jnp.asarray(y), tb=TB, slabs=slabs,
                                           interpret=True)
    gr, gi = pk.chain_tmajor_packed_plain(port_plan, torch.from_numpy(y), slabs=slabs)
    _assert_close([gr.numpy(), gi.numpy()], [er, ei], KERNEL_TOL)
    v = y.reshape(rows, slabs, 2, B)
    pr, pi = pk.chain_tmajor_plain(
        port_plan, torch.from_numpy(v[:, :, 0].reshape(rows, -1).copy()),
        torch.from_numpy(v[:, :, 1].reshape(rows, -1).copy()))
    assert torch.equal(gr, pr) and torch.equal(gi, pi)


@pytest.mark.parametrize("h", [256, 1024])
@pytest.mark.parametrize("backward", [False, True])
def test_plain_split_matches_pallas_interpret(h, backward):
    rplan = pf.new_setup(2 * h, pf.REAL)
    zr, zi = _rng_planes((h, B), 5 * h + backward)
    er, ei = rpk.real_split_tmajor_pallas(jnp.asarray(zr), jnp.asarray(zi),
                                          rplan.real_twiddle, backward=backward, tb=TB,
                                          interpret=True)
    gr, gi = pk.real_split_tmajor_plain(torch.from_numpy(zr), torch.from_numpy(zi),
                                        _tw(rplan), backward=backward)
    _assert_close([gr.numpy(), gi.numpy()], [er, ei], KERNEL_TOL)


def test_packed_kern2_matches_reference_and_planar_kern2():
    n, conf = 1024, (128, 8)
    (x,) = _rng_planes((2 * n, B), 7, 1)
    y = x.reshape(n, 2 * B)
    er, ei = rdp.cfft_kern2_tmajor_packed(pf.new_setup(n, pf.COMPLEX), jnp.asarray(y),
                                          conf=conf, interpret=True)
    plan = tp.new_setup(n)
    gr, gi = D.cfft_kern2_tmajor_packed(plan, torch.from_numpy(y), conf=conf)
    _assert_close([gr.numpy(), gi.numpy()], [er, ei], KERNEL_TOL)
    zr, zi = tsplit.pack_real_input_split_tmajor(torch.from_numpy(x))
    pr, pi = D.cfft_kern2_tmajor(plan, zr.contiguous(), zi.contiguous(), conf=conf)
    assert torch.equal(gr, pr) and torch.equal(gi, pi)


# ---------------------------------------------------------------------------
# The real step functions against pffft_tpu.ops.split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", [96, 256, 960])  # pow2 and not (odd H/16 too)
def test_split_steps_match_reference(h):
    rplan = pf.new_setup(2 * h, pf.REAL)
    tw = _tw(rplan)
    zr, zi = _rng_planes((h, 24), h)
    jr, ji = jnp.asarray(zr), jnp.asarray(zi)
    tr, ti = torch.from_numpy(zr), torch.from_numpy(zi)

    got = tsplit._reverse_conj_split_tmajor(tr, ti)
    ref = rsplit._reverse_conj_split_tmajor(jr, ji)
    assert all(np.array_equal(g.numpy(), np.asarray(r)) for g, r in zip(got, ref))
    for port, refn in (
        (tsplit.real_forward_split_planar_tmajor, rsplit.real_forward_split_planar_tmajor),
        (tsplit.real_backward_split_planar_tmajor, rsplit.real_backward_split_planar_tmajor),
        (tsplit.real_forward_split_planar_tmajor_flat,
         rsplit.real_forward_split_planar_tmajor_flat),
        (tsplit.real_backward_split_planar_tmajor_flat,
         rsplit.real_backward_split_planar_tmajor_flat),
    ):
        got = port(tr, ti, tw)
        _assert_close([g.numpy() for g in got], refn(jr, ji, rplan.real_twiddle), STEP_TOL)
    # the inputs are not modified
    assert np.array_equal(tr.numpy(), zr) and np.array_equal(ti.numpy(), zi)

    (x,) = _rng_planes((2 * h, 24), h + 1, 1)
    got = tsplit.pack_real_input_split_tmajor(torch.from_numpy(x))
    ref = rsplit.pack_real_input_split_tmajor(jnp.asarray(x))
    assert all(np.array_equal(g.numpy(), np.asarray(r)) for g, r in zip(got, ref))
    got = tsplit.interleave_to_real_split_tmajor(tr, ti)
    assert np.array_equal(got.numpy(), np.asarray(rsplit.interleave_to_real_split_tmajor(jr, ji)))


def test_split_twiddles_equal_reference_and_are_cached():
    for n in (64, 1920, 131072):
        plan = pt.new_setup(n, pt.REAL)
        wr, wi = tsplit.real_split_twiddle(plan, torch.device(CPU))
        ref = pf.new_setup(n, pf.REAL).real_twiddle
        assert wr.dtype == torch.float32 and wr.shape == (n // 2,)
        if rp._native_planner() is not None:  # the port mirrors its long-double tables
            assert np.array_equal(wr.numpy(), ref.real) and np.array_equal(wi.numpy(), ref.imag)
        else:  # the reference's float64 fallback differs at exact zeros
            got = wr.numpy().astype(np.float64) + 1j * wi.numpy()
            assert np.abs(got - ref).max() <= TABLE_TOL
        assert tsplit.real_split_twiddle(plan, torch.device(CPU))[0] is wr


# ---------------------------------------------------------------------------
# The public real transform
# ---------------------------------------------------------------------------


def _reference(n, x, direction):
    plan = pf.new_setup(n, pf.REAL)
    if direction == pf.FORWARD:
        yr, yi = pf.fft.transform_ordered_split_tmajor(plan, jnp.asarray(x), direction)
        return [np.asarray(yr), np.asarray(yi)]
    return [np.asarray(pf.fft.transform_ordered_split_tmajor(
        plan, tuple(jnp.asarray(a) for a in x), direction))]


# H = 16 .. 2048 take the fused kernel, 4096 and 65536 kern2 (chain_max_n
# = 2048 with the H100's shared memory)
REAL_SIZES = [32, 192, 1920, 2048, 4096, 8192, 131072]


@pytest.mark.parametrize("n", REAL_SIZES)
@pytest.mark.parametrize("b", [32, 20])  # a multiple of every tile, and ragged
def test_real_transform_matches_reference(n, b):
    plan = pt.new_setup(n, pt.REAL)
    (x,) = _rng_planes((n, b), n + b, 1)
    got = pt.transform_ordered_split_tmajor(plan, x, pt.FORWARD, device=CPU)
    assert all(g.dtype == torch.float32 and g.shape == (n // 2, b) for g in got)
    _assert_close([g.numpy() for g in got], _reference(n, x, pf.FORWARD), TOL)

    spec = _rng_planes((n // 2, b), n + b + 1)
    got = pt.transform_ordered_split_tmajor(plan, tuple(spec), pt.BACKWARD, device=CPU)
    assert got.dtype == torch.float32 and got.shape == (n, b)
    _assert_close([got.numpy()], _reference(n, spec, pf.BACKWARD), TOL)


@pytest.mark.parametrize("engine", D.ENGINES)
def test_every_engine_serves_the_real_transform(engine):
    # H = 1024: the chain holds it, kern2 splits it 512 x 2
    n = 2048
    (x,) = _rng_planes((n, 12), 9, 1)
    ref = _reference(n, x, pf.FORWARD)
    D.set_engine(engine)
    try:
        plan = pt.new_setup(n, pt.REAL)
        got = pt.transform_ordered_split_tmajor(plan, x, device=CPU)
        back = pt.transform_ordered_split_tmajor(plan, got, pt.BACKWARD)
    finally:
        D.set_engine(None)
    _assert_close([g.numpy() for g in got], ref, TOL)
    assert np.abs(back.numpy() / n - x).max() < 1e-5


@pytest.mark.parametrize("n,b", [(192, 7), (8192, 13), (262144, 3)])  # fused, kern2, stages
def test_real_round_trip_is_unscaled(n, b):
    (x,) = _rng_planes((n, b), n, 1)
    xt = torch.from_numpy(x)
    plan = pt.new_setup(n, pt.REAL)
    yr, yi = pt.transform_ordered_split_tmajor(plan, xt, pt.FORWARD)
    keep = yr.clone(), yi.clone()
    back = pt.transform_ordered_split_tmajor(plan, (yr, yi), pt.BACKWARD)
    assert torch.allclose(back / n, xt, atol=1e-5)
    # the caller's tensors are never modified
    assert np.array_equal(xt.numpy(), x)
    assert torch.equal(yr, keep[0]) and torch.equal(yi, keep[1])


def _real_carrier_columns(n):
    """tests/test_accuracy.py's real carrier sweep as time-major columns."""

    ks = list(range(0, n // 2 + 1, max(1, n // 16)))
    cols, amps = [], []
    for j, k in enumerate(ks):
        amp = 1.0 if j % 3 == 0 else 1.1
        phi = (j % 4) * 0.125 * np.pi + 2.0 * np.pi * (k / n) * np.arange(n, dtype=np.float64)
        cols.append(amp * np.cos(phi))
        amps.append(amp)
    return np.stack(cols, axis=1).astype(np.float32), ks


def _real_bin_powers(yr, yi):
    """Power of the N/2 + 1 bins of packed spectra [H, B] (bin0 = DC +
    i*Nyquist), as tests/test_accuracy.py's ``_bin_powers``."""

    h = yr.shape[0]
    p = np.empty((h + 1, yr.shape[1]))
    p[0] = yr[0] ** 2
    p[h] = yi[0] ** 2
    p[1:h] = yr[1:] ** 2 + yi[1:] ** 2
    return p


@pytest.mark.parametrize("n", [2048, 8192, 131072])
def test_real_carrier_dynamic_range(n):
    x, ks = _real_carrier_columns(n)
    yr, yi = pt.transform_ordered_split_tmajor(pt.new_setup(n, pt.REAL), x, device=CPU)
    power = _real_bin_powers(yr.double().numpy(), yi.double().numpy())
    for j, k in enumerate(ks):
        p = power[:, j].copy()
        carrier = p[k]
        p[k] = 0.0
        db = 10.0 * (np.log10(carrier) - np.log10(max(p.max(), 1e-300)))
        assert db >= CARRIER_DB, (n, k, db)


def test_real_errors_match_reference():
    n = 64
    plan, rplan = pt.new_setup(n, pt.REAL), pf.new_setup(n, pf.REAL)
    (x,) = _rng_planes((n, 4), 1, 1)
    sr, si = _rng_planes((n // 2, 4), 2)
    cases = [
        ((x, x), pt.FORWARD, pf.FORWARD),          # a tuple to the forward
        (x[:-2], pt.FORWARD, pf.FORWARD),          # wrong N
        (x[0], pt.FORWARD, pf.FORWARD),            # not [N, B]
        ((sr[:-1], si[:-1]), pt.BACKWARD, pf.BACKWARD),  # wrong H
        ((sr[0], si[0]), pt.BACKWARD, pf.BACKWARD),
    ]
    for bad, tdir, rdir in cases:
        with pytest.raises(ValueError) as te:
            pt.transform_ordered_split_tmajor(plan, bad, tdir, device=CPU)
        jbad = tuple(map(jnp.asarray, bad)) if isinstance(bad, tuple) else jnp.asarray(bad)
        with pytest.raises(ValueError) as rf:
            pf.fft.transform_ordered_split_tmajor(rplan, jbad, rdir)
        assert str(te.value) == str(rf.value)
    with pytest.raises(ValueError, match="re and im planes differ"):
        pt.transform_ordered_split_tmajor(plan, (sr, si[:, :3]), pt.BACKWARD, device=CPU)


# real N -> the engine at H = N/2, which picks the route: the fused kernel
# ("chain"), else packed kern2 + split ("kern2"), else pack + stages + split
ROUTES = [
    (32, "chain"), (2048, "chain"), (4096, "chain"), (1920, "chain"),
    (8192, "kern2"), (131072, "kern2"), (4800, "kern2"),
    (262144, "stages"),  # H = 2048 * 64: no combine radix 64
]


@pytest.mark.parametrize("n,engine", ROUTES)
def test_real_routes_follow_coverage(n, engine):
    plan = pt.new_setup(n, pt.REAL)
    assert D.select_engine(plan, 256) == engine
    assert D.select_engine(plan, 256, device=torch.device(CPU)) == engine
    fused = {f(plan, 256) is not None for f in (D.fused_real_fwd_route,
                                                D.fused_real_bwd_route)}
    assert fused == {engine == "chain"}
    assert (D.packed_fwd_route(plan, 256) is not None) == (engine == "kern2")
    assert D.real_split_kernel_route(plan, True) is not None
    # the routes serve real f32 plans only
    cplan = pt.new_setup(n // 2)
    assert D.fused_real_fwd_route(cplan, 256) is None
    assert D.packed_fwd_route(cplan, 256) is None
    assert D.real_split_kernel_route(cplan, False) is None


@pytest.mark.parametrize("n,engine", ROUTES[:2] + ROUTES[4:5] + ROUTES[-1:])
def test_real_routes_launch_their_kernels(n, engine, monkeypatch):
    """Which wrappers the public real transform calls, per route (on the
    CPU the wrappers run their plain versions; the card counts launches)."""

    calls = []
    for name in ("cfft_chain_tmajor", "cfft_combine_tmajor", "cfft_chain_tmajor_packed",
                 "rfft_chain_tmajor_fused", "rfft_bwd_chain_tmajor_fused",
                 "real_split_tmajor"):
        fn = getattr(pk, name)
        monkeypatch.setattr(pk, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    plan = pt.new_setup(n, pt.REAL)
    (x,) = _rng_planes((n, 4), 11, 1)
    y = pt.transform_ordered_split_tmajor(plan, x, device=CPU)
    fwd, calls[:] = list(calls), []
    pt.transform_ordered_split_tmajor(plan, y, pt.BACKWARD)
    want = {
        "chain": (["rfft_chain_tmajor_fused"], ["rfft_bwd_chain_tmajor_fused"]),
        "kern2": (["cfft_chain_tmajor_packed", "cfft_combine_tmajor", "real_split_tmajor"],
                  ["real_split_tmajor", "cfft_chain_tmajor", "cfft_combine_tmajor"]),
        "stages": (["real_split_tmajor"], ["real_split_tmajor"]),
    }[engine]
    assert (fwd, calls) == (want[0], want[1])


@pytest.mark.parametrize("n,engine", ROUTES[:2] + ROUTES[4:5] + ROUTES[-1:])
def test_real_backward_interleaves_off_the_chain_route(n, engine, monkeypatch):
    """On the "chain" route the public backward returns B3's output as it
    is: the kernel writes the real signal, so nothing follows it (on the
    CPU the interleave happens inside the wrapper's plain version; that the
    card path makes no copy is chip_smoke.py's check).  The kern2 and stage
    routes interleave their pair once, outside any kernel wrapper."""

    inside, outside, fused_out = [], [], []
    inter = tsplit.interleave_to_real_split_tmajor
    fused = pk.rfft_bwd_chain_tmajor_fused

    def recorded(*a, **k):
        inside.append(1)
        try:
            fused_out.append(fused(*a, **k))
        finally:
            inside.pop()
        return fused_out[-1]

    monkeypatch.setattr(tsplit, "interleave_to_real_split_tmajor",
                        lambda *a: (outside.append(not inside), inter(*a))[1])
    monkeypatch.setattr(pk, "rfft_bwd_chain_tmajor_fused", recorded)
    plan = pt.new_setup(n, pt.REAL)
    spec = _rng_planes((n // 2, 4), 12)
    got = pt.transform_ordered_split_tmajor(plan, tuple(spec), pt.BACKWARD, device=CPU)
    assert got.shape == (n, 4)
    if engine == "chain":
        assert len(fused_out) == 1 and got is fused_out[0]
        assert sum(outside) == 0
    else:
        assert not fused_out and sum(outside) == 1


# B3's launch shape is B1's planner's at every H the fused route serves, and
# there is none past the chain's coverage (H = 4096)
@pytest.mark.parametrize("h", [96, 960, 1024, 1920, 2048, 4096])
def test_fused_real_launch_shape_is_the_core_tile(h):
    plan = pt.new_setup(2 * h, pt.REAL)
    cplan = D._chain_plan(plan)
    tile = pk.chain_core_tile(D._thin_plan(h))
    assert (D.fused_real_fwd_route(plan, 256) is not None) == (tile is not None)
    if tile is None:
        assert cplan is None
        with pytest.raises(ValueError, match="fused real forward kernel"):
            pk._core_launch(D._thin_plan(h), torch.device(CPU), "fused real forward kernel",
                            None, None)
        return
    assert pk._core_launch(cplan, torch.device(CPU), "fused real forward kernel",
                           None, None) == tile
    assert tile.elems == 32 and tile.threads <= pk.CORE_MAX_THREADS
    assert tile.tb == {1024: 16, 2048: 8}.get(h, tile.tb)
    assert tile.threads * tile.elems >= h * tile.tb


def test_real_and_complex_tables_stay_apart():
    """A record for complex plans never moves a real plan of the same
    engine length: real plans route by coverage."""

    rplan, cplan = pt.new_setup(4096, pt.REAL), pt.new_setup(2048)
    D.record_engine((9, 0), 2048, "kern2")
    try:
        assert D.select_engine(cplan, 8) == "kern2"
        assert D.select_engine(rplan, 8) == "chain"
        assert D.fused_real_fwd_route(rplan, 8) is not None
        assert D.packed_fwd_route(rplan, 8) is None
    finally:
        D._MEASURED_TABLE.clear()
    assert not hasattr(D, "record_engine_real")


def test_real_wrappers_on_cpu_run_the_plain_versions():
    h = 96
    plan = D._thin_plan(h)
    tw = tsplit.real_split_twiddle(pt.new_setup(2 * h, pt.REAL), torch.device(CPU))
    (x,) = _rng_planes((2 * h, 6), 4, 1)
    y = torch.from_numpy(x).view(h, 12)
    sr, si = (torch.from_numpy(a) for a in _rng_planes((h, 6), 5))
    wrappers = (pk.cfft_chain_tmajor_packed, pk.rfft_chain_tmajor_fused,
                pk.rfft_bwd_chain_tmajor_fused, pk.real_split_tmajor)
    before = [w.launches for w in wrappers]
    pairs = [
        (pk.cfft_chain_tmajor_packed(plan, y), pk.chain_tmajor_packed_plain(plan, y)),
        (pk.rfft_chain_tmajor_fused(plan, y, tw),
         pk.rfft_chain_tmajor_fused_plain(plan, y, tw)),
        ([pk.rfft_bwd_chain_tmajor_fused(plan, sr, si, tw)],
         [pk.rfft_bwd_chain_tmajor_fused_plain(plan, sr, si, tw)]),
        (pk.real_split_tmajor(sr, si, tw, backward=True),
         pk.real_split_tmajor_plain(sr, si, tw, backward=True)),
    ]
    for got, want in pairs:
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert [w.launches for w in wrappers] == before  # nothing was launched
    with pytest.raises(ValueError, match=r"\[N, 5\*2B\]"):
        pk.cfft_chain_tmajor_packed(plan, y, slabs=5)
    with pytest.raises(ValueError, match="engine length"):
        pk.rfft_chain_tmajor_fused(D._thin_plan(64), y, tw)
    with pytest.raises(ValueError, match="split twiddles"):
        pk.real_split_tmajor(sr, si, (tw[0][:-1], tw[1][:-1]))
    with pytest.raises(ValueError, match=r"\[H, 2B\]"):
        pk.rfft_chain_tmajor_fused(plan, y[:, :11], tw)


@pytest.mark.parametrize("tb,elems", [(None, None), (8, 16), (4, 32), (64, 32)])
def test_fused_real_wrappers_on_cpu_take_launch_overrides(tb, elems):
    """On the CPU the B3 wrappers run their plain versions whatever launch
    shape is asked for (even one no block holds), and launch nothing; the
    backward gives the real signal."""

    h = 96
    plan = D._thin_plan(h)
    tw = tsplit.real_split_twiddle(pt.new_setup(2 * h, pt.REAL), torch.device(CPU))
    (x,) = _rng_planes((2 * h, 6), 14, 1)
    y = torch.from_numpy(x).view(h, 12)
    sr, si = (torch.from_numpy(a) for a in _rng_planes((h, 6), 15))
    wrappers = (pk.rfft_chain_tmajor_fused, pk.rfft_bwd_chain_tmajor_fused)
    before = [w.launches for w in wrappers]
    got = pk.rfft_chain_tmajor_fused(plan, y, tw, tb=tb, elems=elems)
    want = pk.rfft_chain_tmajor_fused_plain(plan, y, tw)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    sig = pk.rfft_bwd_chain_tmajor_fused(plan, sr, si, tw, tb=tb, elems=elems)
    assert torch.equal(sig, pk.rfft_bwd_chain_tmajor_fused_plain(plan, sr, si, tw))
    assert sig.shape == (2 * h, 6)
    assert [w.launches for w in wrappers] == before
