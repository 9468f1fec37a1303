"""The port's public transform, pffft_tpu_torch.transform_ordered_split_tmajor,
against pffft_tpu.fft.transform_ordered_split_tmajor on the same numpy
inputs; its routes, errors and the 140 dB carrier bound.

On the CPU the port's kernel wrappers run their plain versions, over the
same routes (chain, kern2, stages) that the card takes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
import pffft_tpu_torch as pt
from pffft_tpu_torch.ops import dispatch as D

# One intra-op thread: the suite runs in several worker processes that share
# the cores, and an oversubscribed OpenMP pool slows each torch call by
# tens of times.
torch.set_num_threads(1)

SIZES = [16, 96, 160, 1024, 2400, 4096, 8192, 65536]
# relative to max|ref|: both sides are f32 FFTs of the same input through
# different stage chains (radix <= 5 in the reference, radix 16/8 in the port)
TOL = 1e-5
CARRIER_DB = 140.0
CPU = "cpu"


def _planes(n, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, b)).astype(np.float32),
            rng.standard_normal((n, b)).astype(np.float32))


def _reference(n, re, im, direction):
    er, ei = pf.fft.transform_ordered_split_tmajor(
        pf.new_setup(n), (jnp.asarray(re), jnp.asarray(im)), direction)
    return np.asarray(er), np.asarray(ei)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("b", [32, 20])  # a multiple of every tile, and ragged
def test_transform_matches_reference(n, b):
    re, im = _planes(n, b, n + b)
    plan = pt.new_setup(n)
    for rdir, tdir in ((pf.FORWARD, pt.FORWARD), (pf.BACKWARD, pt.BACKWARD)):
        er, ei = _reference(n, re, im, rdir)
        gr, gi = pt.transform_ordered_split_tmajor(plan, (re, im), tdir, device=CPU)
        assert gr.dtype == torch.float32 and gr.shape == (n, b)
        scale = max(np.abs(er).max(), np.abs(ei).max())
        assert np.abs(gr.numpy() - er).max() <= TOL * scale, tdir
        assert np.abs(gi.numpy() - ei).max() <= TOL * scale, tdir


@pytest.mark.parametrize("n", [96, 2400, 65536])
def test_round_trip_is_unscaled(n):
    re, im = (torch.from_numpy(a) for a in _planes(n, 6, n))
    keep = re.clone(), im.clone()
    plan = pt.new_setup(n)
    fr, fi = pt.transform_ordered_split_tmajor(plan, (re, im), 0)
    br, bi = pt.transform_ordered_split_tmajor(plan, (fr, fi), 1)
    assert torch.allclose(br / n, re, atol=1e-5) and torch.allclose(bi / n, im, atol=1e-5)
    # the caller's tensors are never modified
    assert torch.equal(re, keep[0]) and torch.equal(im, keep[1])


def test_errors_match_reference():
    n = 96
    plan, rplan = pt.new_setup(n), pf.new_setup(n)
    re, im = _planes(n, 4, 1)
    for bad in ((re[:-1], im[:-1]), (re[0], im[0])):
        with pytest.raises(ValueError) as te:
            pt.transform_ordered_split_tmajor(plan, bad, device=CPU)
        with pytest.raises(ValueError) as rf:
            pf.fft.transform_ordered_split_tmajor(
                rplan, tuple(jnp.asarray(a) for a in bad))
        assert str(te.value) == str(rf.value)
    with pytest.raises(ValueError, match="re and im planes differ"):
        pt.transform_ordered_split_tmajor(plan, (re, im[:, :3]), device=CPU)
    for direction, exc in (("sideways", ValueError), (2.5, TypeError)):
        with pytest.raises(exc) as te:
            pt.transform_ordered_split_tmajor(plan, (re, im), direction, device=CPU)
        with pytest.raises(exc) as rf:
            pf.fft.transform_ordered_split_tmajor(
                rplan, (jnp.asarray(re), jnp.asarray(im)), direction)
        assert str(te.value) == str(rf.value)
    with pytest.raises(ValueError, match="nearest valid: 96"):
        pt.new_setup(95)


def test_unported_plans_raise():
    # the port's Bluestein plan runs through the batch-major split call and
    # matches the reference; the time-major call takes Plans only
    re, im = _planes(2, 97, 5)
    er, ei = pf.transform_ordered_split(pf.bluestein.new_setup_any(97),
                                        (jnp.asarray(re), jnp.asarray(im)))
    gr, gi = pt.transform_ordered_split(pt.new_setup_any(97), (re, im), device=CPU)
    scale = max(np.abs(er).max(), np.abs(ei).max())
    assert np.abs(gr.numpy() - er).max() <= TOL * scale
    assert np.abs(gi.numpy() - ei).max() <= TOL * scale
    x = np.zeros((97, 2), np.float32)
    with pytest.raises(TypeError, match="unsupported plan type BluesteinPlan"):
        pt.transform_ordered_split_tmajor(pt.new_setup_any(97), (x, x), device=CPU)
    # a plan object of the JAX package is a foreign type: the reference's text
    with pytest.raises(TypeError) as te:
        pt.transform_ordered_split(pf.bluestein.new_setup_any(97), (x.T, x.T), device=CPU)
    with pytest.raises(TypeError) as rf:
        pf.transform_ordered_split(pf.bluestein.CztPlan(97), (jnp.asarray(x.T),) * 2)
    assert str(te.value) == str(rf.value).replace("CztPlan for", "BluesteinPlan for")
    # float64 plans are ported (tests/test_torch_f64.py): they run
    y = pt.transform_ordered_split_tmajor(pt.new_setup(64, pt.REAL, dtype="float64"),
                                          x[:64].astype(np.float64), device=CPU)
    assert y[0].dtype == torch.float64 and y[0].shape == (32, 2)


def test_numpy_input_goes_to_the_card_by_default():
    x = np.zeros((16, 2), np.float32)
    if torch.cuda.is_available():
        out, _ = pt.transform_ordered_split_tmajor(pt.new_setup(16), (x, x))
        assert out.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.transform_ordered_split_tmajor(pt.new_setup(16), (x, x))


@pytest.mark.parametrize("n,engine", [
    (16, "chain"), (1024, "chain"), (2048, "chain"), (1920, "chain"),
    (2400, "kern2"), (4096, "kern2"), (65536, "kern2"),
    (131072, "stages"),  # 2048 * 64: no combine radix 64
])
def test_engine_follows_coverage(n, engine):
    plan = pt.new_setup(n)
    assert D.select_engine(plan, 256) == engine
    assert D.select_engine(plan, 256, device=torch.device(CPU)) == engine


def test_unported_dtypes_have_only_the_stage_engine():
    assert D.available_engines(pt.new_setup(1024, dtype="float64"), 8) == ("stages",)
    assert D.available_engines(pt.new_setup(1024, dtype="float64"), 8,
                               time_major=False) == ("stages",)


@pytest.mark.parametrize("engine", D.ENGINES)
def test_every_engine_matches_reference(engine):
    n = 1024
    re, im = _planes(n, 8, 4)
    er, ei = _reference(n, re, im, pf.BACKWARD)
    D.set_engine(engine)
    try:
        gr, gi = pt.transform_ordered_split_tmajor(pt.new_setup(n), (re, im),
                                                   pt.BACKWARD, device=CPU)
    finally:
        D.set_engine(None)
    scale = max(np.abs(er).max(), np.abs(ei).max())
    assert np.abs(gr.numpy() - er).max() <= TOL * scale
    assert np.abs(gi.numpy() - ei).max() <= TOL * scale


def test_forced_and_measured_engines():
    plan = pt.new_setup(4096)
    with pytest.raises(ValueError, match="unknown engine"):
        D.set_engine("pallas")
    D.set_engine("chain")
    try:
        with pytest.raises(ValueError, match="unavailable"):
            D.select_engine(plan, 8)
    finally:
        D.set_engine(None)
    D.record_engine((9, 0), 4096, "stages")
    try:
        assert D.select_engine(plan, 8) == "stages"
        assert D.select_engine(pt.new_setup(2048), 8) == "chain"
    finally:
        D._MEASURED_TABLE.clear()
    assert D.select_engine(plan, 8) == "kern2"


# (kind, N, dtype, time_major) -> the engine coverage picks where nothing
# is recorded (the H100's routes; the CPU is routed as sm_90)
COVERAGE_ROUTES = [
    (("complex", 1024, "float32", True), "chain"),
    (("complex", 4096, "float32", True), "kern2"),
    (("complex", 65536, "float32", True), "kern2"),
    (("complex", 2048, "float64", True), "stages"),
    (("complex", 4096, "float32", False), "fused2"),
    (("real", 4096, "float32", True), "chain"),
    (("real", 16384, "float32", True), "kern2"),
]


@pytest.mark.parametrize("case,engine", COVERAGE_ROUTES)
def test_default_route_is_the_coverage_route(case, engine, monkeypatch):
    kind, n, dtype, time_major = case
    monkeypatch.setattr(D, "_MEASURED_TABLE", {})
    plan = pt.new_setup(n, pt.REAL if kind == "real" else pt.COMPLEX, dtype=dtype)
    for b in (8, 128):
        avail = D.available_engines(plan, b, time_major)
        assert D._choose(plan, b, time_major, None, avail) == engine
        assert D.select_engine(plan, b, time_major) == engine
        assert D.select_engine(plan, b, time_major, torch.device(CPU)) == engine


def test_retired_engine_names_are_unknown():
    assert D.ENGINES == ("stages", "chain", "kern2")
    with pytest.raises(ValueError, match="unknown engine 'ksplit'"):
        D.set_engine("ksplit")
    assert D._FORCED is None
    with pytest.raises(ValueError, match="unknown engine 'ksplit'"):
        D.record_engine((9, 0), 2048, "ksplit")
    assert D._MEASURED_TABLE == {}


def _carrier_columns(n):
    """tests/test_accuracy.py's carrier sweep as time-major columns."""

    ks = list(range(0, n, max(1, n // 16)))
    cols = []
    for j, k in enumerate(ks):
        amp = 1.0 if j % 3 == 0 else 1.1
        phi = (j % 4) * 0.125 * np.pi + 2.0 * np.pi * ((k if k < n / 2 else k - n) / n) \
            * np.arange(n, dtype=np.float64)
        cols.append(amp * np.exp(1j * phi))
    return np.stack(cols, axis=1).astype(np.complex64), ks


@pytest.mark.parametrize("n", [1024, 4096, 65536])
def test_carrier_dynamic_range(n):
    x, ks = _carrier_columns(n)
    yr, yi = pt.transform_ordered_split_tmajor(pt.new_setup(n), (x.real, x.imag),
                                               device=CPU)
    power = yr.double().numpy() ** 2 + yi.double().numpy() ** 2
    for j, k in enumerate(ks):
        p = power[:, j].copy()
        carrier = p[k]
        p[k] = 0.0
        db = 10.0 * (np.log10(carrier) - np.log10(max(p.max(), 1e-300)))
        assert db >= CARRIER_DB, (n, k, db)
