"""The port's measure mode (``pffft_tpu_torch.tune``) against the JAX
package's (``pffft_tpu.tune``) on the CPU: the same candidates, the same
plans for the same policy, the disk cache's format, and the port's own
rules: no failure is swallowed, and the engine race is held with a fixed
timer so that its winner does not depend on the machine's noise."""

import json
import platform

import numpy as np
import pytest

from pffft_tpu import plan as ref_plan
from pffft_tpu import tune as ref_tune
from pffft_tpu_torch import plan as tplan
from pffft_tpu_torch import tune as T
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import pallas_fft as pk

SIZES = (64, 1024, 4096, 65536, 1 << 20)
KINDS = ("complex", "real")
CPU_TAG = f"cpu-{platform.machine()}"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Empty caches and measured tables, restored after each test."""

    monkeypatch.setattr(T, "_MEM_CACHE", {})
    monkeypatch.setattr(D, "_MEASURED_TABLE", {})
    monkeypatch.delenv("PFFFT_TPU_TUNE_CACHE", raising=False)
    yield
    assert D._FORCED is None


def _kinds(kind):
    return (tplan.REAL, ref_plan.REAL) if kind == "real" else (tplan.COMPLEX, ref_plan.COMPLEX)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_candidates_equal_reference(n, kind):
    tk, rk = _kinds(kind)
    assert T.candidate_policies(n, tk) == ref_tune.candidate_policies(n, rk)
    assert T.candidate_max_factors(n, tk) == ref_tune.candidate_max_factors(n, rk)


def _policies(n, kind):
    tk, rk = _kinds(kind)
    engine_n = n // 2 if kind == "real" else n
    chain = tuple(tplan.plan_factors(engine_n, max_factor=16))
    return list(ref_tune.candidate_policies(n, rk)) + [("chain", chain)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", (64, 1024, 4096))
def test_tuned_setup_plan_equals_reference_policy_plan(n, kind):
    tk, rk = _kinds(kind)
    for pol in _policies(n, kind):
        T.clear_tune_cache()
        got = T.tuned_setup(n, tk, candidates=[pol], batch=4, iters=1, device="cpu")
        want = ref_tune._policy_plan(n, rk, "float32", pol)
        assert got.factors == want.factors, pol
        assert got.local_split is None and want.local_split is None, pol
        assert (got.n, got.engine_n, got.kind.value) == (want.n, want.engine_n, want.kind.value)


@pytest.mark.parametrize("n", (65536, 1 << 20))
def test_large_mf64_policy_is_a_chain_in_the_port(n):
    """The port's planner builds no local split (``plan.py``); the reference
    builds one for ("mf", 64) above 64^2, so there the policies' plans
    differ by design; every other policy's plan is the reference's."""

    want = ref_tune._policy_plan(n, ref_plan.COMPLEX, "float32", ("mf", 64))
    got = T._policy_plan(n, tplan.COMPLEX, "float32", ("mf", 64))
    assert want.local_split is not None and got.local_split is None
    assert got.factors == tplan.plan_factors(n, max_factor=64)
    for pol in (("mf", 5), ("chain", tplan.plan_factors(n, max_factor=16))):
        assert (T._policy_plan(n, tplan.COMPLEX, "float32", pol).factors
                == ref_tune._policy_plan(n, ref_plan.COMPLEX, "float32", pol).factors)


def test_tuned_setup_times_each_candidate_and_keeps_the_fastest(monkeypatch):
    # float64: no kernel covers it, so the stage engine runs the policy
    times = {("mf", 5): 2.0, ("mf", 64): 1.0}
    seen = []

    def fake(n, kind, dtype, policy, batch, iters, device):
        seen.append(policy)
        return times[policy]

    monkeypatch.setattr(T, "_time_plan", fake)
    plan = T.tuned_setup(4096, dtype="float64", device="cpu")
    assert seen == [("mf", 5), ("mf", 64)]
    assert plan.factors == tplan.plan_factors(4096, max_factor=64)
    assert T._MEM_CACHE == {f"{CPU_TAG}:4096:complex:float64": ("mf", 64)}
    seen.clear()
    assert T.tuned_setup(4096, dtype="float64", device="cpu") is plan  # cached
    assert seen == []


@pytest.mark.parametrize("n, kind", [(1024, "complex"), (4096, "complex"),
                                     (65536, "complex"), (8192, "real")])
def test_tuned_setup_times_nothing_where_one_kernel_runs_every_candidate(
        tmp_path, monkeypatch, n, kind):
    """The kernels run their own chains whatever the plan's factors: the
    candidates would do identical work, so none is timed or cached."""

    def no_timing(*a, **k):
        raise AssertionError("candidates on one kernel route were timed")

    path = tmp_path / "tune.json"
    monkeypatch.setenv("PFFFT_TPU_TUNE_CACHE", str(path))
    monkeypatch.setattr(T, "_time_plan", no_timing)
    tk, _ = _kinds(kind)
    engine_n = n // 2 if kind == "real" else n
    routes = {T._kernel_route(T._policy_plan(engine_n, tplan.COMPLEX, "float32", pol), 64,
                              T._device("cpu"))
              for pol in T.candidate_policies(n, tk)}
    assert len(routes) == 1 and None not in routes
    plan = T.tuned_setup(n, tk, device="cpu")
    assert plan == tplan.Plan.create(n, tk, strict=False)  # the default policy's plan
    assert T._MEM_CACHE == {} and not path.exists()


def test_kernel_route_is_none_on_the_stage_engine():
    cpu = T._device("cpu")
    assert T._kernel_route(tplan.new_setup(4096, dtype="float64"), 64, cpu) is None
    assert T._kernel_route(tplan.new_setup(4096), 64, cpu) == "fused2"


def test_cache_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("PFFFT_TPU_TUNE_CACHE", str(path))
    T.tuned_setup(1024, dtype="float64", candidates=[("mf", 64)], batch=4, iters=1,
                  device="cpu")
    T.tuned_setup(2048, tplan.REAL, "float64", candidates=[("chain", (8, 16, 8))], batch=4,
                  iters=1, device="cpu")
    disk = json.loads(path.read_text())
    assert disk == {f"{CPU_TAG}:1024:complex:float64": ["mf", 64],
                    f"{CPU_TAG}:2048:real:float64": ["chain", [8, 16, 8]]}

    def no_timing(*a, **k):
        raise AssertionError("a cached policy was timed again")

    T.clear_tune_cache()
    monkeypatch.setattr(T, "_time_plan", no_timing)
    assert (T.tuned_setup(1024, dtype="float64", device="cpu").factors
            == tplan.plan_factors(1024, max_factor=64))
    assert T.tuned_setup(2048, tplan.REAL, "float64", device="cpu").factors == (8, 16, 8)


def test_cache_reads_reference_format_values_under_its_own_keys(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({
        f"{CPU_TAG}:4096:complex:float32": ["chain", [16, 16, 16]],
        f"{CPU_TAG}:1024:complex:float32": 64,          # a bare int: ("mf", 64)
        "cpu:8192:complex:float64": ["mf", 64],           # the reference's key
    }))
    monkeypatch.setenv("PFFFT_TPU_TUNE_CACHE", str(path))
    assert T.tuned_setup(4096, device="cpu").factors == (16, 16, 16)
    assert T.tuned_setup(1024, device="cpu").factors == tplan.plan_factors(1024, max_factor=64)
    assert T._coerce_policy(["mf", 5.0]) == ("mf", 5)
    timed = []
    monkeypatch.setattr(T, "_time_plan", lambda n, *a: timed.append(n) or 1.0)
    T.tuned_setup(8192, dtype="float64", device="cpu")  # the reference's winner is not the port's
    assert timed == [8192, 8192]


def test_corrupt_cache_file_raises(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    path.write_text("{not json")
    monkeypatch.setenv("PFFFT_TPU_TUNE_CACHE", str(path))
    with pytest.raises(json.JSONDecodeError):
        T.tuned_setup(1024, device="cpu")
    path.write_text("[1, 2]")
    with pytest.raises(ValueError, match="JSON object"):
        T.tuned_setup(1024, device="cpu")
    path.write_text(json.dumps({f"{CPU_TAG}:1024:complex:float32": "mf64"}))
    with pytest.raises(ValueError):
        T.tuned_setup(1024, device="cpu")


def test_unwritable_cache_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PFFFT_TPU_TUNE_CACHE", str(tmp_path / "missing_dir" / "tune.json"))
    with pytest.raises(FileNotFoundError):
        T.tuned_setup(1024, dtype="float64", candidates=[("mf", 5)], batch=4, iters=1,
                      device="cpu")


@pytest.mark.parametrize("time_major, n, times, winner", [
    (True, 1024, {"stages": 3.0, "chain": 1.0, "kern2": 2.0}, "chain"),
    (True, 4096, {"stages": 1.0, "kern2": 2.0}, "stages"),
    (True, 8192, {"stages": 3.0, "kern2": 2.0}, "kern2"),
    (True, 2048, {"stages": 3.0, "chain": 2.0, "kern2": 1.0}, "kern2"),
    (False, 4096, {"stages": 3.0, "fused2": 2.5, "tmajor": 1.5}, "tmajor"),
    (False, 1024, {"stages": 3.0, "fused2": 0.5, "tmajor": 1.5}, "fused2"),
])
def test_tune_engine_picks_the_winner_and_records_nothing_on_the_cpu(
        monkeypatch, time_major, n, times, winner):
    """The dispatcher routes the CPU as sm_90: a CPU race must leave the
    card's (9, 0) entry as it was."""

    calls = []

    def fixed(engine, call, device, iters):
        calls.append(engine)
        return times[engine]

    monkeypatch.setattr(T, "_time_engine", fixed)
    plan = tplan.new_setup(n)
    assert set(D.available_engines(plan, 8, time_major, "cpu")) == set(times)
    card = next(e for e in times if e != winner)
    D._MEASURED_TABLE[((9, 0), n, time_major)] = card
    assert T.tune_engine(n, 8, time_major=time_major, rounds=2, device="cpu") == winner
    assert D._MEASURED_TABLE == {((9, 0), n, time_major): card}
    assert sorted(calls) == sorted(list(times) * 2)
    assert D.select_engine(plan, 8, time_major, "cpu") == card


def test_tune_engine_on_the_cpu_times_every_engine_and_records_nothing(monkeypatch):
    seen = []
    real = T._time_engine
    monkeypatch.setattr(T, "_time_engine",
                        lambda e, *a: (seen.append(e), real(e, *a))[1])
    got = T.tune_engine(1024, 8, rounds=1, iters=1, device="cpu")
    assert sorted(seen) == ["chain", "kern2", "stages"] and got in seen
    assert D._MEASURED_TABLE == {}


def test_an_engine_that_raises_propagates(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("chain kernel launch failed")

    monkeypatch.setattr(pk, "cfft_chain_tmajor", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        T.tune_engine(1024, 8, rounds=1, iters=1, device="cpu")
    assert D._FORCED is None and D._MEASURED_TABLE == {}


def test_single_engine_short_circuit(monkeypatch):
    def no_timing(*a, **k):
        raise AssertionError("a lone engine was timed")

    monkeypatch.setattr(T, "_time_engine", no_timing)
    plan = tplan.new_setup(4096, dtype="float64")
    assert D.available_engines(plan, 8, True, "cpu") == ("stages",)
    assert T.tune_engine(4096, 8, dtype="float64", device="cpu") == "stages"
    assert D._MEASURED_TABLE == {}


def test_seconds_per_call_runs_the_call_per_window(monkeypatch):
    calls = []
    t = T._seconds_per_call(lambda: calls.append(1), T._device("cpu"), 4)
    assert t >= 0 and len(calls) == 1 + T._WINDOWS * 4
    assert np.isfinite(t)
