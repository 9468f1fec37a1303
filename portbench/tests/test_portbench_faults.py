"""The whole run on the CPU, the timed path sound and then broken: `correct` follows.

The card's look is skipped (``run_cell(..., device="cpu")``); the port runs
its plain versions; the sizes are cut (``tiny.traffic``).  Each fault is
planted in the cell's entry call, where the answer is produced, once for
each fault a cell of that configuration can have: a step that returns its
state unchanged, half of the rows left out, one answer altered.
"""

import time

import pytest
import torch

import tiny
from portbench import run

SEED = 2**33 + 19


def altered(y: torch.Tensor) -> torch.Tensor:
    y = y.clone()
    y.view(-1)[y.numel() // 3] += 1e-3 * float(y.abs().max())
    return y


def half_rows(y: torch.Tensor) -> torch.Tensor:
    y = y.clone()
    y[y.shape[0] // 2:] = 0
    return y


def fir_fault(kind: str):
    def plant(cell):
        call, u = cell.call, cell.nfft - len(cell.taps) + 1
        if kind == "state":  # one block fewer consumed: the tail it leaves is wrong
            cell.call = lambda x: call(x)[:, :-u]
        elif kind == "rows":
            cell.call = lambda x: half_rows(call(x))
        else:
            cell.call = lambda x: altered(call(x))
    return plant


def chan_fault(kind: str):
    def plant(cell):
        call = cell.call

        def broken(state, xr, xi):
            (yr, yi), new = call(state, xr, xi)
            if kind == "state":
                return (yr, yi), state
            if kind == "rows":
                return (half_rows(yr), half_rows(yi)), new
            return (altered(yr), yi), new

        cell.call = broken
    return plant


def go(workload, plant=None, trace=False):
    return run.run_cell(tiny.BENCH, workload, SEED, 0.2, trace, device="cpu",
                        t0=time.perf_counter(), plant=plant, traffic=tiny.traffic(workload))


@pytest.mark.parametrize("workload", [w["name"] for w in tiny.BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_program_is_correct(workload, trace):
    res = go(workload, trace=trace)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] > 0 and list(res)[-1] == "checks"
    assert set(res["checks"]) == {"rel_err", "bad_chunks"}


@pytest.mark.parametrize("kind", ["state", "rows", "answer"])
@pytest.mark.parametrize("workload", [w["name"] for w in tiny.BENCH["workloads"]])
def test_each_fault_is_caught(workload, kind):
    plant = (fir_fault if workload.startswith("fir") else chan_fault)(kind)
    res = go(workload, plant)
    assert not res["correct"] and res["failed"] > 0, res["checks"]


def test_a_partial_trace_is_refused(monkeypatch):
    seen = iter(range(0, 1000, 5))
    monkeypatch.setattr(run, "launch_count", lambda: next(seen))
    with pytest.raises(run.Refused, match="partial trace"):
        go("chan_bulk", trace=True)


@pytest.mark.parametrize("fault, tries", [("partial", 1), ("clock", 1), ("clock", 3)])
def test_an_unsound_trace_is_traced_again(monkeypatch, capsys, fault, tries):
    """An unsound sub-window (a launch the profiler missed, or device ops
    placed far outside their launch) is tried again on chunks of its own;
    the run goes on with the sound try's numbers, or where every try is
    misplaced, with the try misplaced least."""

    from portbench import trace

    if fault == "partial":
        seen = iter([0, 5])
        monkeypatch.setattr(run, "launch_count", lambda: next(seen, 0))
    else:
        read, calls = trace.read, []

        def misplaced(*args):
            calls.append(1)
            return {**read(*args), "misplaced_us": 4000.0 - len(calls)} \
                if len(calls) <= tries else read(*args)

        monkeypatch.setattr(trace, "read", misplaced)
    res = go("fir_taps1024", trace=True)
    assert res["correct"] and "dispatch.launches_per_chunk" in res["metrics"], res
    err = capsys.readouterr().err
    assert "traced sub-window 1 of 3 (device) unsound" in err
    assert ("a partial trace" if fault == "partial" else "3999.0 µs outside") in err
    assert ("kept the whole sub-window misplaced least, by 3997.0 µs" in err) == (tries == 3)


def test_forbidden_modules_are_named_by_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "pffft_tpu_torch_extra.mod", types.ModuleType("x"))
    assert run.forbidden_modules() == [m for m in run.FORBIDDEN if m in
                                       {k.split(".")[0] for k in sys.modules}]
    monkeypatch.setitem(sys.modules, "pffft_tpu.ops", types.ModuleType("y"))
    assert "pffft_tpu" in run.forbidden_modules()
