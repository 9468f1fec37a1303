"""The readers of the port's own spans and counters (``entry.span_idle_us``,
``entry.copy_mb_per_chunk``, ``setup.port_s``): each on a hand-made run
record, each with nothing sound to read, and each in a traced CPU run of
every cell."""

import sys
import time
from types import ModuleType, SimpleNamespace

import pytest

import tiny
from portbench import run

PROFILING = "pffft_tpu_torch.utils.profiling"
NEW = ("entry.span_idle_us", "entry.copy_mb_per_chunk", "setup.port_s")


def read(name: str, **record):
    return run.load("metrics", name).read(SimpleNamespace(**record))


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's profiling module, with spans and the
    counters the test gives it."""

    mod = ModuleType(PROFILING)
    mod.span = lambda *a, **k: None
    mod.counters = {}
    monkeypatch.setitem(sys.modules, PROFILING, mod)
    return mod


@pytest.fixture
def parent(monkeypatch):
    """A program with no spans and no counters, as before they were added."""

    monkeypatch.setitem(sys.modules, PROFILING, ModuleType(PROFILING))


GAPS = [["portbench.chunk", 0.004], ["pffft.launch", 0.06], ["aten::cat", 0.01],
        ["pffft.entry", 0.02], ["harness", 0.5], ["pffft.layout", 0.0004]]


def test_span_idle_sums_the_ports_gaps_a_chunk(program):
    trace = {"chunks": 400, "idle_gaps": GAPS}
    assert read("entry.span_idle_us", trace=trace) == pytest.approx(
        (0.06 + 0.02 + 0.0004) / 400 * 1e6)


def test_span_idle_reads_zero_where_the_port_names_no_gap(program):
    trace = {"chunks": 60, "idle_gaps": [["aten::cat", 0.01], ["harness", 0.02]]}
    assert read("entry.span_idle_us", trace=trace) == 0.0


@pytest.mark.parametrize("trace", [None, {"chunks": 0, "idle_gaps": GAPS}, {"chunks": 400}],
                         ids=["untraced", "no-chunks", "no-gap-list"])
def test_span_idle_gives_nothing_without_a_gap_list(program, trace):
    assert read("entry.span_idle_us", trace=trace) is None


def test_span_idle_gives_nothing_for_a_program_without_spans(parent):
    assert read("entry.span_idle_us", trace={"chunks": 400, "idle_gaps": GAPS}) is None


def test_copy_mb_is_the_bytes_an_entry_call(program):
    program.counters.update({"entry.copy_bytes": 3 * 268_566_528,
                             "entry.calls.FastConv.apply_batched": 2,
                             "entry.calls.Channelizer.process_split": 1,
                             "setup.seconds.plan": 0.5})
    assert read("entry.copy_mb_per_chunk") == pytest.approx(268.566528)


def test_copy_mb_reads_zero_for_entries_that_copy_nothing(program):
    program.counters["entry.calls.FastConv.apply_batched"] = 5
    assert read("entry.copy_mb_per_chunk") == 0.0


@pytest.mark.parametrize("counters", [{}, {"entry.copy_bytes": 1000}],
                         ids=["empty", "no-entry-call"])
def test_copy_mb_gives_nothing_without_an_entry_call(program, counters):
    program.counters.update(counters)
    assert read("entry.copy_mb_per_chunk") is None


def test_setup_sums_the_ports_own_parts(program):
    program.counters.update({"setup.seconds.import": 0.9, "setup.seconds.load": 0.25,
                             "setup.seconds.plan": 0.125, "setup.seconds.spectrum": 0.0625,
                             "entry.copy_bytes": 7})
    assert read("setup.port_s") == pytest.approx(1.3375)


def test_setup_gives_nothing_without_parts(program):
    assert read("setup.port_s") is None


@pytest.mark.parametrize("name", ["entry.copy_mb_per_chunk", "setup.port_s"])
def test_counter_readers_give_nothing_for_a_program_without_counters(parent, name):
    assert read(name) is None


@pytest.mark.parametrize("workload", [w["name"] for w in tiny.BENCH["workloads"]])
def test_a_traced_cpu_run_reports_all_three(workload):
    res = run.run_cell(tiny.BENCH, workload, 11, 0.2, True, device="cpu",
                       t0=time.perf_counter(), traffic=tiny.traffic(workload))
    assert res["correct"], res["checks"]
    for name in NEW:
        assert res["metrics"][name]["value"] >= 0, name
    assert res["metrics"]["setup.port_s"]["value"] > 0
    # the CPU runs the strided FIR rows through the contiguous copy, and the
    # channelizer through its state and output copies
    assert res["metrics"]["entry.copy_mb_per_chunk"]["value"] > 0
