"""The port's own spans and counters (``pffft_tpu_torch.utils.profiling``):
no profiler range with the profiler off, one ``pffft.entry`` a public call
with its decisions nested in it, results unchanged by tracing (also under
``torch.func.vmap`` and with a gradient), the bytes of the entries' layout
copies, and the set-up clock's parts, each timed once and without the parts
nested in it."""

import glob
import json
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pffft_tpu_torch as pt
from pffft_tpu_torch import utils
from pffft_tpu_torch.ops import _build
from pffft_tpu_torch.utils import profiling as P

M, TAPS = 64, 4


def _fir(taps=64, seed=0):
    return pt.FastConv(np.random.default_rng(seed).standard_normal(taps), device="cpu")


def _streams(rows=4, width=5000, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, width, generator=g)


def _chan():
    return pt.Channelizer(M, TAPS, device="cpu")


def _chan_input(rows=2, frames=16, seed=2):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(rows, frames * M, generator=g) for _ in range(2))


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in P.counters.items() if v != before.get(k, 0)}


# the benchmark's two entries, each one call on a small input
def _call_fir():
    return _fir().apply_batched(_streams()[:, 100:4100], flush=False)


def _call_chan():
    ch = _chan()
    (yr, yi), st = ch.process_split(ch.init_state((2,)), *_chan_input())
    return yr, yi, *st


CALLS = {"FastConv.apply_batched": _call_fir, "Channelizer.process_split": _call_chan}


def _spans(log_dir):
    (path,) = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and str(e.get("name")).startswith("pffft.")]


def test_the_new_names_stay_out_of_the_public_lists():
    assert utils.__all__ == ["trace", "device_info", "Roofline"]
    assert P.__all__ == ["trace", "device_info", "Roofline"]
    for name in ("span", "counters", "count", "entry", "decision", "copy", "setup"):
        assert hasattr(P, name)


@pytest.mark.parametrize("entry", sorted(CALLS))
def test_no_profiler_range_with_the_profiler_off(entry, monkeypatch):
    opened = []

    def counting(name, *a, **k):
        opened.append(name)
        return P._NULL

    monkeypatch.setattr(P, "_range", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    CALLS[entry]()
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        CALLS[entry]()
    assert "pffft.entry" in opened  # the counting stand-ins are the ones a span opens


def test_spans_fall_back_to_record_function_where_torch_lacks_the_fast_range(tmp_path):
    # a torch without the C++ range: the package still imports, and its spans
    # are record_function ranges of the same names
    code = f"""
import glob, json, torch
del torch._C._profiler._RecordFunctionFast
import pffft_tpu_torch as pt
from pffft_tpu_torch.utils import profiling as P
fc = pt.FastConv([1.0, 2.0, 3.0], device="cpu")
with P.trace({str(tmp_path)!r}):
    fc.apply_batched(torch.ones(2, 300), flush=False)
(path,) = glob.glob({str(tmp_path)!r} + "/*.pt.trace.json")
print(sorted({{e["name"] for e in json.load(open(path))["traceEvents"]
               if str(e.get("name")).startswith("pffft.")}}))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        os.path.dirname(os.path.dirname(os.path.abspath(pt.__file__))),
        os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    names = out.stdout.strip().splitlines()[-1]
    assert "'pffft.entry'" in names and "'pffft.dispatch'" in names, names


@pytest.mark.parametrize("entry", sorted(CALLS))
def test_one_entry_span_holds_its_decisions(entry, tmp_path):
    with P.trace(str(tmp_path)):
        CALLS[entry]()
    spans = _spans(tmp_path)
    (outer,) = [e for e in spans if e["name"] == "pffft.entry"]
    inner = [e for e in spans if e is not outer]
    assert {e["name"] for e in inner} <= {"pffft.dispatch", "pffft.layout"}
    assert any(e["name"] == "pffft.dispatch" for e in inner)
    t0, t1 = outer["ts"], outer["ts"] + outer["dur"]
    for e in inner:
        assert t0 <= e["ts"] and e["ts"] + e["dur"] <= t1, e["name"]
        assert e["tid"] == outer["tid"]
    # no launch on the CPU: each wrapper runs its plain version
    assert not any(e["name"] == "pffft.launch" for e in spans)


def _traced(fn, log_dir):
    with P.trace(str(log_dir)):
        return fn()


def _vmapped_fir():
    fc = _fir()
    return torch.func.vmap(lambda r: fc.apply_batched(r, flush=False))(
        _streams(6, 4000).view(3, 2, 4000)[..., :3500])


def _vmapped_chan():
    ch = _chan()
    xr, xi = (t.view(2, 1, -1) for t in _chan_input())
    (yr, yi), st = torch.func.vmap(lambda r, i: ch.process_split(ch.init_state((1,)), r, i))(
        xr, xi)
    return yr, yi, *st


def _grad_fir():
    x = _streams(2, 4000).requires_grad_()
    (_fir().apply_batched(x, flush=False) ** 2).sum().backward()
    return x.grad


def _grad_chan():
    xr, xi = (t.requires_grad_() for t in _chan_input())
    ch = _chan()
    (yr, yi), _ = ch.process_split(ch.init_state((2,)), xr, xi)
    (yr ** 2 + yi).sum().backward()
    return xr.grad, xi.grad


RUNS = {"fir": _call_fir, "chan": _call_chan, "fir-vmap": _vmapped_fir,
        "chan-vmap": _vmapped_chan, "fir-grad": _grad_fir, "chan-grad": _grad_chan}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tracing_leaves_the_results_bit_identical(run, tmp_path):
    plain = RUNS[run]()
    traced = _traced(RUNS[run], tmp_path)
    plain, traced = ((t,) if torch.is_tensor(t) else t for t in (plain, traced))
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    assert any(e["name"] == "pffft.entry" for e in _spans(tmp_path))


def _fir_strided():
    x = _streams(4, 5000)[:, 100:4100]
    return _fir().apply_batched, x, 4 * 4000 * 4


def _fir_contiguous():
    return _fir().apply_batched, _streams(4, 4000), 0


def _chan_step():
    ch = _chan()
    xr, xi = _chan_input(rows=3, frames=16)
    # both output planes [3, 16, M] moved from [M, 3*16], and the new state's
    # two planes of P*M samples a stream
    return (lambda a, b: ch.process_split(ch.init_state((3,)), a, b), (xr, xi),
            2 * 3 * 16 * M * 4 + 2 * 3 * TAPS * M * 4)


def _chan_short_step():
    ch = _chan()
    xr, xi = _chan_input(rows=3, frames=2)  # K < P: the state is a concatenation
    return (lambda a, b: ch.process_split(ch.init_state((3,)), a, b), (xr, xi),
            2 * 3 * 2 * M * 4 + 2 * 3 * TAPS * M * 4)


def _fir_tmajor():
    # nfft 8192 on the "tmajor" route (forced: the stream map holds nfft
    # 8192): it frames 2 rows of 40000 at u = 4097 into 8 blocks (4 column
    # pairs a row, 8 columns of 8192), then keeps 4097 samples of each of
    # the 8 frames of each row
    x = _streams(2, 40000)
    fc = _fir(4096)
    fc._force_conv_kernel = "tmajor"
    return fc.apply_batched, x, 2 * 8192 * 8 * 4 + 2 * 8 * 4097 * 4


COPIES = {"fir-strided": _fir_strided, "fir-contiguous": _fir_contiguous,
          "chan-step": _chan_step, "chan-short-step": _chan_short_step,
          "fir-tmajor": _fir_tmajor}


@pytest.mark.parametrize("case", sorted(COPIES))
def test_copy_bytes_of_an_entry(case):
    fn, x, want = COPIES[case]()
    args = x if isinstance(x, tuple) else (x,)
    if case.startswith("fir"):
        args = (*args, False)
    before = dict(P.counters)
    fn(*args)
    got = _delta(before)
    assert got.get("entry.copy_bytes", 0) == want
    assert sum(v for k, v in got.items() if k.startswith("entry.calls.")) == 1


def test_entries_count_their_calls():
    before = dict(P.counters)
    fc = _fir()
    fc.apply_batched(_streams(2, 3000), flush=False)
    fc.apply(_streams(1, 3000)[0])
    _call_chan()
    got = _delta(before)
    assert {k: v for k, v in got.items() if k.startswith("entry.calls.")} == {
        "entry.calls.FastConv.apply_batched": 1, "entry.calls.FastConv.apply": 1,
        "entry.calls.Channelizer.process_split": 1}
    # a decision counts nothing: its span carries its name alone
    assert not any(k.startswith("dispatch.") for k in P.counters)


def test_copies_inside_a_plain_kernel_are_not_counted():
    x = torch.ones(3, 5)
    before = P.counters.get("entry.copy_bytes", 0)
    with P.uncounted():
        P.copy("test", torch.cat, [x, x])
    assert P.counters.get("entry.copy_bytes", 0) == before
    P.copy("test", torch.cat, [x, x])
    assert P.counters["entry.copy_bytes"] - before == 2 * 3 * 5 * 4


def _grows(part, fn):
    key = f"setup.seconds.{part}"
    before = P.counters.get(key, 0)
    fn()
    return P.counters.get(key, 0) - before


def test_a_plan_miss_is_timed_and_a_hit_is_not():
    make = lambda: pt.plan.Plan.create(2 * 3 ** 4 * 5 ** 3, pt.COMPLEX, "float32",
                                       strict=False, factors=(2, 81, 125))
    assert _grows("plan", make) > 0
    assert _grows("plan", make) == 0


def test_a_spectrum_miss_is_timed_and_a_hit_is_not():
    fc = _fir(96, seed=7)
    x = _streams(2, 3000)
    assert _grows("spectrum", lambda: fc.apply_batched(x, flush=False)) > 0
    assert _grows("spectrum", lambda: fc.apply_batched(x, flush=False)) == 0


def test_a_library_load_is_timed_once(monkeypatch):
    lib = SimpleNamespace(pf_error_string=SimpleNamespace())
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build", lambda names: 0.0)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    assert _grows("load", lambda: _build.load("pfb_fir")) > 0
    assert _grows("load", lambda: _build.load("pfb_fir")) == 0


def test_the_package_import_is_timed():
    assert P.counters["setup.seconds.import"] > 0


def test_nested_set_up_parts_add_up_to_the_outer_wall(monkeypatch):
    clock = iter([10.0, 11.0, 13.0, 17.0])  # outer in, inner in, inner out, outer out
    monkeypatch.setattr(P, "time", SimpleNamespace(perf_counter=lambda: next(clock)))
    before = dict(P.counters)
    with P.setup("outer_test"):
        with P.setup("inner_test"):
            pass
    got = _delta(before)
    assert got == {"setup.seconds.outer_test": 5.0, "setup.seconds.inner_test": 2.0}
    for k in got:
        del P.counters[k]


def test_concurrent_counts_lose_no_update():
    threads, each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [P.count("stress_test") for _ in range(each)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert P.counters.pop("stress_test") == threads * each
