"""A cell of more than one chip runs as a world of ranks, one process a card.

A toy sharded cell is added, as new files, to a copy of ``portbench`` and
``BENCHMARK.json`` with ``"chips": 4``, and run as a gloo world of 4 on the
CPU through the command line's own entry (``run.main(..., device="cpu")``).
Each world is spawned once per module, with the 60 s process-group timeout
and the 120 s deadline of ``tests/torch_parallel_worker.py``; the world whose
rank never reaches a collective gets a 15 s deadline, so that the deadline,
not a timeout, ends it.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import run
from test_portbench_registry import TOY_CELL

ROOT = Path(__file__).resolve().parents[2]
GROUP_TIMEOUT_S = 60
DEADLINE_S = 120
WIDTH = 64
SEED = 2**33 + 7

TOY_WORLD_CELL = '''
"""A sharded toy: rank r feeds its own row of a seeded [world, width] table
plus the chunk's index, and returns the sum of its row and every lower
rank's, gathered from them.  ``fault`` and ``fault_rank`` in the traffic
plant a fault on one rank."""

import time

import torch
import torch.distributed as dist

from ..run import Refused


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        gen = torch.Generator().manual_seed(seed % 2**63)
        self.rows = torch.randn(self.world, config["width"], generator=gen).to(device)
        self.fault = traffic.get("fault") if self.rank == traffic.get("fault_rank") else None
        self.chunks = 0
        if self.fault == "sleep":  # never reaches a collective
            time.sleep(3600)
        if self.fault == "partial":  # its first traced sub-window counts a launch unseen
            from .. import run
            counts = iter([0, 1])
            run.launch_count = lambda: next(counts, 0)

    def feed(self):
        return (self.rows[self.rank] + self.chunks,)

    def call(self, x):
        if self.fault == "refuse" and self.chunks == 2:
            raise Refused("the toy's rank refuses chunk 2")
        if self.fault == "hang" and self.chunks == 2:  # waits for a message never sent
            dist.recv(torch.empty_like(x), src=(self.rank + 1) % self.world)
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        y = torch.stack(parts[:self.rank + 1]).sum(0)
        if self.fault == "answer":
            y[0] += 1.0
        return y

    def advance(self, y):
        self.chunks += 1
        return (self.rank + 1) * int(y.numel())

    def keep(self, y):
        return y

    def work(self, first, last):
        return 8.0 * self.rows.shape[1] * (last - first), float(self.rows.shape[1]) * (last - first)

    def release(self):
        pass

    def check(self, kept, limits):
        errs = {c: float((y - (self.rows[:self.rank + 1] + c).sum(0)).abs().max())
                for c, y in kept}
        wrong = {c for c, e in errs.items() if e > limits["abs_err"]}
        return [("abs_err", max(errs.values()), limits["abs_err"])], wrong
'''

TOY_SAMPLES = '''
def read(run):
    return float(run.samples)
'''

# workload -> the traffic's fault fields
WORLDS = {
    "toy.world": {},
    "toy.fault": {"fault": "answer", "fault_rank": 2},
    "toy.refuse": {"fault": "refuse", "fault_rank": 1},
    "toy.hang": {"fault": "hang", "fault_rank": 2},
    "toy.sleep": {"fault": "sleep", "fault_rank": 1},
    "toy.partial": {"fault": "partial", "fault_rank": 2},
}


def install(tmp: Path, chips: int) -> None:
    """A copy of the benchmark with the toy cells added: ``toy.one`` on one
    chip, the ``WORLDS`` on ``chips``."""

    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    pb = tmp / "portbench"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = {"scale": 3.0, "warm_chunks": 3, "check_chunks": 3, "trace_chunks": 4}
    for name, source in (("toy_one", TOY_CELL), ("toy_world", TOY_WORLD_CELL)):
        (pb / "configs" / f"{name}.py").write_text(source)
        (pb / "configs" / f"{name}.json").write_text(json.dumps({"width": WIDTH}))
        (pb / "reference" / f"{name}.py").write_text('"""Sums of seeded rows."""\n')
        bench["configs"].append({"name": name, "source": "https://example.org/toy",
                                 "file": f"portbench/configs/{name}.json", "reduced": [],
                                 "why": "a test"})
    (pb / "traffic" / "toy_one.json").write_text(json.dumps({**mix, "limits": {"rel_err": 0.0}}))
    bench["workloads"].append({"name": "toy.one", "config": "toy_one", "traffic": "toy_one",
                               "chips": 1, "why": "a test"})
    for name, fault in WORLDS.items():
        traffic = name.replace(".", "_")
        (pb / "traffic" / f"{traffic}.json").write_text(
            json.dumps({**mix, **fault, "limits": {"abs_err": 1e-5}}))
        bench["workloads"].append({"name": name, "config": "toy_world", "traffic": traffic,
                                   "chips": chips, "why": "a test"})
    (pb / "metrics" / "toy.samples.py").write_text(TOY_SAMPLES)
    cells = [w["name"] for w in bench["workloads"] if w["name"].startswith("toy.")]
    bench["per_layer"].append({"name": "toy.samples", "unit": "samples", "better": "higher",
                               "source": "program_counter", "layer": "toy",
                               "moves": "msamples_s", "workloads": cells})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))


MAIN = ("import sys\nfrom portbench import run\n"
        "sys.exit(run.main(sys.argv[3:], device='cpu', deadline_s=float(sys.argv[1]),\n"
        "                  group_timeout_s=float(sys.argv[2])))\n")


def start(tmp: Path, workload: str, trace: int, deadline_s: float = DEADLINE_S):
    cmd = [sys.executable, "-c", MAIN, str(deadline_s), str(GROUP_TIMEOUT_S),
           "--workload", workload, "--seed", str(SEED), "--seconds", "0.3",
           "--trace", str(trace)]
    return subprocess.Popen(cmd, cwd=tmp, env=dict(os.environ, PYTHONPATH=str(tmp)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc, t0: float, limit: float) -> dict:
    out, err = proc.communicate(timeout=limit)
    last = out.strip().splitlines()[-1] if out.strip() else None
    return {"rc": proc.returncode, "result": json.loads(last) if last else None, "err": err,
            "seconds": time.monotonic() - t0}


def left_in(root: Path) -> list:
    """Processes whose working directory is ``root``."""

    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            if os.readlink(f"/proc/{pid}/cwd") == str(root):
                found.append(int(pid))
        except OSError:
            pass
    return found


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{(workload, trace): its run}; the hanging world runs beside the others."""

    tmp = tmp_path_factory.mktemp("world")
    install(tmp, 4)
    t_hang = time.monotonic()
    hang = start(tmp, "toy.hang", 0)
    got = {}
    for workload, trace, deadline in [("toy.one", 0, DEADLINE_S), ("toy.one", 1, DEADLINE_S),
                                      ("toy.world", 0, DEADLINE_S), ("toy.world", 1, DEADLINE_S),
                                      ("toy.fault", 0, DEADLINE_S), ("toy.refuse", 0, DEADLINE_S),
                                      ("toy.partial", 1, DEADLINE_S),
                                      ("toy.sleep", 0, 15)]:
        t0 = time.monotonic()
        got[workload, trace] = finish(start(tmp, workload, trace, deadline), t0, deadline + 60)
    got["toy.hang", 0] = finish(hang, t_hang, DEADLINE_S + 60)
    got["left"] = left_in(tmp)
    got["calibrate"] = subprocess.run(
        [sys.executable, "-c", "import sys\nfrom portbench import calibrate\n"
         "sys.exit(calibrate.main(sys.argv[1:], device='cpu'))",
         "--workload", "toy.world", "--seeds", "5,6", "--chunks", "4"],
        cwd=tmp, env=dict(os.environ, PYTHONPATH=str(tmp)), capture_output=True, text=True,
        timeout=DEADLINE_S)
    return got


def test_a_world_of_four_is_correct_and_counts_every_rank(worlds):
    for trace in (0, 1):
        w = worlds["toy.world", trace]
        assert w["rc"] == 0, w["err"][-3000:]
        res = w["result"]
        assert res["correct"] and res["failed"] == 0, res["checks"]
        assert res["device"]["count"] == 4 and res["attempted"] > 0
        assert list(res)[-1] == "checks"
    traced = worlds["toy.world", 1]["result"]
    # ranks 0 .. 3 count 1, 2, 3, 4 rows of WIDTH a chunk: the samples are the sum
    assert traced["metrics"]["toy.samples"]["value"] == traced["attempted"] * WIDTH * 10
    assert traced["device"]["busy_s"] >= 0 and traced["device"]["window_s"] > 0


def test_each_ranks_memory_goes_to_standard_error_and_the_fullest_to_the_result(worlds):
    w = worlds["toy.world", 1]
    lines = w["err"].strip().splitlines()
    ranks = [ln for ln in lines if ln.startswith("rank ") and "memory_peak_bytes" in ln]
    assert [ln.split(":")[0] for ln in ranks] == [f"rank {r}" for r in range(4)]
    peaks = [int(ln.split("memory_peak_bytes ")[1].split()[0]) for ln in ranks]
    assert w["result"]["device"]["memory_peak_bytes"] == max(peaks)
    # the comparisons stay the last lines
    assert lines.index(ranks[-1]) < next(i for i, ln in enumerate(lines)
                                         if ln.startswith("window:"))
    assert lines[-1].startswith("check abs_err")


def test_a_fault_on_one_rank_fails_correct(worlds):
    w = worlds["toy.fault", 0]
    assert w["rc"] == 0, w["err"][-3000:]
    assert not w["result"]["correct"]
    assert w["result"]["failed"] == 3  # every kept chunk, judged wrong on rank 2 alone
    assert w["result"]["checks"]["abs_err"]["value"] >= 1.0


def test_an_unsound_trace_on_one_rank_is_traced_again_on_every_rank(worlds):
    w = worlds["toy.partial", 1]
    assert w["rc"] == 0, w["err"][-3000:]
    assert w["result"]["correct"] and w["result"]["device"]["count"] == 4
    said = [ln for ln in w["err"].splitlines() if "traced sub-window 1 of 3 (device) unsound" in ln]
    assert len(said) == 4 and sum("a partial trace" in ln for ln in said) == 1, said


def test_a_rank_that_refuses_ends_the_run_with_its_message(worlds):
    w = worlds["toy.refuse", 0]
    assert w["rc"] == 2 and w["result"] is None
    assert "rank 1: the toy's rank refuses chunk 2" in w["err"]
    assert w["seconds"] < DEADLINE_S


@pytest.mark.parametrize("workload, deadline", [("toy.hang", DEADLINE_S), ("toy.sleep", 15)])
def test_a_hung_rank_is_killed_within_the_deadline(worlds, workload, deadline):
    w = worlds[workload, 0]
    assert w["rc"] == 2 and w["result"] is None, w["err"][-3000:]
    assert w["seconds"] < deadline + 20
    assert "every rank was ended" in w["err"]
    if workload == "toy.sleep":
        assert f"not done within {deadline} s" in w["err"]


def test_no_rank_is_left_behind(worlds):
    assert worlds["left"] == []


def test_the_one_chip_result_keeps_its_keys(worlds):
    for trace in (0, 1):
        w = worlds["toy.one", trace]
        assert w["rc"] == 0, w["err"][-3000:]
        res = w["result"]
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(res) == keys + (["breakdown"] if trace else []) + ["checks"]
        assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
            {"busy_s", "window_s"} if trace else set())
        assert res["device"]["count"] == 1
        world = worlds["toy.world", trace]["result"]
        assert list(world) == list(res) and set(world["device"]) == set(res["device"])
        assert not any(ln.startswith("rank ") for ln in w["err"].splitlines())


def test_calibrate_runs_a_world_cell_through_the_world(worlds):
    proc = worlds["calibrate"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    assert [ln["seed"] for ln in lines] == [5, 6]
    assert all(ln["abs_err"] == 0.0 and ln["failed"] == 0 for ln in lines)


def test_a_world_takes_each_number_at_its_worst_over_the_ranks():
    def rec(samples, peak, err, failed, chunks=40):
        return {"samples": samples, "chunks": chunks, "memory_peak_bytes": peak,
                "busy_s": None, "checks": [("rel_err", err, 2e-5), ("bad_chunks", 0, 0)],
                "failed": failed, "forbidden": []}

    ranks = [rec(10, 300, 1e-7, {3}), rec(20, 900, 4e-5, {3, 7}), rec(30, 500, 2e-7, set())]
    samples, peak, checks, failed = run.combine(ranks)
    assert (samples, peak, failed) == (60, 900, 2)
    assert checks == [("rel_err", 4e-5, 2e-5), ("bad_chunks", 0, 0)]
    assert run.wrong_chunks([1, {4, 5}]) == 2
    with pytest.raises(run.Refused, match="rank 2 ran 39"):
        run.combine(ranks[:2] + [rec(30, 500, 2e-7, set(), chunks=39)])
    bad = rec(1, 1, 0.0, 0)
    bad["forbidden"] = ["jax"]
    with pytest.raises(run.Refused, match="rank 1"):
        run.combine([ranks[0], bad])


def test_a_missing_cell_file_refuses_before_any_rank_starts(tmp_path):
    install(tmp_path, 4)
    (tmp_path / "portbench" / "configs" / "toy_world.py").unlink()
    t0 = time.monotonic()
    w = finish(start(tmp_path, "toy.world", 0), t0, 60)
    assert w["rc"] == 2 and "no file portbench/configs/toy_world.py" in w["err"]
    assert w["seconds"] < 30


TOY_NOOP_CELL = '''
"""One small kernel a chunk and no collective: in a world, a chunk's time is
the kernel's and the end of chunk's."""

import torch


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.x = torch.arange(config["width"], dtype=torch.float32, device=device)

    def feed(self):
        return (self.x,)

    def call(self, x):
        return x * 2.0

    def advance(self, y):
        return int(y.numel())

    def keep(self, y):
        return y

    def work(self, first, last):
        return 8.0 * self.x.numel() * (last - first), float(self.x.numel()) * (last - first)

    def release(self):
        pass

    def check(self, kept, limits):
        err = max(float((y - 2.0 * self.x).abs().max()) for _, y in kept)
        return [("abs_err", err, limits["abs_err"])], 0
'''

CARD = ("import json, sys\nfrom portbench import run\n"
        "workload, chips, trace = sys.argv[1], int(sys.argv[2]), sys.argv[3]\n"
        "argv = ['--workload', workload, '--seed', '11', '--seconds', '5', '--trace', trace]\n"
        "res = (run.run_world('portbench.run', argv, chips, 'cuda', 900, 900) if chips else\n"
        "       run.run_cell(json.load(open('BENCHMARK.json')), workload, 11, 5.0, False))\n"
        "print(json.dumps(res))\n")


@pytest.mark.cuda
def test_a_world_runs_over_nccl(tmp_path):
    """The toy world on every card the machine has, up to 4 (a world of one
    NCCL rank where it has one), untraced and traced; then a chunk of one
    small kernel alone, on one chip and in worlds of 1 and of every card, in
    turns: each run's mean chunk time, whose difference is the end of
    chunk's cost.  Rank 0 builds the port's libraries first (from the
    repository beside the copy)."""

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    chips = min(4, torch.cuda.device_count())
    install(tmp_path, chips)
    pb = tmp_path / "portbench"
    (pb / "configs" / "toy_noop.py").write_text(TOY_NOOP_CELL)
    (pb / "configs" / "toy_noop.json").write_text(json.dumps({"width": WIDTH}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][-1], "name": "toy_noop",
                             "file": "portbench/configs/toy_noop.json"})
    bench["workloads"].append({"name": "toy.noop", "config": "toy_noop", "traffic": "toy_world",
                               "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    def go(workload, world, trace=0):
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, "-c", CARD, workload, str(world), str(trace)],
                              cwd=tmp_path, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                                  [str(tmp_path), str(ROOT)])),
                              capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-3000:]
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        assert res["correct"] and res["device"]["count"] == max(world, 1), res
        print(f"\n{workload} on {world or 'one chip'} ({time.monotonic() - t0:.1f} s): {res}")
        return res

    for trace in (0, 1):
        res = go("toy.world", chips, trace)
        assert len(res["ranks"]) == chips
        if trace:  # no rank's wait for a late profiler counts as busy
            assert all(0 < r["busy_s"] <= res["device"]["window_s"] for r in res["ranks"]), res
    mean_ms = {}
    for world in (0, 1, chips, chips, 1, 0):
        res = go("toy.noop", world)
        mean_ms.setdefault(world, []).append(5000.0 / res["attempted"])
    print(f"\n{torch.cuda.get_device_name()}: mean chunk ms of one small kernel: "
          f"one chip {mean_ms[0]}, world of 1 {mean_ms[1]}, world of {chips} {mean_ms[chips]}")
