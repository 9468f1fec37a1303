"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives it:

* ``portbench/configs/<config>.py``: ``Cell(config, traffic, seed,
  device)``, the driver of the configuration's public entry (``feed``,
  ``call``, ``advance``, ``keep``, ``work``, ``release``, ``check``), and
  ``<config>.json``, the configuration as it is run;
* ``portbench/traffic/<traffic>.json``: the mix's parameters and limits;
* ``portbench/metrics/<metric>.py``: ``read(run)``, the metric's value from
  the run's record, or None where it finds nothing to read.

Every cell is a closed loop of depth 1: one client, one chunk in flight; the
next chunk is handed to the entry only once the last one's output is
synchronised.  A run: set-up (import, stream from the seed, the cell's own
chunks warmed); with ``--trace 1`` two profiled sub-windows of the mix's
``trace_chunks`` chunks each, each tried again on chunks of its own where its
trace is unsound (:func:`sound_profile`); then the window, the loop for ``--seconds``,
each chunk timed on the host's clock from just before the entry call to the
return of the synchronise after it; then the check of a seeded sample of the window's outputs against the
configuration's plain reference.  The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines of
standard error.

A cell whose ``chips`` is above 1 runs as a world of that many ranks, one
process a card (:func:`run_world`): each rank is ``python3 -m portbench.run``
again with private arguments, joins the default process group (NCCL; gloo
on the CPU) before its Cell is made, and runs the same warm-up, traced
sub-windows and window in lock step (:class:`WorldLoop`).  A sharded Cell
reads its share from ``torch.distributed.get_rank()`` and
``get_world_size()``.  Rank 0's record gives the result, with the samples
summed over the ranks, the fullest card's memory peak and each number
compared at its worst over the ranks.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Dict, List, Optional, Tuple  # noqa: E402

if __name__ == "__main__":
    # one module however it is reached, so that a Cell's ``Refused`` is this one's
    sys.modules.setdefault("portbench.run", sys.modules[__name__])

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# modules whose presence after the window refuses the run, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "pffft_tpu")
# idle time at each end of a profiled sub-window, so that no op of the window lies
# at the edge of the time the profiler records
MARGIN_S = 0.05
# profiled sub-windows tried, each on chunks of its own, where a trace is unsound: one that
# lacks a launch of the port's kernels (a partial trace; refused where every try is), or
# whose device ops lie more than MISPLACED_US outside what the host's calls allow (on the
# H100 about one host-profiled sub-window in five; a sound one reads 13 µs at most)
TRACE_TRIES = 3
MISPLACED_US = 50.0
# a world cell's deadline is WORLD_SETUP_S + --seconds + WORLD_AFTER_S: its set-up (on a
# checkout's first run rank 0 builds the port's libraries, 100 - 200 s), then the two traced
# sub-windows, the check and the ranks' exit; the ranks' collectives wait as long
WORLD_SETUP_S = 900.0
WORLD_AFTER_S = 180.0


class Refused(RuntimeError):
    """The run cannot give a result (no card, a forbidden import, a
    partial trace)."""


def say(line: str) -> None:
    """``line`` on standard error in one write, so that the ranks of a world,
    which share it, never break into each other's lines."""

    sys.stderr.write(f"portbench: {line}\n")
    sys.stderr.flush()


def load(kind: str, name: str):
    """Module ``portbench/<kind>/<name>.py``."""

    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no {kind} file {path.relative_to(ROOT)}")
    modname = f"portbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def launch_count() -> int:
    """The port's kernel wrappers' launch counters, summed: every function
    of a loaded ``pffft_tpu_torch.ops`` module with an int ``launches``."""

    total = 0
    for name, mod in list(sys.modules.items()):
        if not name.startswith("pffft_tpu_torch.ops.") or mod is None:
            continue
        for obj in vars(mod).values():
            if callable(obj) and isinstance(getattr(obj, "launches", None), int) \
                    and getattr(obj, "__module__", None) == name:
                total += obj.launches
    return total


def cell_spec(bench: dict, workload: str):
    """(workload entry, config entry) of ``workload``."""

    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    return cell, {c["name"]: c for c in bench["configs"]}[cell["config"]]


def make_cell(bench: dict, workload: str, seed: int, device, traffic: Optional[dict] = None):
    """(cell, traffic) of ``workload`` made from ``seed`` on ``device``;
    ``traffic`` (tests) stands in for the mix's file."""

    spec, config = cell_spec(bench, workload)
    if traffic is None:
        traffic = json.loads((HERE / "traffic" / f"{spec['traffic']}.json").read_text())
    settings = json.loads((ROOT / config["file"]).read_text())
    return load("configs", config["name"]).Cell(settings, traffic, seed, device), traffic


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""

    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


class Loop:
    """The closed loop: one chunk handed, run and synchronised at a time,
    until a chunk ends at or after ``deadline`` on the host's clock."""

    deadline = math.inf

    def __init__(self, cell, device: str):
        import torch

        self.cell = cell
        self.cuda = device == "cuda"
        self.sync = torch.cuda.synchronize if self.cuda else (lambda: None)
        self.chunks = 0

    def step(self):
        """One chunk: (output, samples, chunk ms, enqueue seconds)."""

        args = self.cell.feed()
        t0 = time.perf_counter()
        out = self.cell.call(*args)
        t1 = time.perf_counter()
        self.sync()
        t2 = time.perf_counter()
        self.chunks += 1
        return out, self.cell.advance(out), (t2 - t0) * 1e3, t1 - t0

    def stop(self, end: float) -> bool:
        """Whether the window closes after the chunk that ended at ``end``."""

        return end >= self.deadline

    def settle(self):
        """Wait, before a profiled sub-window, until no op is in flight."""

        self.sync()

    def agree(self, flag: bool) -> bool:
        """Whether any rank raised ``flag``: here, this one."""

        return flag


class WorldLoop(Loop):
    """The closed loop of one rank of a world.  A chunk ends when every rank
    has finished its call: after its call each rank enqueues a one-element
    all-reduce (MAX) on its device, then synchronises its own card.  The
    all-reduce carries rank 0's vote to stop, cast when its call has
    returned at or after ``deadline``, so that every rank leaves the window
    after the same chunk.  Before a profiled sub-window the ranks meet at a
    barrier on the host (gloo), which puts no op on the card: a rank whose
    profiler starts late would otherwise hold the others' first all-reduce
    spinning on their cards inside the traced time."""

    def __init__(self, cell, device: str):
        import torch
        import torch.distributed as dist

        super().__init__(cell, device)
        self.dist = dist
        self.rank0 = dist.get_rank() == 0
        self.flag = torch.zeros(1, dtype=torch.float32, device=device)
        self.card_sync, self.sync = self.sync, self.end_chunk
        self.stopping = False
        self.host_group = dist.new_group(backend="gloo")

    def end_chunk(self):
        self.flag.fill_(float(self.rank0 and time.perf_counter() >= self.deadline))
        self.dist.all_reduce(self.flag, op=self.dist.ReduceOp.MAX)
        self.card_sync()

    def step(self):
        got = super().step()
        self.stopping = bool(self.flag.item())
        return got

    def stop(self, end: float) -> bool:
        return self.stopping

    def settle(self):
        self.card_sync()
        self.dist.barrier(group=self.host_group)

    def agree(self, flag: bool) -> bool:
        import torch

        votes = torch.tensor([int(flag)])
        self.dist.all_reduce(votes, group=self.host_group)
        return bool(votes.item())


def profiled(loop: Loop, n: int, host: bool) -> Dict[str, object]:
    """Profile ``n`` more chunks, the device's ops and with ``host`` the
    host's too; the sub-window's numbers (:mod:`portbench.trace`), its
    first chunk, its length on the host's clock, the wrappers' launches in
    it, and ``partial``: None, or why its trace is partial, where the
    profiler's count of the port's kernels differs from the wrappers'
    counters."""

    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as tr

    activities = ([ProfilerActivity.CPU] if host or not loop.cuda else []) + \
        ([ProfilerActivity.CUDA] if loop.cuda else [])
    c0, first = launch_count(), loop.chunks
    with profile(activities=activities) as prof:
        loop.settle()
        time.sleep(MARGIN_S)
        start = time.perf_counter()
        with record_function(tr.WINDOW):
            for _ in range(n):
                args = loop.cell.feed()
                with record_function(tr.CHUNK):
                    out = loop.cell.call(*args)
                loop.sync()
                loop.cell.advance(out)
                loop.chunks += 1
                del out
        window_s = time.perf_counter() - start
        time.sleep(MARGIN_S)
    counted = launch_count() - c0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            found = tr.read(json.load(f), tr.kernel_names(ROOT / "pffft_tpu_torch" / "csrc"),
                            host)
    partial = None
    if found["hand_kernels"] != counted:
        partial = (f"the profiler saw {found['hand_kernels']} launches of the port's kernels "
                   f"({found['hand_by_name']}) where the wrappers counted {counted}: "
                   f"a partial trace")
    found.update(first=first, chunks=n, counter_launches=counted, host_window_s=window_s,
                 partial=partial)
    return found


def sound_profile(loop: Loop, n: int, host: bool) -> Dict[str, object]:
    """:func:`profiled` until its trace is sound on every rank, at most
    ``TRACE_TRIES`` times, each try on ``n`` chunks of its own, each unsound
    try named on standard error.  Where no try is sound, the whole try
    misplaced least; refused where every try is partial."""

    whole = []
    for attempt in range(1, TRACE_TRIES + 1):
        found = profiled(loop, n, host)
        fault = found["partial"] or (
            f"device ops placed up to {found['misplaced_us']:.1f} µs outside their launch "
            f"and synchronise" if found["misplaced_us"] > MISPLACED_US else None)
        if not loop.agree(fault is not None):
            return found
        say(f"traced sub-window {attempt} of {TRACE_TRIES} "
            f"({'host and device' if host else 'device'}) unsound: {fault or 'on another rank'}")
        if not found["partial"]:
            whole.append(found)
    if not whole:
        raise Refused(found["partial"])
    kept = min(whole, key=lambda f: f["misplaced_us"])
    say(f"kept the whole sub-window misplaced least, by {kept['misplaced_us']:.1f} µs")
    return kept


def traced(loop: Loop, n: int) -> Dict[str, object]:
    """Two sound profiled sub-windows of ``n`` chunks each
    (:func:`sound_profile`).  The first records only
    the device, so the host runs as it does untraced: its busy time, its ops
    by name and its length on the host's clock give ``busy_s``,
    ``window_s`` and ``device_ops``.  The second records the host's ops
    too, which slows the host, and names the idle gaps by what the host
    was doing.  ``first``: the first chunk of the first sub-window."""

    device = sound_profile(loop, n, host=False)
    host = sound_profile(loop, n, host=True)
    return {"first": device["first"], "chunks": n, "busy_s": device["busy_s"],
            "window_s": device["host_window_s"], "device_ops": device["device_ops"],
            "idle_gaps": host["idle_gaps"], "counter_launches": device["counter_launches"]}


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0,
             plant: Optional[Callable] = None, traffic: Optional[dict] = None,
             world: bool = False) -> Optional[dict]:
    """One run of ``workload``: the result as the CLI prints it.  Tests run
    it on the CPU, with a smaller ``traffic`` and a ``plant`` that may
    replace the cell's ``call`` before the run.  With ``world`` this is one
    rank's part of a world's run (the process group is up): rank 0 returns
    the world's result, each rank's memory peak and busy time under
    ``ranks``; the other ranks return None."""

    import torch

    from . import stream

    cell, traffic = make_cell(bench, workload, seed, device, traffic)
    if plant is not None:
        plant(cell)
    loop = (WorldLoop if world else Loop)(cell, device)
    for _ in range(int(traffic["warm_chunks"])):
        loop.step()
    tr = traced(loop, int(traffic["trace_chunks"])) if trace else None
    loop.sync()
    gc.collect()
    kept = stream.Reservoir(int(traffic["check_chunks"]), seed)
    chunk_ms: List[float] = []
    enqueue_s: List[float] = []
    samples = 0
    setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    loop.deadline = start + seconds
    first = loop.chunks
    while True:
        out, n, ms, enq = loop.step()
        samples += n
        chunk_ms.append(ms)
        enqueue_s.append(enq)
        kept.offer(loop.chunks - 1, cell.keep(out))
        del out
        end = time.perf_counter()
        if loop.stop(end):
            break
    window_s = end - start
    attempted = loop.chunks - first
    peak = torch.cuda.max_memory_allocated() if loop.cuda else 0
    nbytes, flops = cell.work(tr["first"], tr["first"] + tr["chunks"]) if tr else (0.0, 0.0)
    cell.release()
    if loop.cuda:
        torch.cuda.empty_cache()
    checks, failed = cell.check(kept.items(), traffic["limits"])
    ranks = None
    if world:
        ranks = gather(dict(samples=samples, chunks=attempted, memory_peak_bytes=int(peak),
                            busy_s=tr["busy_s"] if tr else None, checks=checks, failed=failed,
                            forbidden=forbidden_modules()))
        if ranks is None:
            return None
        samples, peak, checks, failed = combine(ranks)
    else:
        failed = wrong_chunks([failed])

    run = SimpleNamespace(setup_s=setup_s, window_s=window_s, samples=samples, chunks=attempted,
                          chunk_ms=chunk_ms, enqueue_s=enqueue_s, trace=tr,
                          bytes_per_chunk=nbytes / tr["chunks"] if tr else None,
                          flops_per_chunk=flops / tr["chunks"] if tr else None,
                          device_kind=(torch.cuda.get_device_name(0) if loop.cuda else "cpu"),
                          peaks=json.loads((HERE / "peaks.json").read_text()))
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = load("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if loop.cuda else "cpu", "kind": run.device_kind,
           "count": len(ranks) if ranks else 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= limit for _, v, limit in checks), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if tr:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    if ranks:
        result["ranks"] = [{"rank": r, "memory_peak_bytes": rec["memory_peak_bytes"],
                            "busy_s": rec["busy_s"]} for r, rec in enumerate(ranks)]
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result


def wrong_chunks(found: list) -> int:
    """How many chunks the ranks judged wrong, each chunk once.  A Cell's
    ``check`` gives its count, or the chunks' indices, which the ranks'
    union counts; where a rank gives only a count, the largest count."""

    if any(isinstance(f, int) for f in found):
        return max(f if isinstance(f, int) else len(f) for f in found)
    return len(set().union(*found))


def gather(record: dict) -> Optional[List[dict]]:
    """Every rank's ``record``, by rank, on rank 0; None on the others."""

    import torch.distributed as dist

    records = [None] * dist.get_world_size()
    dist.all_gather_object(records, record)
    return records if dist.get_rank() == 0 else None


def worst(ranks: List[dict]) -> Tuple[list, int]:
    """(checks, chunks judged wrong) of a world: each number compared at its
    largest over the ranks, beside its limit; a chunk wrong where any rank
    judged it wrong."""

    values = [{name: v for name, v, _ in rec["checks"]} for rec in ranks]
    checks = [(name, max(v[name] for v in values), limit) for name, _, limit in ranks[0]["checks"]]
    return checks, wrong_chunks([rec["failed"] for rec in ranks])


def combine(ranks: List[dict]) -> Tuple[int, int, list, int]:
    """(samples, memory peak, checks, chunks judged wrong) of a world from its
    ranks' records: the samples summed, the fullest card's peak and
    :func:`worst`.  Refused where a rank loaded a forbidden module or left
    the window after another chunk than rank 0."""

    for r, rec in enumerate(ranks):
        if rec["forbidden"]:
            raise Refused(f"forbidden modules loaded on rank {r}: {rec['forbidden']}")
        if rec["chunks"] != ranks[0]["chunks"]:
            raise Refused(f"rank {r} ran {rec['chunks']} window chunks, rank 0 "
                          f"{ranks[0]['chunks']}")
    checks, failed = worst(ranks)
    return (sum(rec["samples"] for rec in ranks),
            max(rec["memory_peak_bytes"] for rec in ranks), checks, failed)


def add_rank_args(ap: argparse.ArgumentParser) -> None:
    """The private arguments with which :func:`run_world` starts a rank."""

    for flag, kind in (("--rank", int), ("--world", int), ("--store-port", int),
                       ("--parent", int), ("--device", str), ("--group-timeout", float),
                       ("--t0", float), ("--out", str)):
        ap.add_argument(flag, type=kind, help=argparse.SUPPRESS)


def run_world(module: str, argv: List[str], chips: int, device: str, deadline_s: float,
              group_timeout_s: float):
    """Start ``chips`` ranks, each ``python3 -m <module> <argv>`` with the
    private rank arguments, one process a card; wait until every rank has
    ended, and return the JSON that rank 0 wrote.  The ranks meet at a
    store on a free local port that this process holds.  Refused, after
    every rank has been killed and has ended, where a rank exits with
    another code than 0 (with the messages of the ranks that refused) or
    the world is not done within ``deadline_s``.  ``T0`` goes to rank 0 as
    the run's start."""

    from torch.distributed import TCPStore

    store = TCPStore("127.0.0.1", 0, is_master=True)
    with tempfile.TemporaryDirectory() as out:
        private = ["--world", str(chips), "--store-port", str(store.port),
                   "--parent", str(os.getpid()), "--device", device,
                   "--group-timeout", repr(group_timeout_s), "--t0", repr(T0), "--out", out]
        # each rank in a process group of its own, which a kill takes whole (nvcc with it)
        procs = [subprocess.Popen([sys.executable, "-m", module, *argv, "--rank", str(r),
                                   *private], cwd=ROOT, stdout=2, process_group=0)
                 for r in range(chips)]
        deadline = time.monotonic() + deadline_s
        failure = None
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [f"rank {r} with code {c}" for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failure = f"of {chips} ranks, {', '.join(bad)} exited"
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() >= deadline:
                    failure = f"the world of {chips} ranks was not done within {deadline_s:g} s"
                if failure:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    try:
                        os.killpg(p.pid, signal.SIGKILL)
                    except ProcessLookupError:  # it ended since
                        pass
            for p in procs:
                p.wait()
        if failure:
            said = [f.read_text() for f in sorted(Path(out).glob("refused*.txt"))]
            raise Refused("; ".join([failure + "; every rank was ended", *said]))
        return json.loads((Path(out) / "result.json").read_text())


def die_with_parent(parent: int) -> None:
    """Have Linux kill this process when the process that started it ends
    (``PR_SET_PDEATHSIG``), so that no rank outlives its run; end at once
    where that process has ended already."""

    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))
    if os.getppid() != parent:
        os._exit(3)


def build_port() -> None:
    """Build every library of the port not built yet; on a checkout's first
    run, rank 0 runs nvcc here while the other ranks wait, so that no
    library is built twice."""

    importlib.import_module("pffft_tpu_torch.ops._build").build()


def rank_main(args, job: Callable) -> int:
    """One rank of a world that :func:`run_world` started: take card
    ``args.rank``, join the default process group, let rank 0 build the
    port's libraries while the others wait at a barrier, run ``job(args)``,
    and on rank 0 write what it returns as JSON into the directory
    ``args.out``; a rank that is refused writes its message there."""

    die_with_parent(args.parent)
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    cuda = args.device == "cuda"
    try:
        if cuda:
            torch.cuda.set_device(args.rank)
        timeout = datetime.timedelta(seconds=args.group_timeout)
        store = dist.TCPStore("127.0.0.1", args.store_port, is_master=False, timeout=timeout)
        dist.init_process_group("nccl" if cuda else "gloo", store=store, rank=args.rank,
                                world_size=args.world, timeout=timeout)
        if cuda and args.rank == 0:
            build_port()
        dist.barrier(**({"device_ids": [args.rank]} if cuda else {}))
        out = job(args)
        dist.destroy_process_group()
    except Refused as e:
        said = f"rank {args.rank}: {e}"
        say(said)
        (Path(args.out) / f"refused{args.rank}.txt").write_text(said)
        return 2
    if args.rank == 0:
        (Path(args.out) / "result.json").write_text(json.dumps(out))
    return 0


def run_rank(args) -> Optional[dict]:
    """A rank's part of a run (:func:`rank_main`'s job)."""

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                    device=args.device, t0=args.t0, world=True)


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of each card, one after another."""

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    return "; ".join(lines) if lines else None


def cell_files(spec: dict, config: dict) -> None:
    """Refused where a file of the cell is missing (a parent commit asked
    for a cell it lacks), before any rank starts."""

    for path in (HERE / "configs" / f"{config['name']}.py",
                 HERE / "traffic" / f"{spec['traffic']}.json", ROOT / config["file"]):
        if not path.is_file():
            raise Refused(f"no file {path.relative_to(ROOT)}")


def main(argv=None, device: str = "cuda", deadline_s: Optional[float] = None,
         group_timeout_s: Optional[float] = None) -> int:
    """The command line.  Tests run a world cell on the CPU (``device``
    "cpu", gloo) with a deadline and a process group's timeout of their own;
    by default both are ``WORLD_SETUP_S + --seconds + WORLD_AFTER_S``."""

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    add_rank_args(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args, run_rank)
    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        spec, config = cell_spec(bench, args.workload)
        chips = int(spec["chips"])
        import torch

        torch.set_num_threads(1)
        if device == "cuda" and (not torch.cuda.is_available()
                                 or torch.cuda.device_count() < chips):
            raise Refused(f"the cell needs {spec['chips']} CUDA device(s); "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} seen")
        if chips == 1:
            result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                              device=device)
        else:
            cell_files(spec, config)
            deadline_s = deadline_s or WORLD_SETUP_S + args.seconds + WORLD_AFTER_S
            argv = ["--workload", args.workload, "--seed", str(args.seed),
                    "--seconds", repr(args.seconds), "--trace", str(args.trace)]
            result = run_world("portbench.run", argv, chips, device, deadline_s,
                               group_timeout_s or deadline_s)
        found = forbidden_modules()
        if found:
            raise Refused(f"forbidden modules loaded: {found}")
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    card = card_line()
    if card:
        print(f"card: {card}", file=sys.stderr)
    for rec in result.pop("ranks", []):
        print(f"rank {rec['rank']}: memory_peak_bytes {rec['memory_peak_bytes']} "
              f"busy_s {rec['busy_s']!r}", file=sys.stderr)
    print(f"window: {result['attempted']} chunks, {result['failed']} judged wrong",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
