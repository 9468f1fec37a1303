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
``trace_chunks`` chunks each; then the window, the loop for ``--seconds``,
each chunk timed on the host's clock from just before the entry call to the
return of the synchronise after it; then the check of a seeded sample of the window's outputs against the
configuration's plain reference.  The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines of
standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# modules whose presence after the window refuses the run, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "pffft_tpu")
# idle time at each end of a profiled sub-window, so that no op of the window lies
# at the edge of the time the profiler records
MARGIN_S = 0.05


class Refused(RuntimeError):
    """The run cannot give a result (no card, a forbidden import, a
    partial trace)."""


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
    """The closed loop: one chunk handed, run and synchronised at a time."""

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


def profiled(loop: Loop, n: int, host: bool) -> Dict[str, object]:
    """Profile ``n`` more chunks, the device's ops and with ``host`` the
    host's too; the sub-window's numbers (:mod:`portbench.trace`), its
    length on the host's clock and the wrappers' launches in it.  Refused
    where the profiler's count of the port's kernels differs from the
    wrappers' counters: a partial trace."""

    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as tr

    activities = ([ProfilerActivity.CPU] if host or not loop.cuda else []) + \
        ([ProfilerActivity.CUDA] if loop.cuda else [])
    c0 = launch_count()
    with profile(activities=activities) as prof:
        loop.sync()
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
    if found["hand_kernels"] != counted:
        raise Refused(f"the profiler saw {found['hand_kernels']} launches of the port's kernels "
                      f"({found['hand_by_name']}) where the wrappers counted {counted}: "
                      f"a partial trace")
    found.update(chunks=n, counter_launches=counted, host_window_s=window_s)
    return found


def traced(loop: Loop, n: int) -> Dict[str, object]:
    """Two profiled sub-windows of ``n`` chunks each.  The first records only
    the device, so the host runs as it does untraced: its busy time, its ops
    by name and its length on the host's clock give ``busy_s``,
    ``window_s`` and ``device_ops``.  The second records the host's ops
    too, which slows the host, and names the idle gaps by what the host
    was doing.  ``first``: the first chunk of the first sub-window."""

    first = loop.chunks
    device = profiled(loop, n, host=False)
    host = profiled(loop, n, host=True)
    return {"first": first, "chunks": n, "busy_s": device["busy_s"],
            "window_s": device["host_window_s"], "device_ops": device["device_ops"],
            "idle_gaps": host["idle_gaps"], "counter_launches": device["counter_launches"]}


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0,
             plant: Optional[Callable] = None, traffic: Optional[dict] = None) -> dict:
    """One run of ``workload``: the result as the CLI prints it.  Tests run
    it on the CPU, with a smaller ``traffic`` and a ``plant`` that may
    replace the cell's ``call`` before the run."""

    import torch

    from . import stream

    cell, traffic = make_cell(bench, workload, seed, device, traffic)
    if plant is not None:
        plant(cell)
    loop = Loop(cell, device)
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
    deadline = start + seconds
    first = loop.chunks
    while True:
        out, n, ms, enq = loop.step()
        samples += n
        chunk_ms.append(ms)
        enqueue_s.append(enq)
        kept.offer(loop.chunks - 1, cell.keep(out))
        del out
        end = time.perf_counter()
        if end >= deadline:
            break
    window_s = end - start
    attempted = loop.chunks - first
    peak = torch.cuda.max_memory_allocated() if loop.cuda else 0
    nbytes, flops = cell.work(tr["first"], tr["first"] + tr["chunks"]) if tr else (0.0, 0.0)
    cell.release()
    if loop.cuda:
        torch.cuda.empty_cache()
    checks, failed = cell.check(kept.items(), traffic["limits"])

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
    dev = {"platform": "gpu" if loop.cuda else "cpu", "kind": run.device_kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= limit for _, v, limit in checks), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if tr:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result


def card_line() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        spec, _ = cell_spec(bench, args.workload)
        import torch

        torch.set_num_threads(1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec["chips"]):
            raise Refused(f"the cell needs {spec['chips']} CUDA device(s); "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} seen")
        result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
        found = forbidden_modules()
        if found:
            raise Refused(f"forbidden modules loaded: {found}")
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    card = card_line()
    if card:
        print(f"card: {card}", file=sys.stderr)
    print(f"window: {result['attempted']} chunks, {result['failed']} judged wrong",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
