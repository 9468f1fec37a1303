"""What a traced sub-window shows: device busy time, idle gaps and the port's kernels.

The harness wraps the traced chunks in one ``record_function`` range,
``WINDOW``, and each entry call in ``CHUNK``; ``torch.profiler`` records
the host's ops and the device's kernels, copies and fills.  :func:`read`
takes the exported Chrome trace and gives the window's length, the union of
the device's ops inside it, the ops that took most time by name, the idle
gaps by what the host was doing, how many of the kernels were the
port's own hand kernels (named by the ``__global__`` functions of its CUDA
sources, :func:`kernel_names`), and how far the profiler placed the
device's ops outside what the host's calls allow (:func:`misplaced_us`).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Set, Tuple

WINDOW = "portbench.window"
CHUNK = "portbench.chunk"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
TOP = 10

_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?([A-Za-z_]\w*)\s*\(")


def kernel_names(csrc: Path) -> Set[str]:
    """The ``__global__`` function names of the CUDA sources under ``csrc``."""

    names = set()
    for p in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(_GLOBAL.findall(p.read_text()))
    return names


def short_name(name: str) -> str:
    """A device op's name without its return type, template and parameter
    lists: ``void ns::k<4>(float const*)`` -> ``ns::k``."""

    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return (name[:min(cut)] if cut else name).strip()


def _union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def launches(events: List[dict]) -> Dict[object, float]:
    """The start of each launching call on the host (a runtime or driver
    call) by its ``correlation``, which the device op it launched shares."""

    return {e["args"]["correlation"]: float(e["ts"]) for e in events
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}


def misplaced_us(events: List[dict], launched: Dict[object, float]) -> float:
    """How far, in µs, the profiler placed some device op outside what the
    host's calls allow: before the start of the call that launched it, or
    past the end of the first ``cudaDeviceSynchronize`` that the host began
    after that call.  0 where every op lies inside, and without the host's
    calls.  The latencies of a launch and of a synchronise blur the bounds
    by a few µs; the H100's profiler at times places the device's clock
    tens of µs to milliseconds off, and then the window's edges and the
    gaps' names read from that placing are off too."""

    syncs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "cuda_runtime" and e["name"] == "cudaDeviceSynchronize")
    starts = [a for a, _ in syncs]
    worst = 0.0
    for e in events:
        t = launched.get(e.get("args", {}).get("correlation"))
        if e.get("cat") not in DEVICE_CATS or t is None:
            continue
        worst = max(worst, t - float(e["ts"]))
        i = bisect.bisect_left(starts, t)
        if i < len(syncs):
            worst = max(worst, float(e["ts"]) + float(e["dur"]) - syncs[i][1])
    return worst


def read(trace: dict, kernels: Set[str], host: bool = True) -> Dict[str, object]:
    """The traced window's numbers from a Chrome trace (times in µs there,
    in seconds here): ``window_s``, ``busy_s``, ``device_ops`` and
    ``idle_gaps`` ([[name, seconds], ...], most first), ``hand_kernels``
    (launches of the port's kernels in the window: where the host's calls
    were recorded, those whose launching call lies in the ``WINDOW`` range,
    wherever the profiler placed the kernel), ``hand_by_name`` and
    ``misplaced_us`` (:func:`misplaced_us`).  A trace of the device
    alone (``host`` False) has no ``WINDOW`` range: its window runs from
    its first device op to its last, and it names no idle gap."""

    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    if host:
        windows = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} '{WINDOW}' ranges, not one")
        w0 = float(windows[0]["ts"])
        w1 = w0 + float(windows[0]["dur"])
        tid = windows[0].get("tid")
    else:
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        w0 = min((float(e["ts"]) for e in dev), default=0.0)
        w1 = max((float(e["ts"]) + float(e["dur"]) for e in dev), default=0.0)
        tid = None

    launched = launches(events) if host else {}
    ops: Dict[str, float] = defaultdict(float)
    hand: Dict[str, int] = defaultdict(int)
    spans = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        name = short_name(e["name"])
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        t = launched.get(e.get("args", {}).get("correlation"))
        if e.get("cat") == "kernel" and name.split("::")[-1] in kernels and (
                w0 <= t <= w1 if t is not None else b > a):
            hand[name] += 1
        if b <= a:
            continue
        ops[name] += b - a
        spans.append((a, b))
    busy = _union(spans)

    ops_on_host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                         for e in events if host and e.get("cat") in HOST_CATS
                         and e.get("tid") == tid and e["name"] != WINDOW)
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for span in busy for x in span] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]) if host else ():
        if b <= a:
            continue
        mid = (a + b) / 2
        inside = [h for h in ops_on_host if h[0] <= mid < h[1]]
        # the innermost host op running at the gap's middle: the latest to start
        gaps[max(inside)[2] if inside else "harness"] += b - a

    def top(d: Dict[str, float]) -> List[list]:
        return [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_ops": top(ops), "idle_gaps": top(gaps), "hand_kernels": sum(hand.values()),
            "hand_by_name": dict(hand), "misplaced_us": misplaced_us(events, launched)}
