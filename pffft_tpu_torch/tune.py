"""Measured plan selection — the FFTW-measure-mode analog.

Counterpart of ``pffft_tpu/tune.py``.  PFFFT's benchmark treats FFTW's
ESTIMATE and MEASURE planning as two competitors; this package's
equivalent axes are the stage policy (``max_factor``, or an explicit stage
chain) and the engine.  :func:`tuned_setup` times the candidate policies
on a device and returns the fastest plan, caching the winner per (device,
n, kind, dtype) in the process and optionally on disk
(``PFFFT_TPU_TUNE_CACHE=path``); :func:`tune_engine` races the engines
that can run a shape and records the winner in the dispatcher's measured
table.

``new_setup`` (the default policy) is the ESTIMATE analog; ``tuned_setup``
is MEASURE.  The port's kernels run their own thin chains whatever the
plan's factors (``ops/dispatch.py``): only the stage engine, and so only
shapes no kernel covers and float64 plans, reads the policy.  Where every
candidate runs on one kernel route, ``tuned_setup`` times nothing and
returns the first candidate's plan: the candidates would do identical work.

Timing is CUDA events after a synchronize on the card (the median of
several windows) and ``time.perf_counter`` on the CPU.  Unlike the
reference, no failure is swallowed: an engine that raises stops the race
with its error, and a cache file that cannot be read, parsed or written
raises; only a missing cache file is not an error.  Cache keys begin with
the torch device type and its compute capability (the machine on the
CPU), e.g. ``cuda-9.0:4096:complex:float32``, so a file shared with the
JAX package never hands one package the other's winner.
"""

from __future__ import annotations

import json
import os
import platform
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import fft as _fft
from . import plan as _plan
from .ops import dispatch as _dispatch

__all__ = [
    "tuned_setup",
    "tune_engine",
    "candidate_max_factors",
    "candidate_policies",
    "clear_tune_cache",
]

_MEM_CACHE: dict = {}

# windows of ``iters`` calls each; the median decides
_WINDOWS = 3

# The reference's non-TPU candidates.  Its TPU branch draws on the TPU's
# measured factor table (``plan._tpu_table_factors``), which is not ported.
_MAX_FACTORS = (5, 64)


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _candidates(n: int, kind) -> dict:
    """(factors, local_split is None) -> max_factor, in candidate order,
    deduplicated by the plan each max_factor produces."""

    out: dict = {}
    for mf in _MAX_FACTORS:
        try:
            p = _plan.Plan.create(n, kind, max_factor=mf, strict=False)
        except ValueError:
            continue
        out.setdefault((p.factors, p.local_split is None), mf)
    return out


def candidate_max_factors(n: int, kind) -> Tuple[int, ...]:
    """Distinct-stage-shape max_factor candidates for this size."""

    return tuple(_candidates(n, _plan._coerce_kind(kind)).values())


def candidate_policies(n: int, kind) -> Tuple[tuple, ...]:
    """Candidate plan policies, each ("mf", max_factor) or ("chain",
    factors): the reference's non-TPU candidates, ("mf", 5) and ("mf",
    64), deduplicated by the plan each produces."""

    return tuple(("mf", mf) for mf in _candidates(n, _plan._coerce_kind(kind)).values())


def _policy_plan(n: int, kind, dtype, policy) -> _plan.Plan:
    tag, val = policy
    if tag == "chain":
        return _plan.Plan.create(n, kind, dtype, factors=tuple(val), strict=False)
    return _plan.Plan.create(n, kind, dtype, max_factor=int(val), strict=False)


def _seconds_per_call(fn, device: torch.device, iters: int) -> float:
    """Median seconds per call of ``fn`` over :data:`_WINDOWS` windows of
    ``iters`` back-to-back calls, after one warm-up call: CUDA events on
    the card, ``perf_counter`` on the CPU."""

    iters = max(1, int(iters))
    fn()
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(_WINDOWS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3 / iters)
    else:
        for _ in range(_WINDOWS):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ts.append((time.perf_counter() - t0) / iters)
    return float(np.median(ts))


def _planes(shape, dtype, device: torch.device):
    rng = np.random.default_rng(0)
    rdt = np.dtype(dtype)  # probe with the plan's real dtype, not always f32
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(rdt)).to(device)
                 for _ in range(2))


def _time_plan(n: int, kind, dtype, policy, batch: int, iters: int,
               device: torch.device) -> float:
    """Seconds per batched forward transform of the policy's complex
    engine on batch-major rows [batch, engine_n].  REAL plans add a fixed
    policy-independent split step, so the engine at engine_n is what gets
    timed."""

    engine_n = n // 2 if _plan._coerce_kind(kind) == _plan.REAL else n
    eng = _policy_plan(engine_n, _plan.COMPLEX, dtype, policy)
    x = _planes((batch, eng.engine_n), dtype, device)
    return _seconds_per_call(
        lambda: _fft.transform_ordered_split(eng, x, _plan.FORWARD), device, iters)


def _kernel_route(eng: _plan.Plan, batch: int, device: torch.device) -> Optional[str]:
    """The kernel engine :func:`_time_plan`'s call takes for the complex
    engine plan ``eng`` on batch-major rows, or None where the stage
    engine runs it, the one route that reads the plan's factors."""

    engine = _dispatch.select_engine(eng, batch, False, device)
    if engine == "tmajor":
        engine = _dispatch._choose(eng, batch, True, device,
                                   _dispatch._tmajor_engines(eng, batch, device))
    return None if engine == "stages" else engine


def _time_engine(engine: str, call, device: torch.device, iters: int) -> float:
    """Seconds per call of ``call`` with ``engine`` forced; the force is
    lifted whatever happens."""

    _dispatch.set_engine(engine)
    try:
        return _seconds_per_call(call, device, iters)
    finally:
        _dispatch.set_engine(None)


def tune_engine(
    n: int,
    batch: int,
    *,
    time_major: bool = True,
    dtype="float32",
    iters: int = 8,
    rounds: int = 3,
    device=None,
) -> str:
    """Race the engines that can run this exact (N, batch, layout) on
    ``device`` (default "cuda") and return the winner's name.  On a CUDA
    device the winner is recorded in the dispatcher's measured table
    (``record_engine`` at the device's compute capability).  On the CPU
    nothing is recorded: the dispatcher routes the CPU as sm_90, so a
    record would hand the card a winner timed on the host.

    Interleaved rounds, the median decides.  With one available engine
    nothing is timed or recorded.  An engine that raises ends the race
    with its error."""

    dev = _device(device)
    plan = _plan.Plan.create(n, _plan.COMPLEX, dtype, strict=False)
    avail = _dispatch.available_engines(plan, batch, time_major, dev)
    if len(avail) == 1:
        return avail[0]

    x = _planes((n, batch) if time_major else (batch, n), dtype, dev)
    if time_major:
        call = lambda: _fft.transform_ordered_split_tmajor(plan, x, _plan.FORWARD)  # noqa: E731
    else:
        call = lambda: _fft.transform_ordered_split(plan, x, _plan.FORWARD)  # noqa: E731

    times = {e: [] for e in avail}
    for _ in range(max(1, rounds)):
        for e in avail:
            times[e].append(_time_engine(e, call, dev, iters))
    med = {e: float(np.median(ts)) for e, ts in times.items()}
    winner = min(med, key=med.get)
    if dev.type == "cuda":
        _dispatch.record_engine(_dispatch.capability(dev), plan.engine_n, winner, time_major)
    return winner


def _disk_cache_path() -> Optional[str]:
    return os.environ.get("PFFFT_TPU_TUNE_CACHE") or None


def _read_disk_cache(path: str) -> dict:
    """The cache file's entries; {} when the file does not exist."""

    try:
        with open(path) as f:
            disk = json.load(f)
    except FileNotFoundError:
        return {}
    if not isinstance(disk, dict):
        raise ValueError(f"tune cache {path}: expected a JSON object, got {type(disk).__name__}")
    return disk


def _device_tag(device: torch.device) -> str:
    if device.type == "cuda":
        major, minor = _dispatch.capability(device)
        return f"cuda-{major}.{minor}"
    return f"{device.type}-{platform.machine()}"


def clear_tune_cache() -> None:
    _MEM_CACHE.clear()


def tuned_setup(
    n: int,
    kind=_plan.COMPLEX,
    dtype="float32",
    *,
    batch: int = 64,
    iters: int = 8,
    candidates: Optional[Sequence[int]] = None,
    device=None,
) -> _plan.Plan:
    """Measure candidate stage policies on ``device`` (default "cuda") and
    return the fastest plan (cached).  The MEASURE-mode constructor; plans
    are identical in semantics to :func:`pffft_tpu_torch.new_setup`.

    Where every candidate's engine plan takes the same kernel route, the
    kernel ignores the factors and the candidates do identical work:
    nothing is timed or cached, and the first candidate's plan is returned
    (with the default candidates, the default policy's: ("mf", 5))."""

    dev = _device(device)
    kind = _plan._coerce_kind(kind)
    skey = ":".join((_device_tag(dev), str(int(n)), kind.value, np.dtype(dtype).name))
    if skey in _MEM_CACHE:
        return _policy_plan(n, kind, dtype, _MEM_CACHE[skey])

    path = _disk_cache_path()
    if path:
        disk = _read_disk_cache(path)
        if skey in disk:
            _MEM_CACHE[skey] = _coerce_policy(disk[skey])
            return _policy_plan(n, kind, dtype, _MEM_CACHE[skey])

    if candidates:
        # legacy surface: a sequence of max_factor ints, or policy tuples
        cands = tuple(
            c if isinstance(c, tuple) and c and c[0] in ("mf", "chain") else ("mf", int(c))
            for c in candidates
        )
    else:
        cands = candidate_policies(n, kind)
    engine_n = n // 2 if kind == _plan.REAL else n
    routes = {_kernel_route(_policy_plan(engine_n, _plan.COMPLEX, dtype, pol), batch, dev)
              for pol in cands}
    if len(routes) == 1 and None not in routes:
        return _policy_plan(n, kind, dtype, cands[0])
    best_pol, best_t = None, float("inf")
    for pol in cands:
        t = _time_plan(n, kind, dtype, pol, batch, iters, dev)
        if t < best_t:
            best_pol, best_t = pol, t
    if best_pol is None:  # no candidate: the planner's own error
        return _plan.Plan.create(n, kind, dtype)

    _MEM_CACHE[skey] = best_pol
    if path:
        disk = _read_disk_cache(path)
        disk[skey] = list(best_pol if best_pol[0] == "mf" else ("chain", list(best_pol[1])))
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(disk, f, indent=1)
        os.replace(tmp, path)
    return _policy_plan(n, kind, dtype, best_pol)


def _coerce_policy(v) -> tuple:
    """Disk-cache value -> policy tuple (back-compat: bare ints = mf)."""

    if isinstance(v, (int, float)):
        return ("mf", int(v))
    tag, val = v
    if tag == "chain":
        return ("chain", tuple(int(x) for x in val))
    return ("mf", int(val))
