"""Profiling / observability: the PAPI + host-info analog.

Counterpart of ``pffft_tpu/utils/profiling.py``.  PFFFT wires optional
PAPI hardware counters into its benches and bundles host metadata with
results (bench/unix_info.sh).  The equivalents here:

  * :func:`trace` — context manager around ``torch.profiler`` writing a
    trace file (chrome trace format, readable by TensorBoard's profiler
    plugin and Perfetto) under a directory;
  * :func:`device_info` — platform/topology/memory metadata dict (the
    lscpu/cpuinfo analog);
  * :class:`Roofline` — bytes/flops accounting against a peak bandwidth
    (the instructions/IPC analog for a bandwidth-bound library).

The package's own spans and counters (beyond the reference's names):

  * :func:`span` — a range named ``pffft.<layer>`` on the profiler's clock
    and the caller's thread, in the same trace as the kernels; with no
    profiler running it costs one check.  The layers: ``entry`` (a public
    call, :func:`entry`), ``dispatch`` (a route or engine decision,
    :func:`decision`), ``launch`` (a hand kernel wrapper's card path past
    its empty-batch return: tables, the ctypes call and its check; one span
    per launch) and ``layout`` (a layout copy outside a hand kernel,
    :func:`copy`);
  * :data:`counters` — always on: ``entry.calls.<entry>``,
    ``entry.copy_bytes`` (bytes written by the entries' layout copies),
    ``entry.strided_reads`` (kernel calls that read a caller's rows in
    place through a row stride other than the row length, with no layout
    copy) and ``setup.seconds.<part>`` (the
    package's import, library loads, plans and filter spectra, each part's
    own time without the parts nested in it, :func:`setup`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import platform
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity

__all__ = ["trace", "device_info", "Roofline"]

counters: dict = {}
_counters_lock = threading.Lock()
_COPY_BYTES = "entry.copy_bytes"
STRIDED_READS = "entry.strided_reads"

_NULL = contextlib.nullcontext()
# a torch without the check: every span opens a range (correct, only slower)
_profiler_on = getattr(torch._C._autograd, "_profiler_enabled", lambda: True)


def _range(name: str, args: dict):
    """A profiler range ``name`` with ``args``: record_function's range
    entered from C++ where this torch has it (under a profiler that records
    the device alone it records nothing and costs under a microsecond, where
    record_function costs several; torch tells no caller which activities
    the running profiler records), else ``record_function``."""

    fast = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast", None)
    if fast is not None:
        try:
            return fast(name, (), args)
        except TypeError:
            pass
    return torch.profiler.record_function(name, repr(args))


def count(key: str, n=1):
    """Add ``n`` to ``counters[key]`` and return the sum; a lock keeps the
    updates of concurrent callers."""

    with _counters_lock:
        counters[key] = total = counters.get(key, 0) + n
    return total


def span(layer: str, what: str):
    """Context manager: the range ``pffft.<layer>`` while a profiler runs,
    with ``what`` in its args (the trace shows them where the profiler
    records shapes), else a shared no-op."""

    if not _profiler_on():
        return _NULL
    return _range(f"pffft.{layer}", {"what": what})


def entry(name: str) -> Callable:
    """Decorator of a public entry: counts its calls in
    ``entry.calls.<name>`` and spans each in ``pffft.entry``, the call's
    number in its args."""

    key = f"entry.calls.{name}"

    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **k):
            with _counters_lock:
                counters[key] = n = counters.get(key, 0) + 1
            if not _profiler_on():
                return fn(*a, **k)
            with _range("pffft.entry", {"what": name, "call": n}):
                return fn(*a, **k)

        return call

    return wrap


def decision(fn: Callable) -> Callable:
    """Decorator of a route or engine decision: spans it in
    ``pffft.dispatch``, its name in the args."""

    args = {"what": fn.__name__}

    @functools.wraps(fn)
    def call(*a, **k):
        if not _profiler_on():
            return fn(*a, **k)
        with _range("pffft.dispatch", args):
            return fn(*a, **k)

    return call


class _Flag(threading.local):
    on = False


_uncounted = _Flag()


def copy(what: str, op: Callable, *a, **k) -> torch.Tensor:
    """``op(*a, **k)``, a layout copy: spanned in ``pffft.layout`` and its
    bytes added to ``entry.copy_bytes`` (not inside :func:`uncounted`)."""

    if not _profiler_on():
        t = op(*a, **k)
    else:
        with _range("pffft.layout", {"what": what}):
            t = op(*a, **k)
    if not _uncounted.on:
        with _counters_lock:
            counters[_COPY_BYTES] = counters.get(_COPY_BYTES, 0) + t.nbytes
    return t


def contiguous(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t.contiguous()``, a layout copy (:func:`copy`) where it copies."""

    return t if t.is_contiguous() else copy(what, torch.Tensor.contiguous, t)


@contextlib.contextmanager
def uncounted():
    """Copies made inside are not the entries' layout copies: a kernel's
    plain version stands for the kernel's own work."""

    before = _uncounted.on
    _uncounted.on = True
    try:
        yield
    finally:
        _uncounted.on = before


_setup = threading.local()


@contextlib.contextmanager
def setup(part: str, start: Optional[float] = None):
    """Time a piece of set-up into ``setup.seconds.<part>``: its own time
    (from ``start`` on the ``perf_counter`` clock, default now), less the
    time of set-up parts nested in it, so that the parts add up to the
    outermost ones' wall time."""

    t0 = time.perf_counter() if start is None else start
    stack = _setup.__dict__.setdefault("nested", [])
    stack.append(0.0)
    try:
        yield
    finally:
        took = time.perf_counter() - t0
        count(f"setup.seconds.{part}", took - stack.pop())
        if stack:
            stack[-1] += took


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope: ``with trace('/tmp/tb') as prof: run()``.

    Records CPU activity and, where CUDA is available, CUDA activity; the
    trace file (``*.pt.trace.json``) is written under ``log_dir`` when the
    scope ends, also when its body raises.  Yields the profiler
    (``prof.key_averages()`` sums the recorded events)."""

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def device_info(device=None) -> dict:
    """Device + host metadata for benchmark bundles (unix_info analog).

    ``device`` defaults to "cuda".  On the CPU the HBM keys are None: there
    is no device memory to report."""

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        info = {
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(index),
            "num_devices": torch.cuda.device_count(),
        }
        hbm_limit = torch.cuda.get_device_properties(index).total_memory
        hbm_in_use = torch.cuda.memory_allocated(index)
    else:
        info = {
            "platform": dev.type,
            "device_kind": platform.processor() or platform.machine(),
            "num_devices": 1,
        }
        hbm_limit = hbm_in_use = None
    info.update({
        "process_count": dist.get_world_size() if dist.is_initialized() else 1,
        "coords": None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python": platform.python_version(),
        "host": platform.platform(),
        "hbm_bytes_limit": hbm_limit,
        "hbm_bytes_in_use": hbm_in_use,
    })
    return info


@dataclasses.dataclass
class Roofline:
    """Speed-of-light accounting for a bandwidth-bound op.

    >>> r = Roofline(bytes_moved=..., flops=..., seconds=..., peak_bw=...)
    >>> r.sol_fraction, r.gflops, r.effective_bw
    """

    bytes_moved: int
    flops: float
    seconds: float
    peak_bw: Optional[float] = None  # bytes/s; None = unknown

    @property
    def effective_bw(self) -> float:
        return self.bytes_moved / self.seconds

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9

    @property
    def sol_seconds(self) -> Optional[float]:
        if self.peak_bw is None:
            return None
        return self.bytes_moved / self.peak_bw

    @property
    def sol_fraction(self) -> Optional[float]:
        s = self.sol_seconds
        return None if s is None else s / self.seconds

    def as_dict(self) -> dict:
        return {
            "seconds": self.seconds,
            "gflops": round(self.gflops, 2),
            "effective_bw_GBps": round(self.effective_bw / 1e9, 2),
            "sol_fraction": None if self.sol_fraction is None else round(self.sol_fraction, 4),
        }
