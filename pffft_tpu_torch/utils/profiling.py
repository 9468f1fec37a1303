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
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import platform
from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity

__all__ = ["trace", "device_info", "Roofline"]


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
