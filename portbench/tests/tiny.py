"""Small traffic mixes of every cell, for CPU runs of the whole harness."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

_SIZES = {
    "taps1024": dict(chunk_samples=8192, stream_samples=32768),
    "taps4096": dict(chunk_samples=16384, stream_samples=65536),
    "bulk": dict(frames_per_chunk=16, stream_samples=4 * 16 * 4096),
}


def traffic(workload: str) -> dict:
    """The workload's own mix with its sizes cut to a CPU's: same taps and
    channels, same limits, fewer and shorter chunks."""

    spec = {w["name"]: w for w in BENCH["workloads"]}[workload]
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{spec['traffic']}.json").read_text())
    mix.update(_SIZES[spec["traffic"]], warm_chunks=2, check_chunks=2, trace_chunks=3)
    return mix
