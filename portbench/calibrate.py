"""Readings for the limits of ``correct``: the program's, and the control's, on many seeds.

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,13 --chunks 64 [--control]

For each seed, in one process: the cell made from the seed, its warm-up
chunks, then ``--chunks`` chunks of the closed loop with a run's own sample
of outputs kept, then the run's check.  With ``--control`` the
configuration's control, its reference computed in TF32, stands in the
program's place.  One JSON line per seed.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run as R


def readings(bench: dict, workload: str, seed: int, chunks: int, control: bool,
             device: str = "cuda", traffic=None) -> dict:
    """One seed's numbers compared, as a run of ``chunks`` chunks checks them."""

    from . import stream

    cell, traffic = R.make_cell(bench, workload, seed, device, traffic)
    if control:
        cell.use_control()
    loop = R.Loop(cell, device)
    for _ in range(int(traffic["warm_chunks"])):
        loop.step()
    kept = stream.Reservoir(int(traffic["check_chunks"]), seed)
    for _ in range(chunks):
        out = loop.step()[0]
        kept.offer(loop.chunks - 1, cell.keep(out))
    cell.release()
    checks, failed = cell.check(kept.items(), traffic["limits"])
    return {"workload": workload, "seed": seed, "control": control, "failed": failed,
            **{name: value for name, value, _ in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--chunks", type=int, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = readings(bench, args.workload, seed, args.chunks, args.control)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
