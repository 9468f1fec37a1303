"""Readings for the limits of ``correct``: the program's, and the control's, on many seeds.

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,13 --chunks 64 [--control]

For each seed, in one process: the cell made from the seed, its warm-up
chunks, then ``--chunks`` chunks of the closed loop with a run's own sample
of outputs kept, then the run's check.  With ``--control`` the
configuration's control, its reference computed in TF32, stands in the
program's place.  One JSON line per seed.  A cell of more than one chip
runs as the benchmark runs it, a world of one rank a card
(:func:`portbench.run.run_world`), each number at its worst over the
ranks.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run as R

# a world's deadline beyond its set-up, for each seed
SEED_S = 300.0


def readings(bench: dict, workload: str, seed: int, chunks: int, control: bool,
             device: str = "cuda", traffic=None, world: bool = False):
    """One seed's numbers compared, as a run of ``chunks`` chunks checks them.
    With ``world``, one rank's part (the process group is up): rank 0 gets
    the world's numbers, the other ranks None."""

    from . import stream

    cell, traffic = R.make_cell(bench, workload, seed, device, traffic)
    if control:
        cell.use_control()
    loop = (R.WorldLoop if world else R.Loop)(cell, device)
    for _ in range(int(traffic["warm_chunks"])):
        loop.step()
    kept = stream.Reservoir(int(traffic["check_chunks"]), seed)
    for _ in range(chunks):
        out = loop.step()[0]
        kept.offer(loop.chunks - 1, cell.keep(out))
    cell.release()
    checks, failed = cell.check(kept.items(), traffic["limits"])
    if world:
        ranks = R.gather({"checks": checks, "failed": failed})
        if ranks is None:
            return None
        checks, failed = R.worst(ranks)
    return {"workload": workload, "seed": seed, "control": control,
            "failed": R.wrong_chunks([failed]), **{name: value for name, value, _ in checks}}


def seed_lines(bench: dict, args, device: str, world: bool = False):
    """Each seed's readings, with the seconds they took, as they come; none
    on a rank other than 0."""

    import torch

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = readings(bench, args.workload, seed, args.chunks, args.control, device,
                        world=world)
        if device == "cuda":
            torch.cuda.empty_cache()
        if line is not None:
            line["seconds"] = time.perf_counter() - t
            yield line


def calibrate_rank(args) -> list:
    """A rank's part (:func:`portbench.run.rank_main`'s job)."""

    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    return list(seed_lines(bench, args, args.device, world=True))


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--chunks", type=int, required=True)
    ap.add_argument("--control", action="store_true")
    R.add_rank_args(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return R.rank_main(args, calibrate_rank)
    import torch

    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    spec, _ = R.cell_spec(bench, args.workload)
    chips = int(spec["chips"])
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"portbench.calibrate: the cell needs {chips} CUDA device(s)", file=sys.stderr)
        return 2
    if chips == 1:
        lines = seed_lines(bench, args, device)
    else:
        deadline = R.WORLD_SETUP_S + SEED_S * len(args.seeds.split(","))
        argv = ["--workload", args.workload, "--seeds", args.seeds,
                "--chunks", str(args.chunks)] + (["--control"] if args.control else [])
        try:
            lines = R.run_world("portbench.calibrate", argv, chips, device, deadline, deadline)
        except R.Refused as e:
            print(f"portbench.calibrate: {e}", file=sys.stderr)
            return 2
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
