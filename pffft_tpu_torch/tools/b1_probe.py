#!/usr/bin/env python3
"""What holds B1 (the time-major chain, ``csrc/stockham_chain.cu``) back:
its access pattern alone, and a persistent form that prefetches the next
tile, each beside B1 at its default launch shape, on one card.

    python3 pffft_tpu_torch/tools/b1_probe.py

Builds ``tools/b1_probe.cu`` (nvcc, sm_90a, into the gitignored
``pffft_tpu_torch/_build/``) and prints one JSON line per case, then the
card's name and power limit: ms per call (CUDA events, median of 10 windows
of 5 calls, after warm-up) at (N, B) = (2048, 8192) and (1024, 16384), 64 MB
per plane.  The persistent form is checked against B1's plain version
(2e-6 of max|plain|); the pattern probe computes nothing.  Needs a CUDA
card and nvcc; imports neither jax nor pffft_tpu.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pffft_tpu_torch.ops import _build  # noqa: E402
from pffft_tpu_torch.ops import dispatch as D  # noqa: E402
from pffft_tpu_torch.ops import pallas_fft as pk  # noqa: E402

SRC = Path(__file__).resolve().with_name("b1_probe.cu")
SMS = 132  # H100 SXM


def time_ms(fn, inner: int = 5, reps: int = 10, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / inner)
    return float(np.median(ts))


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "b1_probe.so"
    cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(out), str(SRC)]
    log = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    print(json.dumps({"build": [ln.strip() for ln in (log.stdout + log.stderr).splitlines()
                                if "spill" in ln or "registers" in ln or "error" in ln]}))
    if log.returncode:
        raise RuntimeError(f"nvcc failed on {SRC.name}:\n{log.stdout}{log.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pf_probe_pattern.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.pf_probe_persist.argtypes = [P] * 6 + [I] * 7 + [P]
    for f in (lib.pf_probe_pattern, lib.pf_probe_persist):
        f.restype = I
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_probe: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for n, b, pattern_tbs, persist_tbs in ((2048, 8192, (8, 4), (4,)),
                                           (1024, 16384, (16, 8, 4), (8, 4))):
        plan = D._thin_plan(n)
        re = torch.randn((n, b), generator=gen, device="cuda")
        im = torch.randn((n, b), generator=gen, device="cuda")
        ore, oim = torch.empty_like(re), torch.empty_like(im)
        tile = pk.chain_core_tile(plan, dev)
        b1 = time_ms(lambda: pk.cfft_chain_tmajor(plan, re, im))
        print(json.dumps({"case": "b1_default", "n": n, "b": b, "tile": tile._asdict(),
                          "ms": b1}))
        for tb in pattern_tbs:
            threads = min(512, max(32, -(-(n * tb) // (32 * 32)) * 32))
            call = lambda: lib.pf_probe_pattern(re.data_ptr(), im.data_ptr(), ore.data_ptr(),
                                                oim.data_ptr(), n, b, tb, threads, stream())
            err = call()
            torch.cuda.synchronize()
            exact = err == 0 and bool(torch.equal(ore, re) and torch.equal(oim, im))
            print(json.dumps({"case": "pattern", "n": n, "b": b, "tb": tb, "threads": threads,
                              "err": err, "copy_exact": exact,
                              "ms": time_ms(call) if err == 0 else None, "b1_ms": b1}))
        pr, pi = pk.chain_tmajor_plain(plan, re, im)
        tw, desc, count = pk._core_tables(plan.stages, dev)
        for tb in persist_tbs:
            t = pk.chain_core_tile(plan, dev, tb=tb, elems=32)
            for grid in (SMS, 2 * SMS):
                call = lambda: lib.pf_probe_persist(
                    re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
                    tw.data_ptr(), desc, count, n, b, tb, t.threads, t.shift, grid, stream())
                err = call()
                torch.cuda.synchronize()
                rel = (max(float((ore - pr).abs().max()), float((oim - pi).abs().max()))
                       / float(max(pr.abs().max(), pi.abs().max()))) if err == 0 else None
                print(json.dumps({"case": "persist", "n": n, "b": b, "tb": tb,
                                  "threads": t.threads, "grid": grid, "err": err,
                                  "rel_err": rel, "ms": time_ms(call) if err == 0 else None,
                                  "b1_ms": b1}))
                if err or rel > 2e-6:
                    raise RuntimeError(f"persistent probe failed: err {err}, rel {rel}")
        del re, im, ore, oim, pr, pi
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
