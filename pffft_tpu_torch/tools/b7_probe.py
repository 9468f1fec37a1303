#!/usr/bin/env python3
"""B7's stream map (``csrc/conv_fused.cu``) at nfft 8192 and 16384: the
thin plan (16*16*16*2, 16*16*16*4: four register stages) against a plan
that opens with radix-32 stages (32*16*16, 32*32*16: three), at each
launch shape the core takes, on one card.

    python3 pffft_tpu_torch/tools/b7_probe.py

Builds ``tools/b7_probe.cu`` (nvcc, sm_90a, into the gitignored
``pffft_tpu_torch/_build/``; it includes ``csrc/conv_fused.cu``, so its
instances are the port's own) and prints one JSON line per case, then the
card's name and power limit.  Each case runs the stream map of a 16-row
real stream, [16, 2^22 + F - 1] read in place out of wider rows (as a ring
buffer's view), F = nfft / 2 taps of a lowpass: ms per call (CUDA events,
median of 10 windows of 5 calls, after warm-up; every case timed twice,
the second pass in reverse order), its output against the stream map's
plain version (``conv_kernel.zconv_stream_plain`` on the thin plan, on the
card) as max|diff| / max|plain| (a case above 2e-6 is not timed, and the
probe exits 1), and the blocks per SM the card's occupancy calculator
allows.  Needs a CUDA card and nvcc;
imports neither jax nor pffft_tpu.
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

from pffft_tpu_torch import conv as tc  # noqa: E402
from pffft_tpu_torch import plan as _plan  # noqa: E402
from pffft_tpu_torch.ops import _build  # noqa: E402
from pffft_tpu_torch.ops import conv_kernel as ck  # noqa: E402
from pffft_tpu_torch.ops import pallas_fft as pk  # noqa: E402

SRC = Path(__file__).resolve().with_name("b7_probe.cu")
ROWS = 16
CHUNK = 1 << 22
TOL = 2e-6
# n -> [(label, factors, threads, values a thread, lanes a block)]
CASES = {
    8192: [("thin 512x16", (16, 16, 16, 2), 512, 16, 1),
           ("thin 256x32", (16, 16, 16, 2), 256, 32, 1),
           ("r32 512x16", (32, 16, 16), 512, 16, 1),
           ("r32 256x32", (32, 16, 16), 256, 32, 1),
           ("r32 512x32 two lanes", (32, 16, 16), 512, 32, 2)],
    16384: [("thin 512x32", (16, 16, 16, 4), 512, 32, 1),
            ("r32 512x32", (32, 32, 16), 512, 32, 1)],
}


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
    """The probe's library, built unless a build newer than every source
    it includes is there; prints ptxas's report of its stream kernels."""

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "b7_probe.so"
    log_file = out.with_suffix(".log")
    sources = [SRC, _build.CSRC / "conv_fused.cu", *_build.CSRC.glob("*.cuh")]
    if not (out.exists() and log_file.exists()
            and out.stat().st_mtime > max(p.stat().st_mtime for p in sources)):
        cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(out), str(SRC)]
        log = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if log.returncode:
            out.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {SRC.name}:\n{log.stdout}{log.stderr}")
        log_file.write_text(log.stdout + log.stderr)
    fn, report = None, {}
    for line in log_file.read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            report[fn] = line.strip()
        elif fn and ("registers" in line or "spill" in line):
            report[fn] += " | " + line.strip()
    for fn, text in report.items():
        if "conv_stream_kernel" in fn:
            print(json.dumps({"ptxas": text}))
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pf_probe_stream.argtypes = [P] * 6 + [I] * 13 + [P]
    lib.pf_probe_occupancy.argtypes = [I, I, I, I, ctypes.POINTER(I)]
    lib.pf_probe_stream.restype = lib.pf_probe_occupancy.restype = I
    return lib


def lowpass(taps: int, cutoff: float = 0.1) -> np.ndarray:
    n = np.arange(taps, dtype=np.float64) - (taps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * n) * np.hamming(taps)
    return h / h.sum()


def main() -> int:
    if not torch.cuda.is_available():
        print("b7_probe: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    stream = torch.cuda.current_stream().cuda_stream
    failed = []
    for n, cases in CASES.items():
        fc = tc.FastConv(lowpass(n // 2), device=dev)
        assert fc.nfft == n, (fc.nfft, n)
        hfr, hfi = fc._spectrum(dev)
        u = fc.num_out_per_block
        length = CHUNK + fc.filter_len - 1
        buf = torch.randn((ROWS, length + (1 << 20)), generator=gen, device=dev)
        x = buf[:, 4099:4099 + length]  # rows ld = buf.shape[1] apart
        total = fc._num_consumed(length, False)  # apply_batched(x, flush=False)'s outputs
        frames = -(-total // u)
        lanes = -(-frames // 2)  # two real frames a lane
        want = ck.zconv_stream_plain(pk.thin_plan(n), x, hfr, hfi, u, total)
        scale = float(want.abs().max())
        y = torch.empty((ROWS, total), device=dev)
        calls = {}
        for label, factors, threads, elems, rows in cases:
            plan = _plan.new_setup(n, _plan.COMPLEX, factors=factors, strict=False)
            tw, desc, count = pk._core_tables(plan.stages, dev)
            pitch = pk.core_pad(n - 1, 4) + 1
            smem = rows * pitch * 8
            call = (lambda tw=tw, desc=desc, count=count, threads=threads, elems=elems,
                    rows=rows, pitch=pitch: lib.pf_probe_stream(
                        x.data_ptr(), y.data_ptr(), hfr.data_ptr(), hfi.data_ptr(),
                        tw.data_ptr(), desc, count, n, ROWS, length, x.stride(0), total, u,
                        lanes, rows, threads, elems, pitch, 4, stream))
            y.fill_(float("nan"))
            err = call()
            torch.cuda.synchronize()
            blocks = ctypes.c_int(0)
            occ = lib.pf_probe_occupancy(int(factors[0] == 32), elems, threads, smem,
                                         ctypes.byref(blocks))
            rel = float((y - want).abs().max()) / scale if err == 0 else None
            print(json.dumps({"n": n, "case": label, "factors": factors, "threads": threads,
                              "elems": elems, "lanes_a_block": rows, "smem": smem,
                              "blocks_per_sm": blocks.value if occ == 0 else f"err {occ}",
                              "err": err, "rel_err": rel}))
            if err or not rel <= TOL:
                failed.append((n, label, err, rel))
            else:
                calls[label] = call
        times = {label: [] for label in calls}
        for order in (list(calls), list(calls)[::-1]):
            for label in order:
                times[label].append(time_ms(calls[label]))
        base = times.get(cases[0][0])
        for label, ts in times.items():
            print(json.dumps({"n": n, "case": label, "ms": ts,
                              "vs_first": [b / t for b, t in zip(base, ts)] if base else None}))
        del buf, x, want, y
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip())
    if failed:
        print(f"b7_probe: failed cases (n, case, err, rel_err): {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
