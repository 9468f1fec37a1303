#!/usr/bin/env python3
"""Time the port's kernels that two checkouts may differ in, for an A/B
comparison on one card.

    python3 pffft_tpu_torch/tools/port_ab.py CHECKOUT LABEL [GROUPS]

imports ``pffft_tpu_torch`` from the checkout at CHECKOUT (its kernels are
built into that checkout's ``pffft_tpu_torch/_build/``) and prints one JSON
line: LABEL, the card's name and power limit, and ms per call (CUDA events,
median of 10 windows of 5 calls, after warm-up) of the groups named in
GROUPS (comma-separated; all by default):

  * ``chain``: the time-major chain (B1) at (N, B) = (1024, 16384) and
    (2048, 8192), and the two-pass kern2 engine at (4096, 4096) and
    (65536, 256);
  * ``conv``: the fused block convolution's column map (B7) at (2048,
    32736); FastConv ``apply_batched`` on a [16, 2^22] real stream at 64,
    1024 and 4096 taps;
  * ``real``: the fused real transform (B3) at real (2048, 8192) and (4096,
    4096), forward and backward, the packed chain (B4) at real (8192,
    2048), the public real time-major forward and backward at N = 2048 and
    4096 (B3's route) and the forward at N = 8192 .. 131072 (N*B = 2^24);
  * ``chan``: a channelizer step (``process_split_tmajor``) at (M, P,
    batch, frames) = (4096, 8, 4, 1024) and (1024, 8, 16, 1024);
  * ``dsp``: ``DDCChain`` at 129 taps (decim 8) on 2^24 complex samples,
    ``CicDDC(16)`` on 2^22, an ``OversampledChannelizer(1024, 2, 8)``
    step (``process_split``) on [16, 2^20];
  * ``host``: host µs per public call at small sizes, where the card
    waits on the host (200 calls, one synchronize): complex time-major
    (1024, 16) and batch-major [4, 4096], real time-major (8192, 16) and
    batch-major [4, 1024], FastConv on [1, 20000] at 64 taps, a channelizer
    step at (M, P, batch, frames) = (256, 8, 1, 16);
  * ``chan64``: float64 steps, ``Channelizer(4096, 8)`` on [4, 2^22]
    (``process_split`` and ``process_split_tmajor``) and
    ``OversampledChannelizer(1024, 2, 8).process_split`` on [16, 2^20],
    and the oversampled step's parts: the history-chunk concatenation of
    both planes, the time-major MAC of both planes at one residue, the
    transform over the phases, the move of the channel axis back.

Run it for both checkouts in turns (A, B, B, A) within one call.  Needs a
CUDA card and nvcc; imports neither jax nor pffft_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


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


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    groups = set(sys.argv[3].split(",")) if len(sys.argv) > 3 else {"chain", "conv", "real",
                                                                      "chan", "dsp", "chan64",
                                                                      "host"}
    if not torch.cuda.is_available():
        print("port_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    import pffft_tpu_torch as pt
    from pffft_tpu_torch import channelizer as CH
    from pffft_tpu_torch import conv as C
    from pffft_tpu_torch.ops import conv_kernel as ck
    from pffft_tpu_torch.ops import dispatch as D
    from pffft_tpu_torch.ops import pallas_fft as pk
    from pffft_tpu_torch.ops import split as S

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    out = {"label": label, "root": root, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()}
    if "chain" in groups:
        for n, b in ((1024, 16384), (2048, 8192)):
            plan = D._thin_plan(n)
            re, im = rnd(n, b), rnd(n, b)
            out[f"chain_{n}x{b}_ms"] = time_ms(lambda: pk.cfft_chain_tmajor(plan, re, im))
        for n, b in ((4096, 4096), (65536, 256)):
            plan = pt.new_setup(n)
            re, im = rnd(n, b), rnd(n, b)
            out[f"kern2_{n}x{b}_ms"] = time_ms(lambda: D.cfft_kern2_tmajor(plan, re, im))
        del re, im
    if "conv" in groups:
        n, cols = 2048, 32736
        plan = D._thin_plan(n)
        hfr, hfi = (torch.from_numpy(a).to(dev)
                    for a in ck.filter_spectrum(plan, pt.design_lowpass(1024, 0.1)))
        re, im = rnd(n, cols), rnd(n, cols)
        out["conv_cols_2048x32736_ms"] = time_ms(
            lambda: ck.zconv_tmajor(plan, re, im, hfr, hfi))
        del re, im
        x = rnd(16, 1 << 22)
        for taps in (64, 1024, 4096):
            fc = C.FastConv(pt.design_lowpass(taps, 0.1))
            out[f"fastconv_f{taps}_ms"] = time_ms(lambda: fc.apply_batched(x), inner=2)
        del x
    if "real" in groups:
        for n, b in ((2048, 8192), (4096, 4096)):
            rplan = pt.new_setup(n, pt.REAL)
            y = rnd(n // 2, 2 * b)
            sr, si = rnd(n // 2, b), rnd(n // 2, b)
            tw = S.real_split_twiddle(rplan, dev)
            cplan = D._chain_plan(rplan, dev)
            out[f"real_fused_{n}x{b}_ms"] = time_ms(
                lambda: pk.rfft_chain_tmajor_fused(cplan, y, tw))
            out[f"real_fused_bwd_{n}x{b}_ms"] = time_ms(
                lambda: pk.rfft_bwd_chain_tmajor_fused(cplan, sr, si, tw))
            x = y.view(n, b)
            out[f"real_fwd_{n}_ms"] = time_ms(lambda: pt.transform_ordered_split_tmajor(rplan, x))
            out[f"real_bwd_{n}_ms"] = time_ms(
                lambda: pt.transform_ordered_split_tmajor(rplan, (sr, si), pt.BACKWARD))
        n, b = 8192, 2048
        h = n // 2
        m, r = D._kern2_conf(h, dev)
        mplan = D._build_ksplit(h, m, r)[0]
        yw = rnd(m, r * 2 * b)
        out["chain_packed_8192x2048_ms"] = time_ms(
            lambda: pk.cfft_chain_tmajor_packed(mplan, yw, slabs=r))
        del y, yw, sr, si
        for n in (8192, 16384, 32768, 65536, 131072):
            rplan = pt.new_setup(n, pt.REAL)
            x = rnd(n, (1 << 24) // n)
            out[f"real_fwd_{n}_ms"] = time_ms(
                lambda: pt.transform_ordered_split_tmajor(rplan, x))
        del x
    if "chan" in groups:
        for m, p, batch, frames in ((4096, 8, 4, 1024), (1024, 8, 16, 1024)):
            ch = CH.Channelizer(m, p)
            xr, xi = rnd(batch, frames * m), rnd(batch, frames * m)
            st = ch.init_state((batch,))
            out[f"chan_step_{m}_ms"] = time_ms(
                lambda: ch.process_split_tmajor(st, xr, xi), inner=2)
            del xr, xi
    if "dsp" in groups:
        x = torch.complex(rnd(1 << 24), rnd(1 << 24))
        ddc = CH.DDCChain(-0.1, pt.design_lowpass(129, 0.5 / 8), 8)
        st = ddc.init_state()
        out["ddc_chain_129_2p24_ms"] = time_ms(lambda: ddc.process(st, x), inner=2)
        cic = pt.dsp.CicDDC(16)
        cst, xc = cic.init_state(), x[: 1 << 22]
        out["cic_16_2p22_ms"] = time_ms(lambda: cic.apply(cst, xc, 0.123), inner=2)
        del x, xc
        och = CH.OversampledChannelizer(1024, 2, 8)
        xr, xi = rnd(16, 1 << 20), rnd(16, 1 << 20)
        st = och.init_state((16,))
        out["oversampled_step_1024_ms"] = time_ms(lambda: och.process_split(st, xr, xi), inner=2)
        del xr, xi
    if "host" in groups:
        def host_us(fn, calls=200):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / calls * 1e6

        cplan, rplan = pt.new_setup(1024), pt.new_setup(8192, pt.REAL)
        re, im, x = rnd(1024, 16), rnd(1024, 16), rnd(8192, 16)
        br, bi, bx = rnd(4, 4096), rnd(4, 4096), rnd(4, 1024)
        fc = C.FastConv(pt.design_lowpass(64, 0.1))
        xs = rnd(1, 20000)
        ch = CH.Channelizer(256, 8)
        st, cr, ci = ch.init_state((1,)), rnd(1, 16 * 256), rnd(1, 16 * 256)
        bplan, brplan = pt.new_setup(4096), pt.new_setup(1024, pt.REAL)
        out["host_us"] = {
            "complex_tmajor_1024x16": host_us(
                lambda: pt.transform_ordered_split_tmajor(cplan, (re, im))),
            "complex_bmajor_4x4096": host_us(lambda: pt.transform_ordered_split(bplan, (br, bi))),
            "real_tmajor_8192x16": host_us(lambda: pt.transform_ordered_split_tmajor(rplan, x)),
            "real_bmajor_4x1024": host_us(lambda: pt.transform_ordered_split(brplan, bx)),
            "fastconv_f64_1x20000": host_us(lambda: fc.apply_batched(xs)),
            "channelizer_256x16": host_us(lambda: ch.process_split(st, cr, ci))}
    if "chan64" in groups:
        f64 = {"generator": gen, "device": "cuda", "dtype": torch.float64}
        ch = CH.Channelizer(4096, 8, dtype="float64")
        xr, xi = torch.randn((4, 1 << 22), **f64), torch.randn((4, 1 << 22), **f64)
        st = ch.init_state((4,))
        out["chan64_step_4096_ms"] = time_ms(lambda: ch.process_split(st, xr, xi), 1, 5, 1)
        out["chan64_tmajor_step_4096_ms"] = time_ms(
            lambda: ch.process_split_tmajor(st, xr, xi), 1, 5, 1)
        och = CH.OversampledChannelizer(1024, 2, 8, dtype="float64")
        xr, xi = torch.randn((16, 1 << 20), **f64), torch.randn((16, 1 << 20), **f64)
        st = och.init_state((16,))
        out["chan64_over_1024_ms"] = time_ms(lambda: och.process_split(st, xr, xi), 1, 5, 1)
        b, k = och.base, (1 << 20) // 1024
        ext = [torch.cat([h, c], dim=-1) for h, c in zip(st, (xr, xi))]
        v = tuple(b._mac_tmajor(e, k, 0) for e in ext)
        y = pt.transform_ordered_split_tmajor(b.plan, v, pt.BACKWARD)
        out["chan64_over_parts_ms"] = {
            "concat": time_ms(lambda: [torch.cat([h, c], dim=-1) for h, c in zip(st, (xr, xi))],
                              1, 5, 1),
            "mac_one_residue": time_ms(lambda: [b._mac_tmajor(e, k, 512) for e in ext], 1, 5, 1),
            "transform": time_ms(
                lambda: pt.transform_ordered_split_tmajor(b.plan, v, pt.BACKWARD), 1, 5, 1),
            "channels_back": time_ms(
                lambda: [t.reshape(1024, 16, k).movedim(0, -1).contiguous() for t in y], 1, 5, 1)}
        del xr, xi, ext, v, y
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
