#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA GPU and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):
  1. environment: CUDA, compute capability, nvcc, triton, card and power limit;
  2. build: nvcc compiles pffft_tpu_torch/csrc/*.cu (sm_90a), in parallel;
  3. each kernel against its plain version on the card, at the shapes the
     two main paths give it and at small, non-power-of-two and ragged ones;
  4. the complex main path, ``transform_ordered_split_tmajor`` at the bench
     band shapes (64 MB per plane), forward and backward, checked against a
     complex128 oracle, the unscaled round trip and the 140 dB carrier
     bound; launch counters show which kernels served it;
  5. the real main path, the same entry point on REAL plans at the real band
     shapes (a 64 MB [N, B] signal), checked the same way against a
     complex128 ``torch.fft.rfft``; the launch counts of each shape must
     match its route (the fused real kernel, or the packed chain + combine
     + split kernel);
  6. timing with CUDA events (median of 10 after warm-up), per band shape
     and per kernel, beside the bound, the plain version and torch.fft;
  7. the ``kernels`` line, the card line, and the final ``ok`` line.

Needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and the
repository checkout.  It imports neither jax nor pffft_tpu.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

import pffft_tpu_torch as pt
from pffft_tpu_torch.ops import _build
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import pallas_fft as pk
from pffft_tpu_torch.ops import split as S

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
BAND = ((1024, 16384), (2048, 8192), (4096, 4096), (8192, 2048),
        (16384, 1024), (32768, 512), (65536, 256))
# real N, B: a 64 MB signal in, two 32 MB spectrum planes [N/2, B] out
REAL_BAND = ((2048, 8192), (4096, 4096), (8192, 2048), (16384, 1024),
             (32768, 512), (65536, 256), (131072, 128))
KERNEL_TOL = 2e-6   # kernel vs plain, relative to max|plain|: FMA contraction
ORACLE_TOL = 1e-5   # vs the complex128 oracle, relative to max|oracle|
ROUND_TRIP_TOL = 1e-5
CARRIER_DB = 140.0
REPS = 10
SEED = 1234
WRAPPERS = (pk.cfft_chain_tmajor, pk.cfft_combine_tmajor, pk.stream_copy,
            pk.cfft_chain_tmajor_packed, pk.rfft_chain_tmajor_fused,
            pk.rfft_bwd_chain_tmajor_fused, pk.real_split_tmajor)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def planes(n: int, b: int, gen: torch.Generator):
    shape = (n, b)
    return (torch.randn(shape, generator=gen, device="cuda"),
            torch.randn(shape, generator=gen, device="cuda"))


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def time_ms(fn, inner: int = 5) -> float:
    """ms per call: the median over REPS CUDA-event windows, each around
    ``inner`` back-to-back calls, after warm-up."""

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / inner)
    return float(np.median(ts))


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the f32 peak."""

    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fft_flops(n: int, b: int) -> float:
    return 5.0 * n * math.log2(n) * b


def combine_flops(m: int, r: int, b: int) -> float:
    # one complex multiply per twiddled input plus the radix-r butterfly
    return (6.0 * (r - 1) + 5.0 * r * math.log2(r)) * m * b


def counts():
    return {w.__name__: w.launches for w in WRAPPERS}


def launched(after, before):
    """The wrappers that launched between two counts, with how often."""

    return {k: v - before[k] for k, v in after.items() if v != before[k]}


def real_tw(h: int):
    return S.real_split_twiddle(pt.new_setup(2 * h, pt.REAL),
                                torch.device("cuda"))


def reset_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    nv = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60, check=True).stdout.strip()
    try:
        import triton  # noqa: F401  (information only; the port does not use it)
        has_triton = True
    except ImportError:
        has_triton = False
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0)),
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sms": props.multi_processor_count,
          "smem_per_block_optin": pk.smem_per_block(torch.device("cuda")),
          "nvcc": nv.splitlines()[-1], "triton": has_triton, "nvidia_smi": smi,
          "chain_max_n": pk.chain_max_n(torch.device("cuda"))})
    return smi


def phase_build():
    secs = _build.build()
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in _build.log_path(name).read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "source": name, "ptxas": lines})
    emit({"phase": "build", "seconds": secs})


def phase_kernels(gen):
    """Each kernel against its plain version, at the shapes the main path
    gives it and at small, non-power-of-two and ragged ones; returns the
    max abs errors."""

    dev = torch.device("cuda")
    errs = {name: 0.0 for name in ("chain", "combine", "chain_packed", "real_fused",
                                   "real_split")}

    def hold(name, kern, plain, case, dirs=(False, True)):
        for bwd in dirs:
            kr, ki = kern(bwd)
            pr, pi = plain(bwd)
            torch.cuda.synchronize()
            e = max(rel_err(kr, pr), rel_err(ki, pi))
            errs[name] = max(errs[name], float((kr - pr).abs().max()),
                             float((ki - pi).abs().max()))
            emit({"phase": "kernel", "kernel": name, **case, "backward": bwd,
                  "rel_err": e})
            check(e <= KERNEL_TOL, f"{name} {case} bwd={bwd}: {e}")

    def chain_case(plan, n, b, tb=None):
        re, im = planes(n, b, gen)
        hold("chain",
             lambda bwd: pk.cfft_chain_tmajor(plan, re, im, backward=bwd, tb=tb),
             lambda bwd: pk.chain_tmajor_plain(plan, re, im, backward=bwd),
             {"n": n, "b": b, "tb": tb, "factors": list(plan.factors)})

    def combine_case(last, b):
        n = last.l * last.r
        re, im = planes(n, b, gen)
        hold("combine",
             lambda bwd: pk.cfft_combine_tmajor(last, re, im, backward=bwd),
             lambda bwd: pk.combine_tmajor_plain(last, re, im, backward=bwd),
             {"m": last.l, "r": last.r, "b": b})

    # the main path's kernel calls, shape for shape
    for n, b in BAND:
        engine = D.select_engine(pt.new_setup(n), b, True, dev)
        if engine == "chain":
            chain_case(D._chain_plan(pt.new_setup(n), dev), n, b)
        else:
            m, r = D._kern2_conf(n, dev)
            mplan, last = D._build_ksplit(n, m, r)
            chain_case(mplan, m, r * b)
            combine_case(last, b)
    # small, non-power-of-two and ragged batches (B=1001 takes the scalar
    # loads); N=2400 is routed to kern2 (no 8-column tile fits), and the
    # kernel still runs it at 4 columns
    for n in (96, 160, 640, 1024, 2400, pk.chain_max_n(dev)):
        plan = D._thin_plan(n)
        tb = pk.chain_tile(n, [st.r for st in plan.stages], dev) or 4
        for b in (1024, 1000, 1001):
            chain_case(plan, n, b, tb)
    for r in pk.COMBINE_RADICES:
        for b in (256, 250):
            combine_case(D._build_ksplit(2048 * r, 2048, r)[1], b)

    def packed_case(plan, m, b, slabs):
        y = planes(m, slabs * 2 * b, gen)[0]
        hold("chain_packed",
             lambda bwd: pk.cfft_chain_tmajor_packed(plan, y, slabs=slabs),
             lambda bwd: pk.chain_tmajor_packed_plain(plan, y, slabs=slabs),
             {"n": m, "b": b, "slabs": slabs, "factors": list(plan.factors)},
             dirs=(False,))  # a forward-only kernel: the real forward's input

    def fused_case(plan, h, b):
        tw = real_tw(h)
        y = planes(h, 2 * b, gen)[0]
        sr, si = planes(h, b, gen)
        hold("real_fused",
             lambda bwd: (pk.rfft_bwd_chain_tmajor_fused(plan, sr, si, tw) if bwd
                          else pk.rfft_chain_tmajor_fused(plan, y, tw)),
             lambda bwd: (pk.rfft_bwd_chain_tmajor_fused_plain(plan, sr, si, tw) if bwd
                          else pk.rfft_chain_tmajor_fused_plain(plan, y, tw)),
             {"h": h, "b": b, "factors": list(plan.factors)})

    def split_case(h, b):
        tw = real_tw(h)
        zr, zi = planes(h, b, gen)
        hold("real_split",
             lambda bwd: pk.real_split_tmajor(zr, zi, tw, backward=bwd),
             lambda bwd: pk.real_split_tmajor_plain(zr, zi, tw, backward=bwd),
             {"h": h, "b": b})

    # the real path's kernel calls, shape for shape
    for n, b in REAL_BAND:
        plan, h = pt.new_setup(n, pt.REAL), n // 2
        if D.select_engine(plan, b, True, dev) == "chain":
            fused_case(D._chain_plan(plan, dev), h, b)
        else:
            m, r = D._kern2_conf(h, dev)
            mplan, last = D._build_ksplit(h, m, r)
            packed_case(mplan, m, b, r)
            chain_case(mplan, m, r * b)  # the backward's pass A
            combine_case(last, b)
            split_case(h, b)
    # small and non-power-of-two H, ragged and odd batches (B=1001 takes
    # the scalar loads and stores)
    for b in (1000, 1001):
        for h in (96, 960):
            fused_case(D._thin_plan(h), h, b)
            packed_case(D._thin_plan(h), h, b, 1)
            split_case(h, b)
        packed_case(D._thin_plan(2048), 2048, b, 2)
        split_case(2400, b)
    re, im = planes(1024, 16384, gen)
    cr, ci = pk.stream_copy(re, im)
    torch.cuda.synchronize()
    exact = bool(torch.equal(cr, re) and torch.equal(ci, im))
    emit({"phase": "kernel", "kernel": "copy", "bit_exact": exact})
    check(exact, "copy kernel is not bit-exact")
    errs["copy"] = 0.0
    return errs


def carrier_db(n: int) -> float:
    """Smallest carrier dynamic range over the test_pffft.c carrier sweep."""

    ks = list(range(0, n, max(1, n // 16)))
    cols = []
    for j, k in enumerate(ks):
        amp = 1.0 if j % 3 == 0 else 1.1
        phi = (j % 4) * 0.125 * np.pi + 2.0 * np.pi * ((k if k < n / 2 else k - n) / n) \
            * np.arange(n, dtype=np.float64)
        cols.append(amp * np.exp(1j * phi))
    x = np.stack(cols, axis=1).astype(np.complex64)
    plan = pt.new_setup(n)
    yr, yi = pt.transform_ordered_split_tmajor(plan, (x.real, x.imag), device="cuda")
    y = yr.cpu().numpy().astype(np.float64) + 1j * yi.cpu().numpy()
    worst = np.inf
    for j, k in enumerate(ks):
        p = np.abs(y[:, j]) ** 2
        car = p[k]
        p[k] = 0.0
        worst = min(worst, 10.0 * (np.log10(car) - np.log10(max(p.max(), 1e-300))))
    return float(worst)


def phase_main_path(gen):
    """The public transform at the band shapes; returns the launch counts."""

    reset_counts()
    per_shape = []
    for n, b in BAND:
        plan = pt.new_setup(n)
        engine = D.select_engine(plan, b, True, torch.device("cuda"))
        before = counts()
        re, im = planes(n, b, gen)
        yr, yi = pt.transform_ordered_split_tmajor(plan, (re, im), pt.FORWARD)
        br, bi = pt.transform_ordered_split_tmajor(plan, (yr, yi), pt.BACKWARD)
        torch.cuda.synchronize()
        cols = torch.arange(0, b, max(1, b // 8), device="cuda")
        z = torch.complex(re[:, cols].double(), im[:, cols].double())
        ref = torch.fft.fft(z, dim=0)
        e_fwd = rel_err(torch.complex(yr[:, cols].double(), yi[:, cols].double()), ref)
        e_rt = max(rel_err(br / n, re), rel_err(bi / n, im))
        delta = {k: v - before[k] for k, v in counts().items()}
        finite = bool(torch.isfinite(yr).all() and torch.isfinite(yi).all())
        emit({"phase": "main", "n": n, "b": b, "engine": engine,
              "fwd_rel_err": e_fwd, "roundtrip_rel_err": e_rt, "finite": finite,
              "launches": delta})
        check(finite and yr.shape == (n, b), f"N={n}: output not finite/shaped")
        check(e_fwd <= ORACLE_TOL, f"N={n}: forward error {e_fwd}")
        check(e_rt <= ORACLE_TOL, f"N={n}: round-trip error {e_rt}")
        check(engine in ("chain", "kern2"), f"N={n}: engine {engine}")
        want_combine = 2 if engine == "kern2" else 0
        check(delta["cfft_chain_tmajor"] == 2
              and delta["cfft_combine_tmajor"] == want_combine,
              f"N={n}: launches {delta} do not match engine {engine}")
        per_shape.append((n, b, engine))
        del re, im, yr, yi, br, bi
    for n in (1024, 4096, 65536):
        db = carrier_db(n)
        emit({"phase": "main", "carrier_n": n, "dynamic_range_db": db})
        check(db >= CARRIER_DB, f"N={n}: carrier dynamic range {db} dB")
    launches = counts()
    emit({"phase": "main", "launches": launches})
    return launches, per_shape


def real_carrier_db(n: int) -> float:
    """Smallest carrier dynamic range over the test_pffft.c real carrier
    sweep (cosines at bins 0 .. N/2; the packed bin0 is DC + i*Nyquist)."""

    ks = list(range(0, n // 2 + 1, max(1, n // 16)))
    cols = []
    for j, k in enumerate(ks):
        amp = 1.0 if j % 3 == 0 else 1.1
        cols.append(amp * np.cos((j % 4) * 0.125 * np.pi
                                 + 2.0 * np.pi * (k / n) * np.arange(n, dtype=np.float64)))
    x = np.stack(cols, axis=1).astype(np.float32)
    yr, yi = pt.transform_ordered_split_tmajor(pt.new_setup(n, pt.REAL), x, device="cuda")
    yr = yr.cpu().numpy().astype(np.float64)
    yi = yi.cpu().numpy().astype(np.float64)
    h = n // 2
    power = np.empty((h + 1, len(ks)))
    power[0], power[h] = yr[0] ** 2, yi[0] ** 2
    power[1:h] = yr[1:] ** 2 + yi[1:] ** 2
    worst = np.inf
    for j, k in enumerate(ks):
        p = power[:, j].copy()
        car = p[k]
        p[k] = 0.0
        worst = min(worst, 10.0 * (np.log10(car) - np.log10(max(p.max(), 1e-300))))
    return float(worst)


# wrappers launched by one call of each real route, per direction
REAL_ROUTE_LAUNCHES = {
    "chain": ({"rfft_chain_tmajor_fused": 1}, {"rfft_bwd_chain_tmajor_fused": 1}),
    "kern2": ({"cfft_chain_tmajor_packed": 1, "cfft_combine_tmajor": 1,
               "real_split_tmajor": 1},
              {"real_split_tmajor": 1, "cfft_chain_tmajor": 1, "cfft_combine_tmajor": 1}),
}


def phase_real_main_path(gen):
    """The public transform on REAL plans at the real band shapes; returns
    the launch counts."""

    reset_counts()
    per_shape = []
    for n, b in REAL_BAND:
        plan = pt.new_setup(n, pt.REAL)
        engine = D.select_engine(plan, b, True, torch.device("cuda"))
        x = torch.randn((n, b), generator=gen, device="cuda")
        c0 = counts()
        yr, yi = pt.transform_ordered_split_tmajor(plan, x, pt.FORWARD)
        c1 = counts()
        back = pt.transform_ordered_split_tmajor(plan, (yr, yi), pt.BACKWARD)
        torch.cuda.synchronize()
        c2 = counts()
        cols = torch.arange(0, b, max(1, b // 8), device="cuda")
        ref = torch.fft.rfft(x[:, cols].double(), dim=0)
        packed = ref[: n // 2].clone()
        packed[0] = torch.complex(ref[0].real, ref[n // 2].real)
        e_fwd = rel_err(torch.complex(yr[:, cols].double(), yi[:, cols].double()), packed)
        e_rt = rel_err(back / n, x)
        fwd, bwd = launched(c1, c0), launched(c2, c1)
        finite = bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()
                      and torch.isfinite(back).all())
        emit({"phase": "real_main", "n": n, "b": b, "engine": engine,
              "fwd_rel_err": e_fwd, "roundtrip_rel_err": e_rt, "finite": finite,
              "fwd_launches": fwd, "bwd_launches": bwd})
        check(finite and yr.shape == (n // 2, b) and back.shape == (n, b),
              f"real N={n}: output not finite/shaped")
        check(e_fwd <= ORACLE_TOL, f"real N={n}: forward error {e_fwd}")
        check(e_rt <= ROUND_TRIP_TOL, f"real N={n}: round-trip error {e_rt}")
        check(engine in REAL_ROUTE_LAUNCHES, f"real N={n}: engine {engine}")
        check((fwd, bwd) == REAL_ROUTE_LAUNCHES[engine],
              f"real N={n}: launches {fwd}, {bwd} do not match engine {engine}")
        per_shape.append((n, b, engine))
        del x, yr, yi, back
    for n in (2048, 8192, 131072):
        db = real_carrier_db(n)
        emit({"phase": "real_main", "carrier_n": n, "dynamic_range_db": db})
        check(db >= CARRIER_DB, f"real N={n}: carrier dynamic range {db} dB")
    launches = counts()
    emit({"phase": "real_main", "launches": launches})
    return launches, per_shape


def phase_real_timing(gen, per_shape):
    """Times per real band shape and per pass; returns the real kernels'
    rows."""

    dev = torch.device("cuda")
    rows = {}
    for n, b, engine in per_shape:
        plan, h = pt.new_setup(n, pt.REAL), n // 2
        x = torch.randn((n, b), generator=gen, device="cuda")
        yr, yi = pt.transform_ordered_split_tmajor(plan, x)
        # one read of the [N, B] signal, one write of the two [H, B] planes
        bnd = bound(8.0 * n * b, fft_flops(h, b) + 16.0 * h * b)
        lib_fwd = time_ms(lambda: torch.fft.rfft(x, dim=0))
        spec = torch.fft.rfft(x, dim=0)
        lib_bwd = time_ms(lambda: torch.fft.irfft(spec, n=n, dim=0))
        del spec
        fwd = time_ms(lambda: pt.transform_ordered_split_tmajor(plan, x))
        bwd = time_ms(lambda: pt.transform_ordered_split_tmajor(plan, (yr, yi), pt.BACKWARD))
        rec = {"phase": "real_time", "n": n, "b": b, "engine": engine, "fwd_ms": fwd,
               "bwd_ms": bwd, "bound_ms": bnd[0], "bound_by": bnd[1],
               "frac_bound_fwd": bnd[0] / fwd, "frac_bound_bwd": bnd[0] / bwd,
               "library_fwd_ms": lib_fwd, "library_bwd_ms": lib_bwd}
        tw = S.real_split_twiddle(plan, dev)
        y = x.view(h, 2 * b)
        if engine == "chain":
            cplan = D._chain_plan(plan, dev)
            k_f = time_ms(lambda: pk.rfft_chain_tmajor_fused(cplan, y, tw))
            k_b = time_ms(lambda: pk.rfft_bwd_chain_tmajor_fused(cplan, yr, yi, tw))
            p_f = time_ms(lambda: pk.rfft_chain_tmajor_fused_plain(cplan, y, tw))
            p_b = time_ms(lambda: pk.rfft_bwd_chain_tmajor_fused_plain(cplan, yr, yi, tw))
            rec.update(fused_fwd_ms=k_f, fused_bwd_ms=k_b, plain_fwd_ms=p_f,
                       plain_bwd_ms=p_b)
            if n == 2048:
                rows["real_fused"] = dict(ms=k_f, bwd_ms=k_b, plain_ms=p_f,
                                          plain_bwd_ms=p_b, library_ms=lib_fwd,
                                          shape=[n, b], bound_ms=bnd[0], bound_by=bnd[1])
        else:
            m, r = D._kern2_conf(h, dev)
            mplan, last = D._build_ksplit(h, m, r)
            yw = y.reshape(m, r * 2 * b)
            ar, ai = pk.cfft_chain_tmajor_packed(mplan, yw, slabs=r)
            ar, ai = ar.reshape(h, b), ai.reshape(h, b)
            zr, zi = pk.cfft_combine_tmajor(last, ar, ai)
            sr, si = pk.real_split_tmajor(yr, yi, tw, backward=True)
            vr, vi = sr.reshape(m, r * b), si.reshape(m, r * b)
            wr, wi = pk.cfft_chain_tmajor(mplan, vr, vi, backward=True)
            wr, wi = wr.reshape(h, b), wi.reshape(h, b)
            passes = {
                "fwd_packed_chain_ms": lambda: pk.cfft_chain_tmajor_packed(mplan, yw, slabs=r),
                "fwd_combine_ms": lambda: pk.cfft_combine_tmajor(last, ar, ai),
                "fwd_split_ms": lambda: pk.real_split_tmajor(zr, zi, tw),
                "bwd_split_ms": lambda: pk.real_split_tmajor(yr, yi, tw, backward=True),
                "bwd_chain_ms": lambda: pk.cfft_chain_tmajor(mplan, vr, vi, backward=True),
                "bwd_combine_ms": lambda: pk.cfft_combine_tmajor(last, wr, wi, backward=True),
                "bwd_interleave_ms": lambda: S.interleave_to_real_split_tmajor(wr, wi),
                "plain_packed_chain_ms":
                    lambda: pk.chain_tmajor_packed_plain(mplan, yw, slabs=r),
                "plain_split_ms": lambda: pk.real_split_tmajor_plain(zr, zi, tw),
            }
            rec.update(conf=[m, r], **{k: time_ms(f) for k, f in passes.items()})
            if n == 8192:
                # each reads 64 MB and writes 64 MB, as the whole call does
                pbnd = bound(8.0 * n * b, fft_flops(m, r * b))
                rows["chain_packed"] = dict(
                    ms=rec["fwd_packed_chain_ms"], plain_ms=rec["plain_packed_chain_ms"],
                    library_ms=None, shape=[m, r, b], bound_ms=pbnd[0], bound_by=pbnd[1])
                sbnd = bound(8.0 * n * b, 16.0 * h * b)
                rows["real_split"] = dict(
                    ms=rec["fwd_split_ms"], bwd_ms=rec["bwd_split_ms"],
                    plain_ms=rec["plain_split_ms"], library_ms=None, shape=[h, b],
                    bound_ms=sbnd[0], bound_by=sbnd[1])
            del ar, ai, zr, zi, sr, si, vr, vi, wr, wi
        emit(rec)
        del x, yr, yi
    # the host's share of a public real call at a small batch: the kern2
    # route's three route decisions and three launches, against the same
    # three wrappers called directly
    n, b, calls = 8192, 16, 200
    plan, h = pt.new_setup(n, pt.REAL), n // 2
    x = torch.randn((n, b), generator=gen, device="cuda")
    m, r = D._kern2_conf(h, dev)
    mplan, last = D._build_ksplit(h, m, r)
    tw = S.real_split_twiddle(plan, dev)
    yw = x.view(m, r * 2 * b)
    ar, ai = pk.cfft_chain_tmajor_packed(mplan, yw, slabs=r)
    ar, ai = ar.reshape(h, b), ai.reshape(h, b)
    wrappers_ms = (time_ms(lambda: pk.cfft_chain_tmajor_packed(mplan, yw, slabs=r), inner=50)
                   + time_ms(lambda: pk.cfft_combine_tmajor(last, ar, ai), inner=50)
                   + time_ms(lambda: pk.real_split_tmajor(ar, ai, tw), inner=50))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        pt.transform_ordered_split_tmajor(plan, x)
    torch.cuda.synchronize()
    emit({"phase": "host", "real_n": n, "b": b,
          "public_call_us": (time.perf_counter() - t0) / calls * 1e6,
          "wrappers_event_us": wrappers_ms * 1e3})
    return rows


def phase_timing(gen, per_shape):
    """Times per band shape and per kernel; returns the kernels' rows."""

    dev = torch.device("cuda")
    re, im = planes(1024, 16384, gen)
    copy_ms = time_ms(lambda: pk.stream_copy(re, im))
    copy_lib = time_ms(lambda: (torch.empty_like(re).copy_(re),
                                torch.empty_like(im).copy_(im)))
    nbytes = 16.0 * re.numel()
    ceiling = nbytes / (copy_ms * 1e-3)
    rows = {"copy": dict(ms=copy_ms, plain_ms=time_ms(lambda: pk.stream_copy_plain(re, im)),
                         library_ms=copy_lib, shape=[1024, 16384],
                         **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 0.0))))}
    emit({"phase": "time", "kernel": "copy", "n": 1024, "b": 16384, "ms": copy_ms,
          "gbps": nbytes / copy_ms / 1e6, "frac_spec": nbytes / (copy_ms * 1e-3) / HBM_BYTES_PER_S,
          "library_ms": copy_lib})
    del re, im
    for n, b, engine in per_shape:
        plan = pt.new_setup(n)
        re, im = planes(n, b, gen)
        nbytes = 16.0 * n * b
        z = torch.complex(re, im)
        lib_ms = time_ms(lambda: torch.fft.fft(z, dim=0))
        del z
        fwd = time_ms(lambda: pt.transform_ordered_split_tmajor(plan, (re, im)))
        bwd = time_ms(lambda: pt.transform_ordered_split_tmajor(plan, (re, im), pt.BACKWARD))
        rec = {"phase": "time", "n": n, "b": b, "engine": engine, "fwd_ms": fwd,
               "bwd_ms": bwd, "gbps": nbytes / fwd / 1e6,
               "frac_spec": nbytes / (fwd * 1e-3) / HBM_BYTES_PER_S,
               "frac_copy_ceiling": nbytes / (fwd * 1e-3) / ceiling,
               "gflops": fft_flops(n, b) / fwd / 1e6,
               "frac_bound": bound(nbytes, fft_flops(n, b))[0] / fwd,
               "launches_per_call": 1 if engine == "chain" else 2,
               "library_ms": lib_ms, "bound_ms": bound(nbytes, fft_flops(n, b))[0]}
        if engine == "chain":
            cplan = D._chain_plan(plan, dev)
            k_ms = time_ms(lambda: pk.cfft_chain_tmajor(cplan, re, im))
            p_ms = time_ms(lambda: pk.chain_tmajor_plain(cplan, re, im))
            rec.update(chain_ms=k_ms, plain_ms=p_ms)
            if n == 2048:
                rows["chain"] = dict(
                    ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, shape=[n, b],
                    **dict(zip(("bound_ms", "bound_by"),
                               bound(nbytes, fft_flops(n, b)))))
        else:
            m, r = D._kern2_conf(n, dev)
            mplan, last = D._build_ksplit(n, m, r)
            ar, ai = re.reshape(m, r * b), im.reshape(m, r * b)
            za, zi = pk.cfft_chain_tmajor(mplan, ar, ai)
            za, zi = za.reshape(n, b), zi.reshape(n, b)
            a_ms = time_ms(lambda: pk.cfft_chain_tmajor(mplan, ar, ai))
            b_ms = time_ms(lambda: pk.cfft_combine_tmajor(last, za, zi))
            pa_ms = time_ms(lambda: pk.chain_tmajor_plain(mplan, ar, ai))
            pb_ms = time_ms(lambda: pk.combine_tmajor_plain(last, za, zi))
            rec.update(conf=[m, r], pass_a_ms=a_ms, pass_b_ms=b_ms,
                       plain_ms=pa_ms + pb_ms, pass_a_plain_ms=pa_ms,
                       pass_b_plain_ms=pb_ms)
            if n == 65536:
                rows["combine"] = dict(
                    ms=b_ms, plain_ms=pb_ms, library_ms=None, shape=[n, b],
                    **dict(zip(("bound_ms", "bound_by"),
                               bound(nbytes, combine_flops(m, r, b)))))
            del za, zi
        emit(rec)
        del re, im
    # where one pass stops and two begin, at 64 MB per plane: the chain at
    # the tile widths that fit against kern2's (m, r) splits on either side
    # of the coverage limit (chain_tile's smallest tile)
    for n, tbs, confs in ((2048, (8, 4), ((1024, 2),)),
                          (4096, (4, 2), ((2048, 2), (1024, 4)))):
        b = (1 << 24) // n
        plan = D._thin_plan(n)
        re, im = planes(n, b, gen)
        rec = {"phase": "split", "n": n, "b": b}
        for tb in tbs:
            rec[f"chain_tb{tb}_ms"] = time_ms(
                lambda: pk.cfft_chain_tmajor(plan, re, im, tb=tb))
        # an odd batch takes the kernel's scalar loads and stores
        ro, io = re[:, 1:].contiguous(), im[:, 1:].contiguous()
        rec[f"chain_tb{tbs[0]}_odd_b_ms"] = time_ms(
            lambda: pk.cfft_chain_tmajor(plan, ro, io, tb=tbs[0]))
        del ro, io
        for m, r in confs:
            rec[f"kern2_{m}x{r}_ms"] = time_ms(
                lambda: D.cfft_kern2_tmajor(plan, re, im, conf=(m, r)))
        emit(rec)
        del re, im
    # the host's share of a public call: at a small batch the card waits on
    # the host (planning lookups, engine choice, ctypes launch)
    n, b, calls = 1024, 16, 200
    plan = pt.new_setup(n)
    re, im = planes(n, b, gen)
    cplan = D._chain_plan(plan, dev)
    kernel_ms = time_ms(lambda: pk.cfft_chain_tmajor(cplan, re, im), inner=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        pt.transform_ordered_split_tmajor(plan, (re, im))
    torch.cuda.synchronize()
    emit({"phase": "host", "n": n, "b": b,
          "public_call_us": (time.perf_counter() - t0) / calls * 1e6,
          "chain_wrapper_event_us": kernel_ms * 1e3})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    smi = phase_env()
    phase_build()
    errs = phase_kernels(gen)
    launches, per_shape = phase_main_path(gen)
    real_launches, real_shapes = phase_real_main_path(gen)
    rows = phase_timing(gen, per_shape)
    rows.update(phase_real_timing(gen, real_shapes))
    for name in ("chain", "combine", "copy", "chain_packed", "real_fused", "real_split"):
        check(name in rows, f"no timing row for {name}")
    check(launches["cfft_chain_tmajor"] > 0 and launches["cfft_combine_tmajor"] > 0,
          f"complex main path did not launch every path kernel: {launches}")
    for name in ("cfft_chain_tmajor_packed", "rfft_chain_tmajor_fused",
                 "rfft_bwd_chain_tmajor_fused", "real_split_tmajor"):
        check(real_launches[name] > 0,
              f"real main path did not launch every path kernel: {real_launches}")
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # launches: the count over both main-path runs (each from zero)
    meta = {
        "chain": ("pffft_tpu_torch/csrc/stockham_chain.cu",
                  "pffft_tpu/ops/pallas_fft.py:950", ("cfft_chain_tmajor",)),
        "combine": ("pffft_tpu_torch/csrc/combine.cu",
                    "pffft_tpu/ops/pallas_fft.py:1135", ("cfft_combine_tmajor",)),
        "copy": ("pffft_tpu_torch/csrc/stream_copy.cu",
                 "pffft_tpu/ops/pallas_fft.py:1299", ("stream_copy",)),
        "chain_packed": ("pffft_tpu_torch/csrc/chain_packed.cu",
                         "pffft_tpu/ops/pallas_fft.py:1189", ("cfft_chain_tmajor_packed",)),
        "real_fused": ("pffft_tpu_torch/csrc/real_fused.cu",
                       "pffft_tpu/ops/pallas_fft.py:586",
                       ("rfft_chain_tmajor_fused", "rfft_bwd_chain_tmajor_fused")),
        "real_split": ("pffft_tpu_torch/csrc/real_split.cu",
                       "pffft_tpu/ops/pallas_fft.py:723", ("real_split_tmajor",)),
    }
    kernels = []
    for name, (src, rep, wrappers) in meta.items():
        row = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": sum(launches[w] + real_launches[w] for w in wrappers),
                        "max_abs_err": errs[name],
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": row["shape"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
