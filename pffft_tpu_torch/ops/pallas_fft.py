"""Wrappers of the hand-written CUDA FFT kernels, and their plain versions.

Counterpart of ``pffft_tpu/ops/pallas_fft.py`` (the name is kept so that
each function's counterpart is easy to find).  The Pallas kernels become
CUDA C++ under ``pffft_tpu_torch/csrc/``:

  * ``cfft_chain_tmajor``   -> ``stockham_chain.cu`` (``cfft_pallas_tmajor``),
    on the register-resident core ``regfft.cuh`` with the launch shape of
    :func:`chain_core_tile`
  * ``cfft_combine_tmajor`` -> ``combine.cu`` (``cfft_combine_tmajor``)
  * ``stream_copy``         -> ``stream_copy.cu`` (``stream_copy_pallas``)
  * ``cfft_chain_tmajor_packed`` -> ``chain_packed.cu``
    (``cfft_pallas_tmajor_packed``), on ``regfft.cuh`` with B1's launch
    shape
  * ``rfft_chain_tmajor_fused`` / ``rfft_bwd_chain_tmajor_fused`` ->
    ``real_fused.cu`` (``rfft_pallas_tmajor_fused`` /
    ``rfft_bwd_pallas_tmajor_fused``), on ``regfft.cuh`` with B1's launch
    shape; the backward writes the real [N, B] signal directly
  * ``real_split_tmajor``   -> ``real_split.cu`` (``real_split_tmajor_pallas``)

``cfft_pallas`` is the batch-major convenience: one transpose each way
around ``cfft_chain_tmajor``, or around the time-major route the
dispatcher's batch-major "tmajor" engine gives it.  The batch-major kernels are in
``ops/fused_stage.py`` (B9) and ``ops/real_kernel.py`` (B6); B10, the
in-kernel ksplit (``ksplit2.cu``), is wrapped in ``ops/dispatch.py``
(``cfft_ksplit2_tmajor``), where the reference's is.

Each wrapper takes its plain PyTorch version only for tensors on the CPU;
for a CUDA tensor it launches its kernel or raises.  Each counts its
launches in a plain int attribute, ``<wrapper>.launches``, incremented
where the kernel is launched and nowhere else.

The plain versions repeat the kernels' arithmetic (``_butterfly`` has the
reference's constants and operation order; the real split step is the flat
form of ``ops/split.py``, the counterpart of the reference's
``_fwd_split_block`` / ``_bwd_prep_block`` with the mirror as an index).
On the card they differ from the kernels by a few ulp, because nvcc
contracts a*b+c into FMAs.

The real kernels take the split twiddles as ``real_twiddle = (wr, wi)``,
f32 tensors [H] on the data's device (``split.real_split_twiddle``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import plan as _plan
from ..utils import profiling as _profiling
from . import _build
from . import split as _split

__all__ = [
    "supported",
    "thin_factors",
    "thin_plan",
    "tile_elems",
    "chain_tile",
    "chain_max_n",
    "chain_core_tile",
    "chain_core_occupancy",
    "ChainCoreTile",
    "cfft_chain_tmajor",
    "cfft_pallas",
    "cfft_combine_tmajor",
    "stream_copy",
    "cfft_chain_tmajor_packed",
    "rfft_chain_tmajor_fused",
    "rfft_bwd_chain_tmajor_fused",
    "rfft_fused_occupancy",
    "real_split_tmajor",
    "chain_tmajor_plain",
    "combine_tmajor_plain",
    "stream_copy_plain",
    "chain_tmajor_packed_plain",
    "rfft_chain_tmajor_fused_plain",
    "rfft_bwd_chain_tmajor_fused_plain",
    "real_split_tmajor_plain",
    "CHAIN_RADICES",
    "COMBINE_RADICES",
]

CHAIN_RADICES = (2, 3, 4, 5, 8, 16)
COMBINE_RADICES = (2, 3, 4, 5, 8, 16, 32)

# The chain's coverage (chain_tile): a thread holds at most 32 complex
# values a stage, a block has at most 512 threads.  The kernels on the
# register-resident core (chain_core_tile) keep this rule.
_CHAIN_ELEMS = 32
_CHAIN_MAX_THREADS = 512
# Shared memory a block may use on sm_90 (232,448 bytes = 227 KB), the
# value the CPU plans with; on the card it is read from the device.
_SM90_SMEM_OPTIN = 232448
# Narrowest tile the chain serves well: 8 columns = 32-byte row segments.
# Measured by chip_smoke.py's "split" lines (H100 80GB HBM3, 700 W, 64 MB
# planes): at N=4096 the 4-column tile loses to kern2 on m=2048 (0.392 vs
# 0.316 ms); at N=2048 the 8-column tile beats kern2 on m=1024 (0.213 vs
# 0.330 ms).  With the tile limits below this puts the single-pass /
# kern2 split at N=2048 / 4096.
_CHAIN_MIN_TB = 8
_CHAIN_MAX_TB = 32

_SQRT3_2 = math.sqrt(3.0) / 2.0
_C51, _S51 = math.cos(2 * math.pi / 5), math.sin(2 * math.pi / 5)
_C52, _S52 = math.cos(4 * math.pi / 5), math.sin(4 * math.pi / 5)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _butterfly(r: int, a, sign: float):
    """Radix-r DFT of r planar slabs a[i] = (re, im); returns r slabs.

    sign = -1 forward, +1 backward.  y[t] = sum_i W_r^{sign*i*t} a[i].
    """

    if r == 2:
        (x0r, x0i), (x1r, x1i) = a
        return [(x0r + x1r, x0i + x1i), (x0r - x1r, x0i - x1i)]
    if r == 4:
        (x0r, x0i), (x1r, x1i), (x2r, x2i), (x3r, x3i) = a
        t0r, t0i = x0r + x2r, x0i + x2i
        t1r, t1i = x0r - x2r, x0i - x2i
        t2r, t2i = x1r + x3r, x1i + x3i
        t3r, t3i = x1r - x3r, x1i - x3i
        # forward (sign=-1): y1 = t1 - i t3, y3 = t1 + i t3
        if sign < 0:
            y1 = (t1r + t3i, t1i - t3r)
            y3 = (t1r - t3i, t1i + t3r)
        else:
            y1 = (t1r - t3i, t1i + t3r)
            y3 = (t1r + t3i, t1i - t3r)
        return [(t0r + t2r, t0i + t2i), y1, (t0r - t2r, t0i - t2i), y3]
    if r == 3:
        (x0r, x0i), (x1r, x1i), (x2r, x2i) = a
        sr, si = x1r + x2r, x1i + x2i
        dr, di = x1r - x2r, x1i - x2i
        mr, mi = x0r - 0.5 * sr, x0i - 0.5 * si
        s3 = sign * _SQRT3_2
        return [
            (x0r + sr, x0i + si),
            (mr - s3 * di, mi + s3 * dr),
            (mr + s3 * di, mi - s3 * dr),
        ]
    if r == 5:
        (x0r, x0i), (x1r, x1i), (x2r, x2i), (x3r, x3i), (x4r, x4i) = a
        s1r, s1i = x1r + x4r, x1i + x4i
        d1r, d1i = x1r - x4r, x1i - x4i
        s2r, s2i = x2r + x3r, x2i + x3i
        d2r, d2i = x2r - x3r, x2i - x3i
        out = [(x0r + s1r + s2r, x0i + s1i + s2i), None, None, None, None]
        for t, (ca, cb, sa, sb) in (
            (1, (_C51, _C52, _S51, _S52)),
            (2, (_C52, _C51, _S52, -_S51)),
        ):
            er = x0r + ca * s1r + cb * s2r
            ei = x0i + ca * s1i + cb * s2i
            fr = sign * (sa * d1r + sb * d2r)
            fi = sign * (sa * d1i + sb * d2i)
            out[t] = (er - fi, ei + fr)
            out[5 - t] = (er + fi, ei - fr)
        return out
    if r == 8:
        # i = 2a + b: radix-4 over a per parity b, then a twiddled radix-2
        ev = _butterfly(4, a[0::2], sign)
        od = _butterfly(4, a[1::2], sign)
        out = [None] * 8
        for c in range(4):
            er, ei = ev[c]
            xr, xi = od[c]
            if c:
                ang = 2 * math.pi * c / 8
                wr, wi = math.cos(ang), sign * math.sin(ang)
                xr, xi = xr * wr - xi * wi, xr * wi + xi * wr
            out[c] = (er + xr, ei + xi)
            out[c + 4] = (er - xr, ei - xi)
        return out
    if r in (16, 32):
        # i = 4a + b: radix-q over a per residue b (q = r/4), twiddles
        # W_r^{sign*b*c}, then a radix-4 over b: y[c + q d] = R4_d(W^{bc} A_b[c])
        q = r // 4
        cols = [_butterfly(q, a[b::4], sign) for b in range(4)]
        out = [None] * r
        for c in range(q):
            slabs = []
            for b in range(4):
                xr, xi = cols[b][c]
                if b and c:
                    ang = 2 * math.pi * b * c / r
                    wr, wi = math.cos(ang), sign * math.sin(ang)
                    xr, xi = xr * wr - xi * wi, xr * wi + xi * wr
                slabs.append((xr, xi))
            ys = _butterfly(4, slabs, sign)
            for d in range(4):
                out[c + q * d] = ys[d]
        return out
    raise ValueError(f"unsupported radix {r}")


def _stage_values(ar, ai, l: int, r: int, m: int, twr, twi, sign: float):
    """One Stockham stage on planar values shaped [l, r*m, B]."""

    b = ar.shape[-1]
    a4r = ar.reshape(l, r, m, b)
    a4i = ai.reshape(l, r, m, b)
    slabs = []
    for i in range(r):
        sr_, si_ = a4r[:, i], a4i[:, i]  # [l, m, B]
        if l > 1 and i > 0:  # T[k, 0] == 1
            wr = twr[:, i].reshape(l, 1, 1)
            wi = twi[:, i].reshape(l, 1, 1)
            sr_, si_ = sr_ * wr - si_ * wi, sr_ * wi + si_ * wr
        slabs.append((sr_, si_))
    ys = _butterfly(r, slabs, sign)
    outr = torch.stack([y[0] for y in ys], dim=0)  # [r, l, m, B]
    outi = torch.stack([y[1] for y in ys], dim=0)
    return outr.reshape(r * l, m, b), outi.reshape(r * l, m, b)


@functools.lru_cache(maxsize=1024)
def _stage_twiddle(stage, device: torch.device):
    """A stage's [l, r] table as (re, im) f32 tensors on ``device``."""

    tw = stage.twiddle
    return (
        torch.from_numpy(np.ascontiguousarray(tw.real, np.float32)).to(device),
        torch.from_numpy(np.ascontiguousarray(tw.imag, np.float32)).to(device),
    )


def chain_tmajor_plain(plan: _plan.Plan, re, im, *, backward: bool = False):
    """Plain PyTorch version of the chain kernel: all stages of ``plan``."""

    sign = 1.0 if backward else -1.0
    n, b = re.shape
    ar, ai = re, im
    for st in plan.stages:
        if st.r == 1:
            continue
        twr, twi = _stage_twiddle(st, re.device)
        if backward:
            twi = -twi
        ar, ai = _stage_values(ar, ai, st.l, st.r, st.m, twr, twi, sign)
    return ar.reshape(n, b), ai.reshape(n, b)


def combine_tmajor_plain(last_stage, re, im, *, backward: bool = False):
    """Plain PyTorch version of the combine kernel (kern2 pass B)."""

    sign = 1.0 if backward else -1.0
    m, r = last_stage.l, last_stage.r
    n, b = re.shape
    twr, twi = _stage_twiddle(last_stage, re.device)
    if backward:
        twi = -twi
    ar = re.reshape(m, r, b)
    ai = im.reshape(m, r, b)
    slabs = []
    for c in range(r):
        sr_, si_ = ar[:, c], ai[:, c]  # [m, B]
        if c > 0:  # T[k, 0] == 1
            wr = twr[:, c].reshape(m, 1)
            wi = twi[:, c].reshape(m, 1)
            sr_, si_ = sr_ * wr - si_ * wi, sr_ * wi + si_ * wr
        slabs.append((sr_, si_))
    ys = _butterfly(r, slabs, sign)
    outr = torch.stack([y[0] for y in ys], dim=0)  # [r, m, B]
    outi = torch.stack([y[1] for y in ys], dim=0)
    return outr.reshape(n, b), outi.reshape(n, b)


def stream_copy_plain(re, im):
    """Plain PyTorch version of the copy kernel."""

    return re.clone(), im.clone()


def chain_tmajor_packed_plain(plan: _plan.Plan, y, *, slabs: int = 1):
    """Plain PyTorch version of the packed-input chain kernel: the planes
    sliced out of the packed buffer, then the forward chain."""

    n, w = y.shape
    b = w // (2 * slabs)
    v = y.reshape(n, slabs, 2, b)
    re = v[:, :, 0].reshape(n, slabs * b)
    im = v[:, :, 1].reshape(n, slabs * b)
    return chain_tmajor_plain(plan, re, im)


def real_split_tmajor_plain(zr, zi, real_twiddle, *, backward: bool = False):
    """Plain PyTorch version of the split kernel: REAL_FINALIZE forward,
    REAL_PREPROCESS (2*Z) backward."""

    if backward:
        return _split.real_backward_split_planar_tmajor_flat(zr, zi, real_twiddle)
    return _split.real_forward_split_planar_tmajor_flat(zr, zi, real_twiddle)


def rfft_chain_tmajor_fused_plain(plan: _plan.Plan, y, real_twiddle):
    """Plain PyTorch version of the fused real forward kernel."""

    zr, zi = chain_tmajor_packed_plain(plan, y)
    return _split.real_forward_split_planar_tmajor_flat(zr, zi, real_twiddle)


def rfft_bwd_chain_tmajor_fused_plain(plan: _plan.Plan, sr, si, real_twiddle):
    """Plain PyTorch version of the fused real backward kernel: the
    pre-interleave pair, interleaved into the real [N, B] signal."""

    zr, zi = _split.real_backward_split_planar_tmajor_flat(sr, si, real_twiddle)
    wr, wi = chain_tmajor_plain(plan, zr, zi, backward=True)
    return _split.interleave_to_real_split_tmajor(wr, wi)


# ---------------------------------------------------------------------------
# Coverage
# ---------------------------------------------------------------------------


def supported(plan: _plan.Plan) -> bool:
    """Whether the chain kernel runs this plan's stages."""

    return (
        plan.local_split is None
        and len(plan.stages) > 0
        and all(st.r == 1 or st.r in CHAIN_RADICES for st in plan.stages)
    )


def thin_factors(n: int, radix16: bool = True) -> Optional[Tuple[int, ...]]:
    """A kernel-supported stage chain for engine length ``n``.

    radix16=True prefers fat 16/8 stages (fewest passes over the tile);
    False gives the radix<=5 chain.  None if n is not 2/3/5-smooth."""

    a = 0
    m = n
    while m % 2 == 0:
        m //= 2
        a += 1
    out = []
    if radix16:
        while a >= 4:
            out.append(16)
            a -= 4
        if a == 3:
            out.append(8)
            a = 0
    while a >= 2:
        out.append(4)
        a -= 2
    if a:
        out.append(2)
    while m % 5 == 0:
        out.append(5)
        m //= 5
    while m % 3 == 0:
        out.append(3)
        m //= 3
    if m != 1:
        return None
    return tuple(out)


@functools.lru_cache(maxsize=64)
def thin_plan(n: int) -> Optional[_plan.Plan]:
    """The chain kernels' plan for length n: the radix-16/8-first chain, or
    None when n is not 2/3/5-smooth.

    The ordered spectrum does not depend on the factorization, so a chain
    kernel may run this plan for any caller plan of the same length."""

    factors = thin_factors(n, radix16=True)
    if factors is None:
        return None
    p = _plan.new_setup(n, _plan.COMPLEX, factors=factors, strict=False)
    return p if supported(p) else None


def smem_per_block(device: Optional[torch.device] = None) -> int:
    """Opt-in shared memory per block: read from the card for a CUDA
    device, the sm_90 value (232,448 bytes) otherwise."""

    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return int(props.shared_memory_per_block_optin)
    return _SM90_SMEM_OPTIN


# What the planners of the register-resident core (csrc/regfft.cuh: B9 in
# ops/fused_stage.py, B10 in ops/dispatch.py) count with, on sm_90: threads
# per block at most (the kernels' launch bound, which caps a thread at 128
# registers), and an SM's shared memory, registers and threads.  The 1 KB
# per block is what the runtime reserves for itself.
CORE_MAX_THREADS = 512
_CORE_REGS = 128
_SM_SMEM = 233472
_SM_SMEM_RESERVED = 1024
_SM_REGS = 65536
_SM_THREADS = 2048
_SM_BLOCKS = 32


def core_blocks_per_sm(threads: int, smem: int) -> int:
    """Blocks of a core kernel one SM holds at once, by the planners'
    arithmetic: the least of what shared memory, registers (128 a thread,
    the launch bound's cap) and threads allow.  The card's own occupancy
    calculator, with the registers ptxas gave, may allow more."""

    return min(_SM_SMEM // (smem + _SM_SMEM_RESERVED), _SM_REGS // (threads * _CORE_REGS),
               _SM_THREADS // threads, _SM_BLOCKS)


def core_pad(p: int, shift: int) -> int:
    """Shared-memory slot of element p of a core tile: one float2 of
    padding every 2^shift elements (``pad`` in csrc/regfft.cuh)."""

    return p + (p >> shift)


def tile_elems(radices: Sequence[int] = (2,),
               device: Optional[torch.device] = None) -> int:
    """Complex values one block holds under the chain's coverage rule with
    stage ``radices``: 512 threads x 32 values, rounded down to whole
    butterflies per radix, capped by one float2 buffer in shared memory."""

    per_thread = min(r * (_CHAIN_ELEMS // r) for r in radices)
    return min(_CHAIN_MAX_THREADS * per_thread, smem_per_block(device) // 8)


def chain_tile(n: int, radices: Sequence[int] = (2,),
               device: Optional[torch.device] = None) -> Optional[int]:
    """The chain's coverage rule: batch columns per block for engine length
    ``n`` with stage ``radices`` (a power of two, at most 32), or None when
    no tile [n, tb] of at least 8 columns fits :func:`tile_elems`.  The
    planner of the core kernels (:func:`chain_core_tile`: B1, B3, B4)
    serves the lengths it covers."""

    cap = tile_elems(radices, device)
    tb = _CHAIN_MAX_TB
    while tb >= _CHAIN_MIN_TB:
        if n * tb <= cap:
            return tb
        tb //= 2
    return None


def chain_max_n(device: Optional[torch.device] = None) -> int:
    """The largest power-of-two engine length the chain kernel covers."""

    n = 16
    while chain_tile(2 * n, (16,), device) is not None:
        n *= 2
    return n


class ChainCoreTile(NamedTuple):
    """B1's launch shape on the register-resident core (``chain_core_tile``)."""

    tb: int             # batch columns per block (one lane each)
    threads: int        # threads per block
    elems: int          # values a thread holds per stage (16 or 32)
    shift: int          # tile padding: one row every 2**shift rows
    smem: int           # bytes of shared memory per block
    blocks_per_sm: int  # by the planner's arithmetic (core_blocks_per_sm)


# B1's default launch shape: the widest of these tb that a block holds at 32
# values a thread, the fastest shape of chip_smoke.py's chain_sweep on the
# H100 at N = 1024 and 2048 (wider row segments beat more blocks per SM).
_CORE_ELEMS = 32
_CORE_TBS = (32, 16, 8, 4)
# Padding of the column tile.  A half-warp's 8-byte loads from a tile of tb
# >= 16 columns hit one row, conflict-free unpadded; at tb < 16 the last
# stage (m = 1) reads rows R apart, so one padding row every R rows (R the
# last radix, a power of two) makes the stride odd; odd radices already are.
_NO_PAD_SHIFT = 30
_PAD_SHIFT = {16: 4, 8: 3, 4: 2, 2: 1}


def _chain_core_shape(n: int, radices: Sequence[int], tb: int, elems: int) -> ChainCoreTile:
    """The launch shape of B1 at ``tb`` columns and ``elems`` values a
    thread, whether or not a block can run it (the kernel refuses what it
    cannot)."""

    shift = _PAD_SHIFT.get(radices[-1], _NO_PAD_SHIFT) if tb < 16 else _NO_PAD_SHIFT
    threads = max(32, -(-(n * tb) // (32 * elems)) * 32)
    smem = (core_pad(n - 1, shift) + 1) * tb * 8
    return ChainCoreTile(tb, threads, elems, shift, smem, core_blocks_per_sm(threads, smem))


def chain_core_tile(plan: _plan.Plan, device: Optional[torch.device] = None, *,
                    tb: Optional[int] = None,
                    elems: Optional[int] = None) -> Optional[ChainCoreTile]:
    """B1's launch shape for ``plan``'s thin chain, or None where the chain
    does not cover its length (:func:`chain_tile`: the coverage rule, not
    changed by the core) or no block holds the shape.

    A block holds tb columns of all N rows, a lane each, on threads x elems
    >= N*tb values (at most 512 threads) and one padded [pad(N), tb] float2
    tile.  By default elems = 32 and tb is the widest of 32, 16, 8, 4 that
    fits: N = 2048 gets tb = 8 on 512 threads (147 KB, one block per SM),
    N = 1024 tb = 16; ``tb`` and ``elems`` choose another shape (the
    launch-shape sweep)."""

    dev = None if device is None else torch.device(device)
    return _chain_core_tile(plan.engine_n, dev, tb, elems or _CORE_ELEMS)


@functools.lru_cache(maxsize=256)
def _chain_core_tile(n: int, device: Optional[torch.device], tb: Optional[int],
                     elems: int) -> Optional[ChainCoreTile]:
    """:func:`chain_core_tile` by length, cached: every B1 launch plans."""

    thin = thin_plan(n)
    radices = [st.r for st in thin.stages if st.r != 1] if thin is not None else []
    if not radices or chain_tile(n, radices, device) is None:
        return None
    for t in (tb,) if tb is not None else _CORE_TBS:
        shape = _chain_core_shape(n, radices, t, elems)
        if shape.threads <= CORE_MAX_THREADS and shape.smem <= smem_per_block(device):
            return shape
    return None


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> (source in csrc/, argument types)
_SIGNATURES = {
    "pf_chain_tmajor": ("stockham_chain", [_P] * 6 + [_I] * 9 + [_P]),
    "pf_chain_occupancy": ("stockham_chain", [_I] * 6 + [_P]),
    "pf_combine_tmajor": ("combine", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "pf_stream_copy": ("stream_copy", [_P, _P, _P, _P, ctypes.c_longlong, _I, _P]),
    "pf_chain_tmajor_packed": ("chain_packed", [_P] * 5 + [_I] * 9 + [_P]),
    "pf_rfft_tmajor_fused_fwd": ("real_fused", [_P] * 7 + [_I] * 8 + [_P]),
    "pf_rfft_tmajor_fused_bwd": ("real_fused", [_P] * 7 + [_I] * 8 + [_P]),
    "pf_rfft_fused_occupancy": ("real_fused", [_I] * 7 + [_P]),
    "pf_real_split_tmajor": ("real_split", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # ops/fused_stage.cfft_fused2, ops/real_kernel.real_split
    "pf_fused2": ("fused2", [_P] * 6 + [_I] * 13 + [_P]),
    "pf_real_split_bmajor": ("real_split_bmajor",
                             [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # ops/conv_kernel.zconv_tmajor / zconv_stream, ops/pfb_kernel.pfb_fir / pfb_fir_stream_tmajor
    "pf_conv_fused_tmajor": ("conv_fused", [_P] * 8 + [_I] * 8 + [_P]),
    "pf_conv_stream": ("conv_fused", [_P] * 6 + [_I] * 15 + [_P]),
    "pf_pfb_fir": ("pfb_fir", [_P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong, _I, _P]),
    "pf_pfb_stream": ("pfb_fir", [_P] * 7 + [_I] * 5 + [ctypes.c_longlong] * 3
                      + [_I] * 3 + [_P]),
    # ops/dispatch.cfft_ksplit2_tmajor (and its occupancy)
    "pf_ksplit2_tmajor": ("ksplit2", [_P] * 6 + [_I, _P] + [_I] * 9 + [_P]),
    "pf_ksplit2_occupancy": ("ksplit2", [_I] * 6 + [_P]),
}


@functools.lru_cache(maxsize=None)
def _kernel(fname: str, library: Optional[str] = None):
    """(library, C function) of entry point ``fname``, from its source's
    library or from ``library``, a variant of that source (_build.VARIANTS)."""

    name, argtypes = _SIGNATURES[fname]
    lib = _build.load(library or name)
    fn = getattr(lib, fname)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _planes(re: torch.Tensor, im: torch.Tensor) -> Tuple[int, int]:
    if re.ndim != 2 or re.shape != im.shape:
        raise ValueError(f"planes must be two equal [N, B] tensors; got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if re.device != im.device:
        raise ValueError(f"planes on different devices: {re.device}, {im.device}")
    return int(re.shape[0]), int(re.shape[1])


def _check_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}; expected a CUDA tensor")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous float32 tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=256)
def _chain_tables(stages: tuple, device: torch.device):
    """(concatenated [l, r] tables as (re, im) pairs on ``device``,
    ctypes stage descriptor rows (r, l, m, offset), stage count).  The
    combine kernel takes the one-stage form's table."""

    active = [st for st in stages if st.r != 1]
    desc = []
    off = 0
    for st in active:
        desc += [st.r, st.l, st.m, off]
        off += st.l * st.r
    tw = np.concatenate([st.twiddle.astype(np.complex64).ravel() for st in active])
    tw_t = torch.from_numpy(tw.view(np.float32).copy()).to(device)
    return tw_t, (ctypes.c_int * len(desc))(*desc), len(active)


@functools.lru_cache(maxsize=256)
def _core_tables(stages: tuple, device: torch.device):
    """The tables of the register-resident core (csrc/regfft.cuh): each
    stage's [l, r] table transposed to [r, l] (entry i*l + k is T[k, i]),
    concatenated as (re, im) pairs on ``device``; the ctypes descriptor
    rows (r, l, m, offset); the stage count.  The values are those of
    :func:`_chain_tables`."""

    active = [st for st in stages if st.r != 1]
    desc = []
    off = 0
    for st in active:
        desc += [st.r, st.l, st.m, off]
        off += st.l * st.r
    tw = np.concatenate([st.twiddle.T.astype(np.complex64).ravel() for st in active])
    tw_t = torch.from_numpy(tw.view(np.float32).copy()).to(device)
    return tw_t, (ctypes.c_int * len(desc))(*desc), len(active)


def _chain_plan_fits(plan: _plan.Plan, n: int) -> None:
    if not supported(plan):
        raise ValueError(f"plan {plan} has factors the chain kernel does not run")
    if n != plan.engine_n:
        raise ValueError(f"data length {n} != plan engine length {plan.engine_n}")


def _check_real_twiddle(real_twiddle, h: int, device: torch.device) -> None:
    wr, wi = real_twiddle
    if wr.shape != (h,) or wi.shape != (h,):
        raise ValueError(f"split twiddles must be two [{h}] tensors; got "
                         f"{tuple(wr.shape)} and {tuple(wi.shape)}")
    if wr.device != device or wi.device != device:
        raise ValueError(f"split twiddles on {wr.device}, {wi.device}; data on {device}")


def _core_launch(plan: _plan.Plan, device: torch.device, what: str, tb: Optional[int],
                 elems: Optional[int]) -> ChainCoreTile:
    """The column launch shape of B1 (and of B3, B4 and B7's column map): the
    planner's at the caller's ``tb`` / ``elems``, or that shape even where
    no block holds it or the chain does not cover the plan (the kernel then
    refuses what it cannot run, and the wrapper raises).  ValueError where
    the planner has no shape and no ``tb`` is given."""

    n = plan.engine_n
    t = chain_core_tile(plan, device, tb=tb, elems=elems)
    if t is not None:
        return t
    if tb is None:
        raise ValueError(f"N={n} exceeds the {what}'s tile limits")
    radices = [st.r for st in thin_plan(n).stages if st.r != 1]
    return _chain_core_shape(n, radices, tb, elems or _CORE_ELEMS)


def chain_core_occupancy(n: int, tile: ChainCoreTile, device: torch.device) -> int:
    """Blocks of B1 one SM holds at ``tile`` for length n, from the card's
    occupancy calculator (registers as ptxas gave them)."""

    lib, fn = _kernel("pf_chain_occupancy")
    out = ctypes.c_int()
    err = fn(n, tile.tb, tile.threads, tile.elems, tile.shift, device.index or 0,
             ctypes.byref(out))
    _build.check(lib, err, f"chain kernel occupancy (N={n}, tb={tile.tb})")
    return out.value


def cfft_chain_tmajor(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                      backward: bool = False, tb: Optional[int] = None,
                      elems: Optional[int] = None):
    """Batched complex FFT of time-major planes [N, B] in one pass (B1).

    Unscaled both directions; canonical bin order.  Any B.  The kernel runs
    the thin chain of length N (the ordered spectrum does not depend on the
    factorization); the plain version runs ``plan``'s stages.  ``tb`` and
    ``elems`` override the launch shape of :func:`chain_core_tile`
    (measurement only).  The inputs are not modified.
    """

    n, b = _planes(re, im)
    _chain_plan_fits(plan, n)
    if re.device.type == "cpu":
        return chain_tmajor_plain(plan, re, im, backward=backward)
    _check_cuda(re, im)
    t = _core_launch(plan, re.device, "chain kernel", tb, elems)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return ore, oim
    with _profiling.span("launch", "cfft_chain_tmajor"):
        lib, fn = _kernel("pf_chain_tmajor")
        tw, desc, count = _core_tables(thin_plan(n).stages, re.device)
        err = fn(re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
                 tw.data_ptr(), desc, count, n, b, t.tb, t.threads, t.elems, t.shift,
                 int(backward), re.device.index or 0, _stream(re))
        _build.check(lib, err, f"chain kernel (N={n}, B={b}, tb={t.tb}, threads={t.threads}, "
                               f"elems={t.elems})")
    cfft_chain_tmajor.launches += 1
    return ore, oim


cfft_chain_tmajor.launches = 0


def cfft_pallas(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                backward: bool = False, tb: Optional[int] = None,
                tmajor: Optional[Callable] = None):
    """Batch-major convenience: [B, N] planes, one transpose each way
    around :func:`cfft_chain_tmajor`, or around ``tmajor(re, im)`` on the
    time-major [N, B] planes where given (the dispatcher's time-major
    route).  Returns contiguous [B, N] planes."""

    if tmajor is None:
        tmajor = lambda r, i: cfft_chain_tmajor(plan, r, i, backward=backward, tb=tb)
    rr, ri = tmajor(re.T.contiguous(), im.T.contiguous())
    return rr.T.contiguous(), ri.T.contiguous()


def cfft_combine_tmajor(last_stage, re: torch.Tensor, im: torch.Tensor, *,
                        backward: bool = False):
    """Twiddled radix-r combine of the kern2 state (pass B).

    ``last_stage``: the l=m, radix-r, m'=1 StageTables of the full plan
    (dispatch._build_ksplit); planes are [N, B] holding pass A's [m, r, B]
    state row-major.  Returns the canonical ordered spectrum [N, B]."""

    m, r = last_stage.l, last_stage.r
    n, b = _planes(re, im)
    if n != m * r:
        raise ValueError(f"data length {n} != combine {m}*{r}")
    if r not in COMBINE_RADICES:
        raise ValueError(f"combine radix {r} not in {COMBINE_RADICES}")
    if re.device.type == "cpu":
        return combine_tmajor_plain(last_stage, re, im, backward=backward)
    _check_cuda(re, im)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return ore, oim
    with _profiling.span("launch", "cfft_combine_tmajor"):
        lib, fn = _kernel("pf_combine_tmajor")
        tw = _chain_tables((last_stage,), re.device)[0]
        err = fn(re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
                 tw.data_ptr(), m, r, b, int(backward), re.device.index or 0,
                 _stream(re))
        _build.check(lib, err, f"combine kernel (m={m}, r={r}, B={b})")
    cfft_combine_tmajor.launches += 1
    return ore, oim


cfft_combine_tmajor.launches = 0


def stream_copy(re: torch.Tensor, im: torch.Tensor):
    """Copy of two f32 planes (the per-pass bandwidth probe)."""

    _planes(re, im)
    if re.device.type == "cpu":
        return stream_copy_plain(re, im)
    _check_cuda(re, im)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if re.numel() == 0:
        return ore, oim
    with _profiling.span("launch", "stream_copy"):
        lib, fn = _kernel("pf_stream_copy")
        err = fn(re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
                 re.numel(), re.device.index or 0, _stream(re))
        _build.check(lib, err, f"copy kernel ({re.numel()} elements)")
    stream_copy.launches += 1
    return ore, oim


stream_copy.launches = 0


def cfft_chain_tmajor_packed(plan: _plan.Plan, y: torch.Tensor, *, slabs: int = 1,
                             tb: Optional[int] = None, elems: Optional[int] = None):
    """Forward complex FFT of a PACKED time-major buffer -> planar pair (B4).

    ``slabs=1``: y [N, 2B] with columns :B re and B: im, the free
    ``x.reshape(H, 2B)`` of a real [2H, B] signal -> ([N, B]) x2.
    ``slabs=r``: y [N, r*2B], kern2 pass A's wide view of the same buffer
    (slab s holds re at columns s*2B.., im at s*2B+B..) -> the planar
    pass-A state ([N, r*B]) x2.  Unscaled, canonical order.  The pack costs
    no pass of its own.  As :func:`cfft_chain_tmajor`, the kernel runs the
    thin chain of length N at the launch shape of :func:`chain_core_tile`
    (``tb`` and ``elems`` override it, for measurement only)."""

    if y.ndim != 2 or slabs < 1 or y.shape[1] % (2 * slabs):
        raise ValueError(f"packed buffer must be [N, {slabs}*2B]; got {tuple(y.shape)}")
    n, b = int(y.shape[0]), int(y.shape[1]) // (2 * slabs)
    _chain_plan_fits(plan, n)
    if y.device.type == "cpu":
        return chain_tmajor_packed_plain(plan, y, slabs=slabs)
    _check_cuda(y)
    t = _core_launch(plan, y.device, "packed chain kernel", tb, elems)
    ore = torch.empty((n, slabs * b), dtype=y.dtype, device=y.device)
    oim = torch.empty_like(ore)
    if b == 0:
        return ore, oim
    with _profiling.span("launch", "cfft_chain_tmajor_packed"):
        lib, fn = _kernel("pf_chain_tmajor_packed")
        tw, desc, count = _core_tables(thin_plan(n).stages, y.device)
        err = fn(y.data_ptr(), ore.data_ptr(), oim.data_ptr(), tw.data_ptr(), desc, count,
                 n, b, slabs, t.tb, t.threads, t.elems, t.shift, y.device.index or 0, _stream(y))
        _build.check(lib, err, f"packed chain kernel (N={n}, B={b}, slabs={slabs}, tb={t.tb}, "
                               f"threads={t.threads}, elems={t.elems})")
    cfft_chain_tmajor_packed.launches += 1
    return ore, oim


cfft_chain_tmajor_packed.launches = 0


def rfft_chain_tmajor_fused(plan: _plan.Plan, y: torch.Tensor, real_twiddle, *,
                            tb: Optional[int] = None, elems: Optional[int] = None):
    """ONE-pass real forward (B3): packed [H, 2B] buffer (the free
    ``x.reshape(H, 2B)`` of a real [N, B] signal) -> the packed real
    spectrum planes ([H, B]) x2, bin0 = DC + i*Nyquist.

    ``plan`` is the length-H chain plan; the kernel runs the thin chain of
    length H at the launch shape of :func:`chain_core_tile` (``tb`` and
    ``elems`` override it, for measurement only)."""

    if y.ndim != 2 or y.shape[1] % 2:
        raise ValueError(f"packed real input must be [H, 2B]; got {tuple(y.shape)}")
    h, b = int(y.shape[0]), int(y.shape[1]) // 2
    _chain_plan_fits(plan, h)
    _check_real_twiddle(real_twiddle, h, y.device)
    if y.device.type == "cpu":
        return rfft_chain_tmajor_fused_plain(plan, y, real_twiddle)
    wr, wi = real_twiddle
    _check_cuda(y, wr, wi)
    t = _core_launch(plan, y.device, "fused real forward kernel", tb, elems)
    ore = torch.empty((h, b), dtype=y.dtype, device=y.device)
    oim = torch.empty_like(ore)
    if b == 0:
        return ore, oim
    with _profiling.span("launch", "rfft_chain_tmajor_fused"):
        lib, fn = _kernel("pf_rfft_tmajor_fused_fwd")
        tw, desc, count = _core_tables(thin_plan(h).stages, y.device)
        err = fn(y.data_ptr(), ore.data_ptr(), oim.data_ptr(), tw.data_ptr(), wr.data_ptr(),
                 wi.data_ptr(), desc, count, h, b, t.tb, t.threads, t.elems, t.shift,
                 y.device.index or 0, _stream(y))
        _build.check(lib, err, f"fused real forward kernel (H={h}, B={b}, tb={t.tb}, "
                               f"threads={t.threads}, elems={t.elems})")
    rfft_chain_tmajor_fused.launches += 1
    return ore, oim


rfft_chain_tmajor_fused.launches = 0


def rfft_bwd_chain_tmajor_fused(plan: _plan.Plan, sr: torch.Tensor, si: torch.Tensor,
                                real_twiddle, *, tb: Optional[int] = None,
                                elems: Optional[int] = None):
    """ONE-pass real backward (B3): packed spectrum planes [H, B] x2 ->
    the real [N, B] signal (REAL_PREPROCESS, then the backward length-H
    chain, whose pre-interleave pair the kernel writes as the two halves of
    one [H, 2B] buffer, so no interleave copy follows).  Unscaled: with the
    forward it gives 2H = N times the signal.  Launch shape as
    :func:`rfft_chain_tmajor_fused`."""

    h, b = _planes(sr, si)
    _chain_plan_fits(plan, h)
    _check_real_twiddle(real_twiddle, h, sr.device)
    if sr.device.type == "cpu":
        return rfft_bwd_chain_tmajor_fused_plain(plan, sr, si, real_twiddle)
    wr, wi = real_twiddle
    _check_cuda(sr, si, wr, wi)
    t = _core_launch(plan, sr.device, "fused real backward kernel", tb, elems)
    out = torch.empty((2 * h, b), dtype=sr.dtype, device=sr.device)
    if b == 0:
        return out
    with _profiling.span("launch", "rfft_bwd_chain_tmajor_fused"):
        lib, fn = _kernel("pf_rfft_tmajor_fused_bwd")
        tw, desc, count = _core_tables(thin_plan(h).stages, sr.device)
        err = fn(sr.data_ptr(), si.data_ptr(), out.data_ptr(), tw.data_ptr(), wr.data_ptr(),
                 wi.data_ptr(), desc, count, h, b, t.tb, t.threads, t.elems, t.shift,
                 sr.device.index or 0, _stream(sr))
        _build.check(lib, err, f"fused real backward kernel (H={h}, B={b}, tb={t.tb}, "
                               f"threads={t.threads}, elems={t.elems})")
    rfft_bwd_chain_tmajor_fused.launches += 1
    return out


rfft_bwd_chain_tmajor_fused.launches = 0


def rfft_fused_occupancy(h: int, tile: ChainCoreTile, device: torch.device, *,
                         backward: bool = False) -> int:
    """Blocks of B3 (forward, or ``backward``) one SM holds at ``tile`` for
    length H, from the card's occupancy calculator (registers as ptxas
    gave them)."""

    lib, fn = _kernel("pf_rfft_fused_occupancy")
    out = ctypes.c_int()
    err = fn(h, tile.tb, tile.threads, tile.elems, tile.shift, int(backward),
             device.index or 0, ctypes.byref(out))
    _build.check(lib, err, f"fused real kernel occupancy (H={h}, tb={tile.tb})")
    return out.value


def real_split_tmajor(zr: torch.Tensor, zi: torch.Tensor, real_twiddle, *,
                      backward: bool = False):
    """ONE-pass real split step on time-major planes [H, B], any H.

    Forward: REAL_FINALIZE, the length-H transform -> the packed real
    spectrum.  Backward: REAL_PREPROCESS, the packed spectrum -> 2*Z, the
    input of the backward length-H transform."""

    h, b = _planes(zr, zi)
    _check_real_twiddle(real_twiddle, h, zr.device)
    if zr.device.type == "cpu":
        return real_split_tmajor_plain(zr, zi, real_twiddle, backward=backward)
    wr, wi = real_twiddle
    _check_cuda(zr, zi, wr, wi)
    ore, oim = torch.empty_like(zr), torch.empty_like(zi)
    if b == 0 or h == 0:
        return ore, oim
    with _profiling.span("launch", "real_split_tmajor"):
        lib, fn = _kernel("pf_real_split_tmajor")
        err = fn(zr.data_ptr(), zi.data_ptr(), ore.data_ptr(), oim.data_ptr(), wr.data_ptr(),
                 wi.data_ptr(), h, b, int(backward), zr.device.index or 0, _stream(zr))
        _build.check(lib, err, f"real split kernel (H={h}, B={b}, backward={backward})")
    real_split_tmajor.launches += 1
    return ore, oim


real_split_tmajor.launches = 0
