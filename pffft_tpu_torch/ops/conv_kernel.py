"""The fused spectral-convolution kernel: forward FFT, multiply by the filter
spectrum, backward FFT, in one pass over device memory.

Counterpart of ``pffft_tpu/ops/conv_kernel.py``.  The Pallas kernel becomes
``csrc/conv_fused.cu`` (B7), on the register-resident core
(``csrc/regfft.cuh``): the forward chain leaves each lane's canonical-order
spectrum in shared memory, the backward chain reads it back multiplied by
Hf and stores through one of two maps.  The 1/N scale of the inverse is
folded into Hf on the host (:func:`filter_spectrum`), so neither chain
scales.

  * :func:`zconv_tmajor`, the column map: time-major planes [N, B], one
    overlap-save block per column, the reference's layout, at the launch
    shape of :func:`column_tile`;
  * :func:`zconv_stream`, the stream map: FastConv's streams [R, L] framed
    at stride u inside the kernel, the first u outputs of each frame stored
    straight into [R, total], for frames up to 16384 (:func:`stream_tile`),
    on the plan of :func:`stream_plan` (three register stages at 8192);
    rows that are a slice of wider rows are read where they lie
    (:func:`stream_rows`);
    it replaces the framing and unpacking copies around the column map
    (:func:`stream_conv` composes those, and is the stream map's plain
    version with the column map's plain version inside).

For a REAL filter Hf is Hermitian, so a lane holding two real frames
(re = a, im = b) comes back as (h*a) + i(h*b): two real convolutions per
complex lane.  A complex filter's lane holds one complex frame.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  ``zconv_tmajor.launches`` and
``zconv_stream.launches`` count the launches; the always-on counter
``kernels.stream_map.r32_launches`` counts the stream map's launches whose
plan holds a radix-32 stage.

Both maps are differentiable with respect to the signal (Function 3,
:class:`_ZconvTmajor` and :class:`_ZconvStream`), not the filter: the
backward is the same kernel, with the conjugate spectrum for the column
map and the reversed taps' spectrum for the stream map.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import plan as _plan
from ..utils import profiling as _profiling
from . import _build
from . import _grad
from . import fused_stage as _fs
from . import pallas_fft as _pk

__all__ = ["filter_spectrum", "zconv_tmajor", "zconv_tmajor_plain", "zconv_stream",
           "zconv_stream_plain", "stream_conv", "column_tile", "stream_plan", "stream_tile",
           "stream_rows", "frames", "columns", "keep", "unpack_pairs", "R32_LAUNCHES"]

# Values a thread holds per stage in both maps.  The two chains of one
# kernel ran faster at 16 than at B1's 32 (chip_smoke.py's conv_sweep line).
_CONV_ELEMS = 16


def filter_spectrum(plan: _plan.Plan, h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(hfr, hfi): spectrum of filter ``h`` zero-padded to N, canonical
    order, pre-scaled by 1/N so the kernel's inverse needs no rescale.
    numpy arrays of the plan's dtype; for f32 equal to the reference's bit
    for bit."""

    n = plan.n
    hp = np.zeros(n, np.complex128)
    hp[: len(h)] = np.asarray(h, np.complex128)
    hf = np.fft.fft(hp) / n
    return hf.real.astype(plan.dtype), hf.imag.astype(plan.dtype)


def zconv_tmajor_plain(plan: _plan.Plan, re, im, hfr, hfi):
    """Plain PyTorch version of the kernel: the forward chain, the
    pointwise multiply, the backward chain."""

    sr, si = _pk.chain_tmajor_plain(plan, re, im)
    hr, hi = hfr[:, None], hfi[:, None]
    return _pk.chain_tmajor_plain(plan, sr * hr - si * hi, sr * hi + si * hr,
                                  backward=True)


def _check_spectrum(n: int, device: torch.device, hfr, hfi) -> None:
    for h in (hfr, hfi):
        if h.shape != (n,) or h.device != device:
            raise ValueError(f"filter spectrum must be two [{n}] tensors on {device}; "
                             f"got {tuple(h.shape)} on {h.device}")


def column_tile(plan: _plan.Plan,
                device: Optional[torch.device] = None) -> Optional[_pk.ChainCoreTile]:
    """The column map's launch shape: B1's planner at 16 values a thread
    (N = 2048: tb = 4 on 512 threads), None where the chain does not cover
    the plan."""

    return _pk.chain_core_tile(plan, device, elems=_CONV_ELEMS)


def zconv_tmajor(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor,
                 hfr: torch.Tensor, hfi: torch.Tensor, *, tb: Optional[int] = None,
                 elems: Optional[int] = None):
    """Fused block convolution of time-major planes [N, B]: IFFT(FFT(x)·Hf)
    per column, with Hf = (hfr, hfi) [N] from :func:`filter_spectrum`
    (canonical order, 1/N folded in) on the planes' device.  Each column is
    one overlap-save block; the caller owns framing and the valid-sample
    slice.  The launch shape is :func:`column_tile`'s; ``tb`` and ``elems``
    override it (measurement only).  The inputs are not modified."""

    if _grad.needed(re, im):
        return _ZconvTmajor.apply(re, im, plan, hfr, hfi, tb, elems)
    return _zconv_tmajor(plan, re, im, hfr, hfi, tb, elems)


def _zconv_tmajor(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, hfr: torch.Tensor,
                  hfi: torch.Tensor, tb: Optional[int], elems: Optional[int]):
    n, b = _pk._planes(re, im)
    _pk._chain_plan_fits(plan, n)
    _check_spectrum(n, re.device, hfr, hfi)
    if re.device.type == "cpu":
        return zconv_tmajor_plain(plan, re, im, hfr, hfi)
    _pk._check_cuda(re, im, hfr, hfi)
    t = _pk._core_launch(plan, re.device, "fused conv kernel", tb, elems or _CONV_ELEMS)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return ore, oim
    with _profiling.span("launch", "zconv_tmajor"):
        lib, fn = _pk._kernel("pf_conv_fused_tmajor")
        tw, desc, count = _pk._core_tables(_pk.thin_plan(n).stages, re.device)
        err = fn(re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(), hfr.data_ptr(),
                 hfi.data_ptr(), tw.data_ptr(), desc, count, n, b, t.tb, t.threads, t.elems,
                 t.shift, re.device.index or 0, _pk._stream(re))
        _build.check(lib, err, f"fused conv kernel (N={n}, B={b}, tb={t.tb}, "
                               f"threads={t.threads}, elems={t.elems})")
    zconv_tmajor.launches += 1
    return ore, oim


zconv_tmajor.launches = 0


class _ZconvTmajor(torch.autograd.Function):
    """Function 3, the column map: a circular convolution per column, a
    complex-linear map of the planes, whose adjoint is the same kernel
    with the conjugate spectrum (hfr, -hfi)."""

    @staticmethod
    def forward(re, im, plan, hfr, hfi, tb, elems):
        return _zconv_tmajor(plan, re, im, hfr, hfi, tb, elems)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, ctx.plan, hfr, hfi, ctx.tb, ctx.elems = inputs
        ctx.save_for_backward(hfr, hfi)

    @staticmethod
    def backward(ctx, gr, gi):
        hfr, hfi = ctx.saved_tensors
        xr, xi = zconv_tmajor(ctx.plan, gr.contiguous(), gi.contiguous(), hfr, -hfi,
                              tb=ctx.tb, elems=ctx.elems)
        return xr, xi, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, re, im, plan, hfr, hfi, tb, elems):
        # the mapped dimension joins the columns: planes [N, V, B] run as
        # [N, V*B] in one call
        _unmapped_filter(in_dims[3:5])
        re, im = (_grad.batched(t, d, info.batch_size, 1) for t, d in zip((re, im), in_dims))
        n, v, b = re.shape
        out = zconv_tmajor(plan, re.reshape(n, v * b), im.reshape(n, v * b), hfr, hfi,
                           tb=tb, elems=elems)
        return tuple(t.view(n, v, b) for t in out), (1, 1)


def _unmapped_filter(dims) -> None:
    """A vmap rule's check that the filter spectra are shared by every
    mapped call (no public path maps them)."""

    if any(d is not None for d in dims):
        raise ValueError("vmap over the filter spectrum is not supported: map the signal")


# ---------------------------------------------------------------------------
# The stream map: FastConv's framing, block convolution and valid-sample
# slice in one call
# ---------------------------------------------------------------------------


def frames(x: torch.Tensor, nfft: int, u: int, nb: int) -> torch.Tensor:
    """Streams [R, L] -> the view [R, nb, nfft] of their frames at stride
    u, zero-padded past the end (the reference's tail memset)."""

    need = (nb - 1) * u + nfft
    if x.shape[-1] < need:
        x = _profiling.copy("frames", F.pad, x, (0, need - x.shape[-1]))
    return x[:, :need].unfold(-1, nfft, u)


def columns(fr: torch.Tensor, fi: torch.Tensor):
    """Frame views [R, c, nfft] x2 -> time-major planes [nfft, C] x2,
    column r*c + j from frame (r, j); C is R*c rounded up to a multiple of
    4, the extra columns zero."""

    r, c, nfft = fr.shape
    pad = -(r * c) % 4
    planes = []
    for f in (fr, fi):
        # one pass: each row's frames [nfft, c] read in place, then the zeros
        parts = list(f.permute(2, 0, 1).unbind(1))
        if pad:
            parts.append(f.new_zeros((nfft, pad)))
        planes.append(_profiling.copy("columns", torch.cat, parts, dim=1))
    return planes


def keep(y: torch.Tensor, u: int, r: int, c: int) -> torch.Tensor:
    """The valid samples (the first u) of each column of y [nfft, C]:
    [r, c, u]."""

    return y[:u, : r * c].view(u, r, c).permute(1, 2, 0)


def unpack_pairs(yr: torch.Tensor, yi: torch.Tensor, u: int, r: int, h: int):
    """Block outputs of R*h column pairs -> the valid samples [R, 2h, u] of
    the frames (even frames from re, odd from im)."""

    out = _profiling.copy("unpack_pairs", torch.stack, (keep(yr, u, r, h), keep(yi, u, r, h)),
                          dim=2)  # [R, h, 2, u]
    return out.view(r, 2 * h, -1)


def stream_conv(block_conv: Callable, x: torch.Tensor, nfft: int, u: int, total: int):
    """The stream map composed of copies around ``block_conv(re, im)`` (a
    block convolution of time-major planes [nfft, C]): frames at stride u,
    columns, the block convolution, the first u samples of each frame,
    the first ``total`` positions of each row.

    Real x [R, L]: two frames per column (real filter) -> [R, total].
    Complex x [R, L]: one frame per column -> complex [R, total]."""

    r = x.shape[0]
    nb = -(-total // u)
    if not x.is_complex():
        nb += nb & 1  # whole column pairs; the extra frame is cut below
        v = frames(x, nfft, u, nb)
        yr, yi = block_conv(*columns(v[:, 0::2], v[:, 1::2]))
        return unpack_pairs(yr, yi, u, r, nb // 2).reshape(r, -1)[:, :total]
    yr, yi = block_conv(*columns(frames(x.real, nfft, u, nb), frames(x.imag, nfft, u, nb)))
    yr, yi = (_profiling.contiguous(keep(y, u, r, nb), "keep").view(r, -1)[:, :total]
              for y in (yr, yi))
    return _profiling.copy("complex", torch.complex, yr, yi)


def zconv_stream_plain(plan: _plan.Plan, x, hfr, hfi, u: int, total: int):
    """Plain PyTorch version of the stream map: :func:`stream_conv` around
    :func:`zconv_tmajor_plain`, whose copies stand for the kernel's own
    work, not the entry's layout copies."""

    with _profiling.uncounted():
        return stream_conv(lambda re, im: zconv_tmajor_plain(plan, re, im, hfr, hfi), x,
                           plan.engine_n, u, total)


# Where the stream map's plan opens with radix-32 stages: n -> factors, one
# register stage fewer than thin_plan(n) (a stage past the first is a
# shared-memory exchange in each chain).  The kernel runs these plans in an
# instance of their own (conv_fused.cu's kR32Elems values a thread).  At
# 8192 the stream map took 0.99 ms against 1.40 on 16*16*16*2; 32*32*16 at
# 16384 took 2.07 against 1.34 (32 values a thread: it spills), so 16384
# keeps the thin plan (tools/b7_probe.py, H100).
_STREAM_R32 = {8192: (32, 16, 16)}
# The stream map's radices: the chain's and radix 32.
_STREAM_RADICES = frozenset(_pk.CHAIN_RADICES) | {32}
# The always-on counter of the stream map's launches on a radix-32 plan.
R32_LAUNCHES = "kernels.stream_map.r32_launches"


@functools.lru_cache(maxsize=64)
def stream_plan(n: int) -> Optional[_plan.Plan]:
    """The stream map's plan for frames of length n: a radix-32 stage
    first where that saves a register stage (:data:`_STREAM_R32`: 8192 =
    32*16*16), else ``pallas_fft.thin_plan(n)`` exactly.  None where n is
    not 2/3/5-smooth."""

    factors = _STREAM_R32.get(n)
    if factors is None:
        return _pk.thin_plan(n)
    return _plan.new_setup(n, _plan.COMPLEX, factors=factors, strict=False)


def _stream_plan_fits(plan: _plan.Plan, n: int) -> None:
    """The stream map's check of a caller's plan: the chain's radices, or
    radix 32 (:func:`stream_plan`); its plain version runs that plan."""

    if (plan.local_split is not None or not plan.stages
            or any(st.r != 1 and st.r not in _STREAM_RADICES for st in plan.stages)):
        raise ValueError(f"plan {plan} has factors the stream conv kernel does not run")
    if n != plan.engine_n:
        raise ValueError(f"data length {n} != plan engine length {plan.engine_n}")


# Where the stream map's one-row block differs from B9's: n -> (threads,
# values a thread).  At n = 8192 on 32*16*16, 512 x 16 (one block an SM)
# ran 1.56x as fast as B9's 256 x 32, whose radix-32 instance spills at the
# launch bound's 128 registers (tools/b7_probe.py, H100); at 4096 and 16384
# B9's shape was the fastest the core takes.
_STREAM_ROW = {8192: (512, 16)}


def stream_tile(n: int, device: Optional[torch.device] = None) -> Optional[_fs.Fused2Tile]:
    """The stream map's launch shape for frames of length n: B9's rows
    (``fused_stage.fused2_tile``), one frame (or frame pair) per row, with
    :data:`_STREAM_ROW`'s threads and values a thread; None past B9's
    longest row."""

    t = _fs.fused2_tile(n, device)
    shape = _STREAM_ROW.get(n)
    if t is None or shape is None:
        return t
    threads, elems = shape
    return t._replace(threads=threads, elems=elems,
                      blocks_per_sm=_pk.core_blocks_per_sm(threads, t.smem))


_INT_MAX = 0x7FFFFFFF  # the kernel's row stride is a C int


def stream_rows(x: torch.Tensor) -> Optional[torch.Tensor]:
    """x [..., L] as the rows [R, L] the stream map reads where they lie:
    unit inner stride, rows at least L samples apart (a slice of wider rows
    keeps its row stride), the leading dims collapsed without a copy; None
    where only a copy gives such rows."""

    if x.ndim != 2:
        try:
            x = x.view(-1, x.shape[-1])
        except RuntimeError:
            return None
    rows, length = x.shape
    if length > 1 and x.stride(1) != 1:
        return None
    if rows > 1 and not length <= x.stride(0) <= _INT_MAX:
        return None
    return x


def zconv_stream(plan: _plan.Plan, x: torch.Tensor, hfr: torch.Tensor, hfi: torch.Tensor,
                 u: int, total: int, adjoint: Optional[Tuple[torch.Tensor, torch.Tensor,
                                                              int]] = None):
    """Overlap-save block convolution of streams x [R, L] in one launch:
    frame j of a row is x[j*u : j*u + N] (zero past L), convolved with Hf =
    (hfr, hfi) [N] (:func:`filter_spectrum`), and its first u outputs land
    at positions j*u .. j*u + u - 1 of the output row [R, total].

    Real float32 x: a real filter, two frames per lane, real output.
    complex64 x: one frame per lane, complex64 output.  On the card x's
    rows are read where they lie (:func:`stream_rows`: unit inner stride,
    rows at least L apart); the memory between one row's end and the next
    row is never read.  The inputs are not modified.

    A gradient with respect to x (:class:`_ZconvStream`) needs ``adjoint``
    = (hfr', hfi', span): the spectrum of the filter's taps reversed (and
    conjugated), and the filter's span F, the taps a[d], d < F, of the
    valid correlation y[m] = sum_d a[d] x[m + d] the map computes."""

    if _grad.needed(x):
        if adjoint is None:
            raise ValueError("a gradient through the stream map needs adjoint=(hfr, hfi, "
                             "span) of the reversed taps (FastConv passes it)")
        return _ZconvStream.apply(x, plan, hfr, hfi, u, total, *adjoint)
    return _zconv_stream(plan, x, hfr, hfi, u, total)


def _zconv_stream(plan: _plan.Plan, x: torch.Tensor, hfr: torch.Tensor, hfi: torch.Tensor,
                  u: int, total: int):
    n = plan.engine_n
    _stream_plan_fits(plan, n)
    if x.ndim != 2:
        raise ValueError(f"streams must be [R, L]; got {tuple(x.shape)}")
    if not 0 < u <= n or total < 0:
        raise ValueError(f"hop u={u} must be in [1, {n}] and total={total} >= 0")
    _check_spectrum(n, x.device, hfr, hfi)
    if x.device.type == "cpu":
        return zconv_stream_plain(plan, x, hfr, hfi, u, total)
    pairs = not x.is_complex()
    if x.dtype not in (torch.float32, torch.complex64) or stream_rows(x) is None:
        raise ValueError("streams must be float32 or complex64 rows with unit inner stride, "
                         "at least L samples apart")
    _pk._check_cuda(hfr, hfi)
    t = stream_tile(n, x.device)
    if t is None:
        raise ValueError(f"N={n} exceeds the stream conv kernel's rows")
    rows, length = int(x.shape[0]), int(x.shape[1])
    ld = int(x.stride(0)) if rows > 1 else length  # in samples: complex strides count pairs
    y = torch.empty((rows, total), dtype=x.dtype, device=x.device)
    if rows == 0 or total == 0:
        return y
    with _profiling.span("launch", "zconv_stream"):
        nb = -(-total // u)
        lanes = -(-nb // 2) if pairs else nb
        xv = x if pairs else torch.view_as_real(x)
        yv = y if pairs else torch.view_as_real(y)
        lib, fn = _pk._kernel("pf_conv_stream")
        splan = stream_plan(n)
        tw, desc, count = _pk._core_tables(splan.stages, x.device)
        err = fn(xv.data_ptr(), yv.data_ptr(), hfr.data_ptr(), hfi.data_ptr(), tw.data_ptr(),
                 desc, count, n, rows, length, ld, total, u, lanes, int(pairs), t.rows,
                 t.threads, t.elems, t.pitch, t.shift, x.device.index or 0, _pk._stream(x))
        _build.check(lib, err, f"stream conv kernel (N={n}, R={rows}, L={length}, ld={ld}, "
                               f"u={u}, total={total})")
    zconv_stream.launches += 1
    if splan.factors[0] == 32:
        _profiling.count(R32_LAUNCHES)
    if ld != length:
        _profiling.count(_profiling.STRIDED_READS)
    return y


zconv_stream.launches = 0


class _ZconvStream(torch.autograd.Function):
    """Function 3, the stream map: the valid correlation y[m] = sum_{d<F}
    a[d] x[m + d], m < total.  Its adjoint is the full convolution, which
    is the same map run with the reversed taps' spectrum (hfra, hfia) over
    the gradient with F - 1 zeros in front, to the input's length."""

    @staticmethod
    def forward(x, plan, hfr, hfi, u, total, hfra, hfia, span):
        return _zconv_stream(plan, x, hfr, hfi, u, total)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.plan, hfr, hfi, ctx.u, _, hfra, hfia, ctx.span = inputs
        ctx.length = x.shape[-1]
        ctx.save_for_backward(hfr, hfi, hfra, hfia)

    @staticmethod
    def backward(ctx, g):
        hfr, hfi, hfra, hfia = ctx.saved_tensors
        gx = zconv_stream(ctx.plan, F.pad(g, (ctx.span - 1, 0)), hfra, hfia, ctx.u,
                          ctx.length, adjoint=(hfr, hfi, ctx.span))
        return gx, None, None, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, plan, hfr, hfi, u, total, hfra, hfia, span):
        # the mapped dimension joins the rows: streams [V, R, L] run as
        # [V*R, L] in one call
        _unmapped_filter(in_dims[2:4] + in_dims[6:8])
        x = _grad.batched(x, in_dims[0], info.batch_size, 0)
        v, r, length = x.shape
        y = zconv_stream(plan, x.reshape(v * r, length).contiguous(), hfr, hfi, u, total,
                         adjoint=(hfra, hfia, span))
        return y.view(v, r, total), 0
