"""Public transforms of the port.

Counterpart of ``pffft_tpu/fft.py``, the pffft.h parity surface:

    transform(plan, x, direction)          <-> pffft_transform (internal order)
    transform_ordered(plan, x, direction)  <-> pffft_transform_ordered
    zreorder(plan, z, direction)           <-> pffft_zreorder
    zconvolve_accumulate / zconvolve_no_accu

on batch-major arrays [..., N] (any leading dims), with the complex API in
complex dtypes (``torch.complex64`` in and out, planar inside), the split
API on (re, im) planes, and the time-major planes [N, B] of
:func:`transform_ordered_split_tmajor`.  Transforms are unscaled:
backward(forward(x)) == N * x.  Real spectra are N/2 complex bins with
pffft's packed bin0 = DC + i*Nyquist.

torch tensors stay on their device; numpy input goes to ``device``
(default "cuda").  The caller's tensors are not modified, except by the
``_inplace`` forms, which write the result into the caller's planes (the C
API's input == output aliasing).  Plans are ``Plan`` objects; the ordered
calls also take a ``bluestein.BluesteinPlan`` (any length N).  A float64
plan takes and gives
float64 planes and complex128 arrays, and runs the stage engine
(``ops/dispatch.py``); a real float64 plan's split steps are the torch
steps of ``ops/split.py``, in float64.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import plan as _plan
from .ops import _grad
from .ops import dispatch as _dispatch
from .ops import split as _split
from .ops import stages as _stages
from .plan import BACKWARD, FORWARD, Plan

__all__ = [
    "transform",
    "transform_ordered",
    "zreorder",
    "zconvolve_accumulate",
    "zconvolve_no_accu",
    "transform_split",
    "transform_ordered_split",
    "transform_ordered_split_tmajor",
    "transform_split_inplace",
    "transform_ordered_split_inplace",
    "zconvolve_split",
    "cfft",
    "icfft",
    "rfft_packed",
    "irfft_packed",
    "spectrum_unpack",
    "spectrum_pack",
    "fftfreq",
    "rfftfreq",
    "fftshift",
    "ifftshift",
]


# numpy dtype of each torch dtype the converters make
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.complex64: np.complex64, torch.complex128: np.complex128}


def _to_device(x, device: Optional[str], dtype) -> torch.Tensor:
    """``x`` as a contiguous tensor of ``dtype``: torch tensors stay on
    their device, numpy arrays go to ``device`` (default "cuda")."""

    if isinstance(x, torch.Tensor):
        return x.to(dtype).contiguous()
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.from_numpy(np.require(x, _NP_DTYPES[dtype], ("C", "W"))).to(dev)


def _real_dtype(plan: Optional[Plan]) -> torch.dtype:
    """The planes' dtype of ``plan`` (float32 without a plan)."""

    return torch.float64 if plan is not None and plan.dtype == np.float64 else torch.float32


def _complex_dtype(plan: Optional[Plan]) -> torch.dtype:
    """The complex dtype of ``plan`` (complex64 without a plan)."""

    return torch.complex128 if _real_dtype(plan) == torch.float64 else torch.complex64


def _as_plane(x, device: Optional[str], plan: Optional[Plan] = None) -> torch.Tensor:
    """A contiguous tensor of the plan's real dtype (see :func:`_to_device`)."""

    return _to_device(x, device, _real_dtype(plan))


def _as_complex(x, device: Optional[str], plan: Optional[Plan] = None) -> torch.Tensor:
    """A contiguous tensor of the plan's complex dtype (see :func:`_to_device`)."""

    return _to_device(x, device, _complex_dtype(plan))


def _as_tensor(x, device: Optional[str], plan: Optional[Plan] = None) -> torch.Tensor:
    """torch tensors as they are; numpy arrays as tensors of the plan's
    complex or real dtype on ``device``."""

    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    return _to_device(arr, device,
                      _complex_dtype(plan) if np.iscomplexobj(arr) else _real_dtype(plan))


def _check_pair(re: torch.Tensor, im: torch.Tensor) -> None:
    if im.shape != re.shape or im.device != re.device:
        raise ValueError(
            f"re and im planes differ: {tuple(re.shape)} on {re.device}, "
            f"{tuple(im.shape)} on {im.device}"
        )


def _check_plan(plan, name: str) -> None:
    if not isinstance(plan, Plan):
        raise TypeError(
            f"unsupported plan type {type(plan).__name__} for {name} "
            f"(a BluesteinPlan goes through transform_ordered / "
            f"transform_ordered_split; CztPlan through czt/czt_split)")


def _check_len(plan: Plan, x, backward: bool) -> None:
    expect = plan.n
    if plan.is_real:
        expect = plan.spectrum_size if backward else plan.n
    if x.shape[-1] != expect:
        raise ValueError(
            f"input last-axis length {x.shape[-1]} does not match plan "
            f"(N={plan.n}, {plan.kind.value}): expected {expect}"
        )


# ---------------------------------------------------------------------------
# Core implementations on planes
# ---------------------------------------------------------------------------


# The torch split steps of ops/split.py by (time_major, backward): a real
# float64 plan's split step, as the reference's XLA steps (no kernel is f64).
_TORCH_SPLIT_STEPS = {
    (True, False): _split.real_forward_split_planar_tmajor,
    (True, True): _split.real_backward_split_planar_tmajor,
    (False, False): _split.real_forward_split_planar,
    (False, True): _split.real_backward_split_planar,
}


def _split_step(plan: Plan, backward: bool, time_major: bool):
    """Callable (zr, zi) -> the real split step: the split kernel's route
    for an f32 plan, else the torch step in the plan's dtype."""

    route = (_dispatch.real_split_kernel_route if time_major
             else _dispatch.real_split_bmajor_route)(plan, backward)
    if route is not None:
        return route
    step = _TORCH_SPLIT_STEPS[(time_major, backward)]
    return lambda zr, zi: step(zr, zi, _split.real_split_twiddle(plan, zr.device))


def _real_forward_planar(plan: Plan, x: torch.Tensor):
    """[..., N] real -> the packed spectrum planes [..., N/2] x2: the pack
    copy, the length-N/2 complex transform, the split step."""

    zr, zi = _split.pack_real_input_split(x)
    zr, zi = _dispatch.cfft_dispatch(plan, zr, zi, time_major=False)
    return _split_step(plan, False, False)(zr, zi)


def _real_backward_planar(plan: Plan, sr: torch.Tensor, si: torch.Tensor) -> torch.Tensor:
    """The packed spectrum planes [..., N/2] x2 -> [..., N] real, unscaled:
    the split step, the backward transform, the interleave copy."""

    zr, zi = _split_step(plan, True, False)(sr, si)
    wr, wi = _dispatch.cfft_dispatch(plan, zr, zi, backward=True, time_major=False)
    return _split.interleave_to_real_split(wr, wi)


def _complex_planar(plan: Plan, re: torch.Tensor, im: torch.Tensor, backward: bool,
                    ordered: bool):
    """Complex planes [..., N] through the batch-major dispatcher.  Not
    ordered: a forward spectrum comes out, a backward one goes in, in the
    plan's internal order."""

    if backward and not ordered:
        re = _stages.reorder_spectrum(re, plan.factors, to_canonical=True)
        im = _stages.reorder_spectrum(im, plan.factors, to_canonical=True)
    return _dispatch.cfft_dispatch(plan, re, im, backward=backward, time_major=False,
                                   ordered=ordered)


def _split_call(plan: Plan, x, d, ordered: bool, device: Optional[str], name: str):
    """The split-format transform: planes in, planes (or a real signal) out."""

    _check_plan(plan, name)
    backward = d == BACKWARD
    if plan.is_real and not backward:
        x = _as_plane(x, device, plan)
        _check_len(plan, x, False)
        return _real_forward(plan, x, False)
    re, im = (_as_plane(a, device, plan) for a in x)
    _check_pair(re, im)
    _check_len(plan, re, backward)
    if plan.is_real:
        return _real_backward(plan, re, im, False)
    return _complex_planar(plan, re, im, backward, ordered)


def _complex_call(plan: Plan, x, d, ordered: bool, device: Optional[str], name: str):
    """The complex-dtype transform: the split transform between
    ``to_split`` and ``from_split``."""

    _check_plan(plan, name)
    backward = d == BACKWARD
    if plan.is_real and not backward:
        return _split.from_split(_split_call(plan, x, d, True, device, name))
    z = _as_complex(x, device, plan)
    _check_len(plan, z, backward)
    out = _split_call(plan, _split.to_split(z), d, ordered, device, name)
    return out if plan.is_real else _split.from_split(out)


# ---------------------------------------------------------------------------
# Public API: complex dtypes
# ---------------------------------------------------------------------------


def transform_ordered(plan: Plan, x, direction=FORWARD, *, device: Optional[str] = None):
    """pffft_transform_ordered parity: canonical spectrum order.

    REAL forward:  [..., N] real      -> [..., N/2] complex64 (packed bin0)
    REAL backward: [..., N/2] complex -> [..., N] real (unscaled, = N*x)
    COMPLEX:       [..., N] complex   -> [..., N] complex64

    (complex128 and float64 for a float64 plan.)
    """

    d = _plan._coerce_direction(direction)
    if not isinstance(plan, Plan):
        from . import bluestein as _bs

        if isinstance(plan, _bs.BluesteinPlan):  # arbitrary-N chirp-Z plan
            return _bs.transform_any(plan, x, d, device=device)
        raise TypeError(
            f"unsupported plan type {type(plan).__name__} for "
            f"transform_ordered (CztPlan goes through czt/czt_split; "
            f"FourStepPlan through its forward/backward methods)")
    return _complex_call(plan, x, d, True, device, "transform_ordered")


def transform(plan: Plan, x, direction=FORWARD, *, device: Optional[str] = None):
    """pffft_transform parity: the plan's internal (unordered) z-layout.

    For complex plans the internal layout is the last Stockham stage's
    transpose-free order (``ops/stages.reorder_spectrum``); for real plans
    it coincides with canonical order.  Use :func:`zreorder` to map to and
    from canonical order; the ``zconvolve`` functions work in it."""

    d = _plan._coerce_direction(direction)
    return _complex_call(plan, x, d, False, device, "transform")


def zreorder(plan: Plan, z, direction=FORWARD, *, device: Optional[str] = None):
    """pffft_zreorder parity.  FORWARD: internal -> canonical; BACKWARD:
    canonical -> internal.  Real plans: the identity."""

    d = _plan._coerce_direction(direction)
    if plan.is_real:
        return z
    return _stages.reorder_spectrum(_as_tensor(z, device, plan), plan.factors,
                                    to_canonical=(d == FORWARD))


def _zmul(plan: Plan, a: torch.Tensor, b: torch.Tensor, scaling) -> torch.Tensor:
    """Pointwise spectral product; bin0 of a real spectrum holds two real
    values (DC, Nyquist), which multiply component-wise."""

    ab = a * b
    if plan.is_real:
        ab[..., 0] = torch.complex(a[..., 0].real * b[..., 0].real,
                                   a[..., 0].imag * b[..., 0].imag)
    return ab * float(np.asarray(scaling, plan.dtype))


def zconvolve_no_accu(plan: Plan, dft_a, dft_b, scaling=1.0, *,
                      device: Optional[str] = None):
    """pffft_zconvolve_no_accu parity: (a*b)*scaling, in internal layout."""

    return _zmul(plan, _as_complex(dft_a, device, plan), _as_complex(dft_b, device, plan),
                 scaling)


def zconvolve_accumulate(plan: Plan, dft_a, dft_b, dft_ab, scaling=1.0, *,
                         device: Optional[str] = None):
    """pffft_zconvolve_accumulate parity: ab + (a*b)*scaling."""

    return _as_complex(dft_ab, device, plan) + _zmul(
        plan, _as_complex(dft_a, device, plan), _as_complex(dft_b, device, plan), scaling)


def cfft(plan: Plan, x, *, device: Optional[str] = None):
    """Forward complex FFT, canonical order (numpy convention, unscaled)."""

    return transform_ordered(plan, x, FORWARD, device=device)


def icfft(plan: Plan, x, *, device: Optional[str] = None):
    """Unscaled inverse complex FFT: icfft(cfft(x)) == N * x."""

    return transform_ordered(plan, x, BACKWARD, device=device)


def rfft_packed(plan: Plan, x, *, device: Optional[str] = None):
    """Forward real FFT with pffft bin0 packing: [..., N] -> [..., N/2]."""

    return transform_ordered(plan, x, FORWARD, device=device)


def irfft_packed(plan: Plan, s, *, device: Optional[str] = None):
    """Unscaled inverse of rfft_packed: [..., N/2] -> [..., N] (= N * x)."""

    return transform_ordered(plan, s, BACKWARD, device=device)


def _as_spectrum(s, device: Optional[str]) -> torch.Tensor:
    """A complex tensor for the spectrum helpers, in the input's precision:
    a complex128 or float64 tensor or array (a float64 plan's spectrum)
    becomes complex128, the rest complex64."""

    if isinstance(s, torch.Tensor):
        wide = s.dtype in (torch.complex128, torch.float64)
    else:
        s = np.asarray(s)
        wide = s.dtype in (np.complex128, np.float64)
    return _to_device(s, device, torch.complex128 if wide else torch.complex64)


def spectrum_unpack(s, *, device: Optional[str] = None):
    """Packed real spectrum [..., H] -> standard rfft layout [..., H+1]
    (DC ... Nyquist as separate bins, numpy.fft.rfft convention)."""

    s = _as_spectrum(s, device)
    dc = s[..., :1].real.to(s.dtype)
    nyq = s[..., :1].imag.to(s.dtype)
    return torch.cat([dc, s[..., 1:], nyq], dim=-1)


def spectrum_pack(r, *, device: Optional[str] = None):
    """Standard rfft layout [..., H+1] -> pffft packed layout [..., H]."""

    r = _as_spectrum(r, device)
    out = r[..., :-1].clone()
    out[..., 0] = torch.complex(r[..., 0].real, r[..., -1].real)
    return out


# ---------------------------------------------------------------------------
# Public API: split format (planar re/im)
# ---------------------------------------------------------------------------


def transform_ordered_split(plan: Plan, x, direction=FORWARD, *,
                            device: Optional[str] = None):
    """Split-format transform_ordered.

    REAL forward:  x [..., N] real          -> (re, im) [..., N/2]
    REAL backward: x = (re, im) [..., N/2]  -> [..., N] real
    COMPLEX:       x = (re, im) [..., N]    -> (re, im) [..., N]
    """

    d = _plan._coerce_direction(direction)
    if not isinstance(plan, Plan):
        from . import bluestein as _bs

        if isinstance(plan, _bs.BluesteinPlan):  # arbitrary-N chirp-Z plan
            return _bs.transform_any_split(plan, x, d, device=device)
        raise TypeError(
            f"unsupported plan type {type(plan).__name__} for "
            f"transform_ordered_split (CztPlan goes through czt_split)")
    return _split_call(plan, x, d, True, device, "transform_ordered_split")


def transform_split(plan: Plan, x, direction=FORWARD, *, device: Optional[str] = None):
    """Split-format transform (internal/unordered z-layout)."""

    d = _plan._coerce_direction(direction)
    return _split_call(plan, x, d, False, device, "transform_split")


def _write_back(x, out):
    """The result written into the caller's plane tensors, which are
    returned; numpy planes cannot alias a tensor, so the result is."""

    if not all(isinstance(a, torch.Tensor) for a in x):
        return out
    for dst, src in zip(x, out, strict=True):
        dst.copy_(src)
    return tuple(x)


def transform_ordered_split_inplace(plan: Plan, x, direction=FORWARD, *,
                                    device: Optional[str] = None):
    """In-place :func:`transform_ordered_split`: complex planes get the
    result written into them and are returned (pffft_transform_ordered with
    input == output).  Real plans change the shape, so they fall back to
    the pure call."""

    out = transform_ordered_split(plan, x, direction, device=device)
    return out if plan.is_real else _write_back(x, out)


def transform_split_inplace(plan: Plan, x, direction=FORWARD, *,
                            device: Optional[str] = None):
    """In-place variant of :func:`transform_split` (internal layout)."""

    out = transform_split(plan, x, direction, device=device)
    return out if plan.is_real else _write_back(x, out)


def zconvolve_split(plan: Plan, a, b, scaling=1.0, accumulate=None, *,
                    device: Optional[str] = None):
    """Split-format pointwise spectral product (internal layout), with the
    real-packing DC/Nyquist component-wise fixup.

    a, b: (re, im) pairs; optional ``accumulate`` = (re, im) to add into.
    Returns (re, im)."""

    ar, ai = (_as_plane(t, device, plan) for t in a)
    br, bi = (_as_plane(t, device, plan) for t in b)
    cr, ci = _split.split_mul((ar, ai), (br, bi))
    if plan.is_real:
        cr = _split._set_bin0(cr, ar[..., 0] * br[..., 0])
        ci = _split._set_bin0(ci, ai[..., 0] * bi[..., 0])
    s = float(np.asarray(scaling, plan.dtype))
    cr, ci = cr * s, ci * s
    if accumulate is not None:
        cr = cr + _as_plane(accumulate[0], device, plan)
        ci = ci + _as_plane(accumulate[1], device, plan)
    return cr, ci


# ---------------------------------------------------------------------------
# Frequency grids (host-side numpy, plan and axis bookkeeping) and shifts
# ---------------------------------------------------------------------------


def fftfreq(n: int, d: float = 1.0) -> np.ndarray:
    """Bin center frequencies of a length-n complex transform (np.fft.fftfreq)."""

    n = int(n)
    k = np.empty(n, dtype=np.float64)
    half = (n - 1) // 2 + 1
    k[:half] = np.arange(half)
    k[half:] = np.arange(-(n // 2), 0)
    return k / (n * d)


def rfftfreq(n: int, d: float = 1.0) -> np.ndarray:
    """Bin center frequencies of spectrum_unpack output (np.fft.rfftfreq):
    n//2 + 1 non-negative bins."""

    n = int(n)
    return np.arange(n // 2 + 1, dtype=np.float64) / (n * d)


def _shift(x, axes, device: Optional[str], sign: int):
    x = _as_tensor(x, device)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    return torch.roll(x, [sign * (x.shape[a] // 2) for a in axes], list(axes))


def fftshift(x, axes=None, *, device: Optional[str] = None):
    """Move the zero-frequency bin to the center (np.fft.fftshift)."""

    return _shift(x, axes, device, 1)


def ifftshift(x, axes=None, *, device: Optional[str] = None):
    """Inverse of fftshift (exact for odd lengths too)."""

    return _shift(x, axes, device, -1)


# ---------------------------------------------------------------------------
# Time-major planes [N, B]
# ---------------------------------------------------------------------------


def _real_forward_tmajor(plan: Plan, x: torch.Tensor):
    """[N, B] real -> the packed spectrum planes [N/2, B] x2."""

    batch = x.shape[1]
    y = x.view(plan.engine_n, 2 * batch)  # free: row h is x[2h] | x[2h+1]
    fused = _dispatch.fused_real_fwd_route(plan, batch, x.device)
    if fused is not None:
        return fused(y)
    packed = _dispatch.packed_fwd_route(plan, batch, x.device)
    if packed is not None:
        zr, zi = packed(y)
    else:
        zr, zi = _split.pack_real_input_split_tmajor(x)
        zr, zi = _dispatch.cfft_dispatch(plan, zr, zi)
    return _split_step(plan, False, True)(zr, zi)


def _real_backward_tmajor(plan: Plan, sr: torch.Tensor, si: torch.Tensor):
    """The packed spectrum planes [N/2, B] x2 -> [N, B] real, unscaled."""

    batch = sr.shape[1]
    fused = _dispatch.fused_real_bwd_route(plan, batch, sr.device)
    if fused is not None:
        return fused(sr, si)  # the kernel writes [N, B] itself
    zr, zi = _split_step(plan, True, True)(sr, si)
    wr, wi = _dispatch.cfft_dispatch(plan, zr, zi, backward=True)
    return _split.interleave_to_real_split_tmajor(wr, wi)


# ---------------------------------------------------------------------------
# Function 2: the real transforms, differentiable
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _bin_scale(h: int, scale: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[H]: 1 at the packed bin0 (DC and Nyquist), ``scale`` at bins 1 .. H-1."""

    d = torch.full((h,), scale, dtype=dtype, device=device)
    d[0] = 1.0
    return d


def _scale_bins(sr: torch.Tensor, si: torch.Tensor, scale: float, time_major: bool):
    """Packed spectrum planes with bins 1 .. H-1 times ``scale`` and both parts
    of bin0 as they are: one elementwise pass, whose output is contiguous."""

    axis = 0 if time_major else -1
    d = _bin_scale(sr.shape[axis], scale, sr.dtype, sr.device)
    if time_major:
        d = d[:, None]
    return sr * d, si * d


class _RealForward(torch.autograd.Function):
    """Function 2, the real forward transform [..., N] (or time-major [N,
    B]) -> the packed spectrum planes.

    With D the diagonal map that halves bins 1 .. N/2-1 and leaves both
    parts of the packed bin0 (DC + i*Nyquist), the adjoint of the unscaled
    forward is the unscaled real backward of D*g."""

    @staticmethod
    def forward(x, plan, time_major):
        return (_real_forward_tmajor if time_major else _real_forward_planar)(plan, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.plan, ctx.time_major = inputs

    @staticmethod
    def backward(ctx, gr, gi):
        gr, gi = _scale_bins(gr, gi, 0.5, ctx.time_major)
        return _real_backward(ctx.plan, gr, gi, ctx.time_major), None, None

    @staticmethod
    def vmap(info, in_dims, x, plan, time_major):
        # the mapped dimension joins the batch, as in dispatch._Cfft
        x = _grad.batched(x, in_dims[0], info.batch_size, 1 if time_major else 0)
        if not time_major:
            return _real_forward(plan, x.contiguous(), False), (0, 0)
        n, v, b = x.shape
        sr, si = _real_forward(plan, x.reshape(n, v * b), True)
        return (sr.view(-1, v, b), si.view(-1, v, b)), (1, 1)


class _RealBackward(torch.autograd.Function):
    """Function 2, the real backward transform: the packed spectrum planes
    -> [..., N] (or time-major [N, B]), unscaled.  Its adjoint is D^-1 times
    the real forward of the gradient (see :class:`_RealForward`)."""

    @staticmethod
    def forward(sr, si, plan, time_major):
        return (_real_backward_tmajor if time_major else _real_backward_planar)(plan, sr, si)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, ctx.plan, ctx.time_major = inputs

    @staticmethod
    def backward(ctx, g):
        gr, gi = _real_forward(ctx.plan, g.contiguous(), ctx.time_major)
        return (*_scale_bins(gr, gi, 2.0, ctx.time_major), None, None)

    @staticmethod
    def vmap(info, in_dims, sr, si, plan, time_major):
        sr, si = (_grad.batched(t, d, info.batch_size, 1 if time_major else 0)
                  for t, d in zip((sr, si), in_dims))
        if not time_major:
            return _real_backward(plan, sr.contiguous(), si.contiguous(), False), 0
        h, v, b = sr.shape
        x = _real_backward(plan, sr.reshape(h, v * b), si.reshape(h, v * b), True)
        return x.view(-1, v, b), 1


def _real_forward(plan: Plan, x: torch.Tensor, time_major: bool):
    """The real forward of either layout; through :class:`_RealForward`
    where a gradient is recorded."""

    if _grad.needed(x):
        return _RealForward.apply(x, plan, time_major)
    return (_real_forward_tmajor if time_major else _real_forward_planar)(plan, x)


def _real_backward(plan: Plan, sr: torch.Tensor, si: torch.Tensor, time_major: bool):
    """The real backward of either layout; through :class:`_RealBackward`
    where a gradient is recorded."""

    if _grad.needed(sr, si):
        return _RealBackward.apply(sr, si, plan, time_major)
    return (_real_backward_tmajor if time_major else _real_backward_planar)(plan, sr, si)


def transform_ordered_split_tmajor(plan: Plan, x, direction=FORWARD, *,
                                   device: Optional[str] = None):
    """Split-format ordered transform in TIME-MAJOR layout.

    COMPLEX:       x = (re, im) planes [N, B] -> (re, im) [N, B]
    REAL forward:  x [N, B] real             -> (re, im) [N/2, B]
    REAL backward: x = (re, im) [N/2, B]     -> [N, B] real

    Tensors of the plan's dtype (f32, or f64 for a float64 plan), unscaled
    (backward(forward(x)) == N*x), canonical bin order; real spectra pack
    bin0 = DC + i*Nyquist.  The caller's tensors are not modified.  numpy
    input is moved to ``device`` (default "cuda"); tensors stay where they
    are.
    """

    _check_plan(plan, "transform_ordered_split_tmajor")
    d = _plan._coerce_direction(direction)
    if plan.is_real:
        if d == BACKWARD:
            sr, si = (_as_plane(a, device, plan) for a in x)
            if sr.ndim != 2 or sr.shape[0] != plan.spectrum_size:
                raise ValueError(
                    f"time-major real spectrum planes must be "
                    f"[{plan.spectrum_size}, B]; got {tuple(sr.shape)}"
                )
            _check_pair(sr, si)
            return _real_backward(plan, sr, si, True)
        if isinstance(x, (tuple, list)):
            raise ValueError(
                "time-major REAL forward takes a single [N, B] real array "
                "(got a tuple; planar pairs are the spectrum side)"
            )
        x = _as_plane(x, device, plan)
        if x.ndim != 2 or x.shape[0] != plan.n:
            raise ValueError(
                f"time-major real input must be [N={plan.n}, B]; got {tuple(x.shape)}"
            )
        return _real_forward(plan, x, True)
    re, im = (_as_plane(a, device, plan) for a in x)
    if re.ndim != 2 or re.shape[0] != plan.n:
        raise ValueError(
            f"time-major planes must be [N={plan.n}, B]; got {tuple(re.shape)}"
        )
    _check_pair(re, im)
    return _dispatch.cfft_dispatch(plan, re, im, backward=d == BACKWARD)
