"""PFFASTCONV parity: FFT-based overlap-save FIR fast convolution.

Counterpart of ``pffft_tpu/conv.py``, with the same semantics:

  * ``y[i] = sum_j x[i+j] * h[filterLen-1-j]``, valid-mode convolution
    ``np.convolve(x, h, 'valid')`` (correlation with CORRELATION);
  * block length negotiation Nfft = max(2*next_pow2(filterLen-1), 32,
    next_pow2(blockLen)) (pffastconv_new_setup);
  * the streaming contract: apply() returns (output, consumed), the caller
    keeps the unconsumed tail;
  * the flags CPLX_INP_OUT, CPLX_SINGLE_FFT, CORRELATION, CPLX_FILTER (the
    reference library rejects it; here it runs on the complex path),
    SYMMETRIC, DIRECT_INP and DIRECT_OUT (hints, no-ops).

Every flag runs the reference's time-major block pipeline
(``FastConv._build_fused_stream``): the stream is framed at stride u =
``num_out_per_block`` into blocks of Nfft samples, each block is
circularly convolved with the time-arranged filter g, and the first u
samples of each block are kept.  A real filter's spectrum is Hermitian,
so one complex transform carries two real frames (re = even frame, im =
odd frame), or the I and Q frames of one complex frame; a complex filter's
transform holds one complex frame.  The route is
``ops/dispatch.conv_route_mode``'s: ``"fused"``, one launch of the fused
spectral-conv kernel's stream map (``csrc/conv_fused.cu``; nfft up to
16384), which frames the streams, convolves and keeps the valid samples in
the kernel, or ``"tmajor"``, the same pipeline composed of copies (frames
into time-major columns [Nfft, C], the block convolution, the valid
samples back out; ``ops/conv_kernel.stream_conv``) around the routed
forward transform, a multiply by Hf and the routed backward transform
(:meth:`FastConv._transform_conv`).  The column pipeline
(:meth:`FastConv._block_conv`, which StreamingConv runs on its frames)
routes on its own: the kernel's column map up to nfft 2048, else the same
routed transforms.  ``apply_batched`` serves every row in one call.

numpy input goes to the setup's ``device`` (default "cuda"); tensors stay
where they are.  A float64 setup computes in float64 and complex128 and
always takes the ``"tmajor"`` route, whose transforms run the stage engine:
the fused kernel is f32 only, as the reference's is.
"""

from __future__ import annotations

import enum
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import fft as _fft
from . import plan as _plan
from . import runtime as _runtime
from .ops import _grad
from .ops import conv_kernel as _ck
from .ops import dispatch as _dispatch
from .utils import profiling as _profiling

__all__ = ["ConvFlags", "FastConv", "StreamingConv", "new_setup", "apply", "fastconv_valid"]

# The reference's minimum block: 2 * simd_size**2 with its simd_size of 4
# (pffastconv_new_setup).
_MIN_FFT_LEN = 32


class ConvFlags(enum.IntFlag):
    """pffastconv_flags_t parity."""

    NONE = 0
    CPLX_INP_OUT = 1
    CPLX_FILTER = 2
    DIRECT_INP = 4
    DIRECT_OUT = 8
    CPLX_SINGLE_FFT = 16
    SYMMETRIC = 32
    CORRELATION = 64


def _negotiate_nfft(filter_len: int, block_len: int) -> int:
    """Block-length negotiation, the mirror of pffastconv_new_setup."""

    nfft = 2 * _plan.next_power_of_two(filter_len - 1)
    if nfft < _MIN_FFT_LEN:
        nfft = _MIN_FFT_LEN
    if block_len > nfft:
        nfft = _plan.next_power_of_two(block_len)
    return nfft


def _as_tensor(x, device, dtype=np.float32) -> torch.Tensor:
    """A tensor of real ``dtype`` (float32 or float64) or of its complex
    counterpart: tensors stay on their device, numpy arrays go to
    ``device``."""

    f64 = np.dtype(dtype) == np.float64
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if np.iscomplexobj(a):
            a = a.astype(np.complex128 if f64 else np.complex64)
        else:
            a = a.astype(np.float64 if f64 else np.float32)
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if x.is_complex():
        return x.to(torch.complex128 if f64 else torch.complex64)
    return x.to(torch.float64 if f64 else torch.float32)


class FastConv:
    """PFFASTCONV_Setup analog.  Immutable once built; the filter spectrum
    is cached per device."""

    def __init__(
        self,
        filter_coeffs,
        block_len: int = 0,
        flags: ConvFlags = ConvFlags.NONE,
        dtype="float32",
        device="cuda",
    ):
        flags = ConvFlags(flags)
        h = np.asarray(filter_coeffs)
        if flags & ConvFlags.CPLX_FILTER:
            h = h.astype(np.complex128)
        else:
            h = np.real(h).astype(np.float64)
        if h.ndim != 1 or h.size < 1:
            raise ValueError("filter_coeffs must be a 1-D array")
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.float32, np.float64):
            raise ValueError(f"unsupported dtype {self.dtype}; use float32 or float64")
        filter_len = int(h.size)

        self.flags = flags
        self.filter_len = filter_len
        self.correlation = bool(flags & ConvFlags.CORRELATION)
        self.cplx_stream = bool(flags & ConvFlags.CPLX_INP_OUT)
        self.cplx_filter = bool(flags & ConvFlags.CPLX_FILTER)
        self.single_fft = bool(
            self.cplx_stream and (flags & ConvFlags.CPLX_SINGLE_FFT) and not self.cplx_filter
        )
        self.device = device

        nfft = _negotiate_nfft(filter_len, int(block_len))
        self.block_len = nfft  # negotiated block length in (complex) samples
        cplx_factor = 2 if self.single_fft else 1
        nfft *= cplx_factor
        self.nfft = nfft
        self.cplx_factor = cplx_factor
        # effective filter span in scalar positions within a block
        self.filter_span = 2 * filter_len - 1 if cplx_factor == 2 else filter_len
        # the block plan of the "tmajor" route
        self.plan = _plan.new_setup(nfft, _plan.COMPLEX, dtype=self.dtype, strict=False)
        # time-arranged filter: y[m] = sum_j x[m+j] * c[j] (c = reversed h,
        # or h for correlation) is the circular convolution with g, where
        # g[(nfft - cplx_factor*j) % nfft] = c[j] (pffastconv_new_setup)
        c = h if self.correlation else h[::-1]
        g = np.zeros(nfft, dtype=h.dtype)
        g[(nfft - cplx_factor * np.arange(filter_len)) % nfft] = c
        self._g = g
        self._hf: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._hf_adjoint: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor, int]] = {}
        # None: the route by coverage; 'fused' or 'tmajor' forces a route
        # (tests, probes).  Set before first apply.
        self._force_conv_kernel: Optional[str] = None

    # ------------------------------------------------------------------
    @property
    def num_out_per_block(self) -> int:
        u = self.nfft - self.filter_span + 1
        if self.cplx_factor == 2:
            u &= ~1
        return u

    @functools.cached_property
    def hf(self) -> torch.Tensor:
        """The filter spectrum as the reference holds it: a complex tensor
        on the setup's device, unscaled, in internal layout: the transform
        of the time-arranged filter g through a REAL plan of length nfft
        (packed bin0) for a real filter, through the COMPLEX block plan for
        a complex one.  The block pipeline uses its own canonical planes
        scaled by 1/nfft (:meth:`_spectrum`)."""

        plan = (self.plan if self.cplx_filter else
                _plan.new_setup(self.nfft, _plan.REAL, dtype=self.dtype, strict=False))
        return _fft.transform(plan, self._g, _plan.FORWARD, device=self.device)

    def _spectrum(self, device: torch.device):
        """Hf = FFT(g) / nfft as planes [nfft] of the setup's dtype on
        ``device``; a miss's time goes to ``setup.seconds.spectrum``."""

        hf = self._hf.get(device)
        if hf is None:
            with _profiling.setup("spectrum"):
                hfr, hfi = _ck.filter_spectrum(self.plan, self._g)
                hf = (torch.from_numpy(hfr).to(device), torch.from_numpy(hfi).to(device))
            self._hf[device] = hf
        return hf

    def _adjoint(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(hfr, hfi, span) of the stream map's adjoint on ``device``: the
        spectrum of the time-arranged filter of the taps reversed and
        conjugated (the correlation taps a[d] become conj(a[span-1-d])), and
        the filter span.  Built once per device, as :meth:`_spectrum` is."""

        adj = self._hf_adjoint.get(device)
        if adj is None:
            with _profiling.setup("spectrum"):
                n, cf = self.nfft, self.cplx_factor
                j = np.arange(self.filter_len)
                g = np.zeros_like(self._g)
                g[(n - cf * j) % n] = np.conj(self._g[(n - cf * j[::-1]) % n])
                hfr, hfi = _ck.filter_spectrum(self.plan, g)
                adj = (torch.from_numpy(hfr).to(device), torch.from_numpy(hfi).to(device),
                       self.filter_span)
            self._hf_adjoint[device] = adj
        return adj

    def _route(self, device: torch.device, stream: bool = False) -> str:
        """The block pipeline of ``dispatch.conv_route_mode`` ("tmajor" for
        float64) for the stream map (``stream``) or the column map."""

        mode = ("tmajor" if self.dtype == np.float64
                else _dispatch.conv_route_mode(self.nfft, self._force_conv_kernel, device,
                                               stream=stream))
        if mode is None:
            raise ValueError(f"no conv route runs nfft={self.nfft}")
        return mode

    def _block_conv(self, re: torch.Tensor, im: torch.Tensor):
        """IFFT(FFT(x)·Hf) per column of the planes [nfft, C], through the
        route of ``dispatch.conv_route_mode``: the fused kernel's column
        map, or the routed transforms around a multiply."""

        dev = re.device
        if self._route(dev) == "fused":
            hfr, hfi = self._spectrum(dev)
            cplan = _dispatch.conv_kernel_choice(self.nfft, re.shape[1], dev)[0]
            return _ck.zconv_tmajor(cplan, re, im, hfr, hfi)
        return self._transform_conv(re, im)

    def _transform_conv(self, re: torch.Tensor, im: torch.Tensor):
        """IFFT(FFT(x)·Hf) per column of the planes [nfft, C] through the
        routed forward transform, a multiply by Hf and the routed backward
        transform (the "tmajor" route)."""

        hfr, hfi = self._spectrum(re.device)
        sr, si = _fft.transform_ordered_split_tmajor(self.plan, (re, im), _plan.FORWARD)
        hr, hi = hfr[:, None], hfi[:, None]
        return _fft.transform_ordered_split_tmajor(
            self.plan, (sr * hr - si * hi, sr * hi + si * hr), _plan.BACKWARD)

    def _conv_real_frames(self, v: torch.Tensor) -> torch.Tensor:
        """Real frames [R, nb, nfft] (nb even) -> their valid samples
        [R, nb, u]: two real frames per complex column."""

        r, nb, _ = v.shape
        yr, yi = self._block_conv(*_ck.columns(v[:, 0::2], v[:, 1::2]))
        return _ck.unpack_pairs(yr, yi, self.num_out_per_block, r, nb // 2)

    def _conv_stream(self, x: torch.Tensor, total: int) -> torch.Tensor:
        """Valid-mode overlap-save conv of streams [R, L] -> [R, total]:
        real streams two frames per transform, complex streams one.  The
        "fused" route is one launch of the kernel's stream map, on the
        caller's rows where it reads them in place (:func:`_stream_rows`);
        "tmajor" composes the framing and unpacking copies around
        :meth:`_transform_conv`: the stream's route is decided once."""

        u = self.num_out_per_block
        if self._route(x.device, stream=True) == "fused":
            hfr, hfi = self._spectrum(x.device)
            adjoint = self._adjoint(x.device) if _grad.needed(x) else None
            return _ck.zconv_stream(_ck.stream_plan(self.nfft), _stream_rows(x), hfr, hfi, u,
                                    total, adjoint)
        return _ck.stream_conv(self._transform_conv, x, self.nfft, u, total)

    # ------------------------------------------------------------------
    def _as_stream(self, x) -> torch.Tensor:
        x = _as_tensor(x, self.device, self.dtype)
        if (self.cplx_stream or self.cplx_filter) and not x.is_complex():
            # interleaved float view [..., 2L] -> complex [..., L]
            x = x.reshape(*x.shape[:-1], -1, 2)
            x = torch.complex(x[..., 0], x[..., 1])
        return x

    @_profiling.entry("FastConv.apply")
    def apply(self, x, flush: bool = False) -> Tuple[torch.Tensor, int]:
        """pffastconv_apply parity.

        x: [L] float stream (real mode) or [L] complex stream (CPLX modes;
        also accepts interleaved float [2L]).  Returns (output, consumed):
        ``consumed`` samples were processed; the caller carries the other
        ``L - consumed`` samples over to the next call, as with the C API.
        """

        x = self._as_stream(x)
        if x.ndim != 1:
            raise ValueError(f"apply takes one stream [L]; got {tuple(x.shape)} "
                             f"(apply_batched takes [..., L])")
        y, total = self._apply_rows(x[None], flush)
        return y[0], total

    def _apply_rows(self, xs: torch.Tensor, flush: bool) -> Tuple[torch.Tensor, int]:
        """Streams [R, L] -> ([R, consumed], consumed)."""

        r, n = xs.shape
        if not (self.cplx_stream or self.cplx_filter):
            if xs.is_complex():
                raise ValueError("real-mode FastConv got complex input; set CPLX_INP_OUT")
            total = self._num_consumed(n, flush)
            if total <= 0:
                return xs.new_zeros((r, 0)), 0
            return self._conv_stream(xs, total), total
        if self.single_fft:
            # the interleaved stream as a real stream of length 2n
            total = self._num_consumed(2 * n, flush)
            if total <= 0:
                return xs.new_zeros((r, 0)), 0
            y = self._conv_stream(torch.view_as_real(xs).reshape(r, 2 * n), total)
            return torch.complex(y[:, 0::2], y[:, 1::2]), total // 2
        # a complex filter, or a real one on I and Q (pffastconv's two FFTs)
        total = self._num_consumed(n, flush)
        if total <= 0:
            return xs.new_zeros((r, 0)), 0
        return self._conv_stream(xs, total), total

    def _num_consumed(self, input_len_scalar: int, flush: bool) -> int:
        """Total samples produced/consumed, in scalar stream positions (the
        loop-bound algebra of pffastconv_apply)."""

        nfft, span = self.nfft, self.filter_span
        u = self.num_out_per_block
        if flush:
            max_off = input_len_scalar - span + 1
            if self.cplx_factor == 2:
                # the C loop steps by even numOut and stops when numOut == 0
                off = 0
                while off < max_off:
                    proc = min(nfft, input_len_scalar - off)
                    nout = (proc - span + 1) & ~1
                    if nout <= 0:
                        break
                    off += nout
                return max(0, off)
            return max(0, max_off)
        max_off = input_len_scalar - nfft + 1
        if max_off <= 0:
            return 0
        nb = -(-max_off // u)  # number of full blocks started below max_off
        return nb * u

    # ------------------------------------------------------------------
    @_profiling.entry("FastConv.apply_batched")
    def apply_batched(self, x, flush: bool = True) -> torch.Tensor:
        """Batched one-shot convenience: x [..., L] -> [..., consumed]
        (valid-mode with flush), each row as ``apply`` gives it.  Every
        row's frames go into one column set: one route call serves the
        batch."""

        x = self._as_stream(x)
        lead = x.shape[:-1]
        y, _ = self._apply_rows(x.reshape(-1, x.shape[-1]), flush)
        return y.reshape(*lead, y.shape[-1])

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"FastConv(filterLen={self.filter_len}, Nfft={self.nfft}, "
            f"blockLen={self.block_len}, flags={self.flags!r})"
        )


def new_setup(filter_coeffs, filter_len: Optional[int] = None, block_len: int = 0, flags=0,
              device="cuda") -> FastConv:
    """pffastconv_new_setup parity.  The negotiated block length is
    ``setup.block_len``."""

    h = np.asarray(filter_coeffs)
    if filter_len is not None:
        h = h[:filter_len]
    return FastConv(h, block_len=block_len, flags=ConvFlags(flags), device=device)


def apply(setup: FastConv, x, flush: bool = False) -> Tuple[torch.Tensor, int]:
    """pffastconv_apply parity; returns (output, consumed)."""

    return setup.apply(x, flush)


def fastconv_valid(x, h, flags: ConvFlags = ConvFlags.NONE, device="cuda") -> torch.Tensor:
    """One-shot valid-mode fast convolution of [..., L] with filter [F]:
    np.convolve(x, h, 'valid') per row (correlation with CORRELATION).
    A tensor ``x`` stays on its device; numpy goes to ``device``."""

    if isinstance(x, torch.Tensor):
        device = x.device
    return FastConv(h, flags=flags, device=device).apply_batched(x, flush=True)


def _stream_rows(x: torch.Tensor) -> torch.Tensor:
    """Streams [R, L] as the stream map takes them: on the card the caller's
    rows themselves where the kernel reads them in place
    (``conv_kernel.stream_rows``: unit inner stride, rows at least L apart,
    as a slice of a ring buffer's rows), else a counted layout copy.  On the
    CPU always a contiguous tensor: the plain version stands for the
    kernel's arithmetic, not its reads."""

    if x.device.type == "cuda" and _ck.stream_rows(x) is not None:
        return x
    return _profiling.contiguous(x, "contiguous")


class StreamingConv:
    """Streaming FIR: the host framer + the device block pipeline.

    Push chunks of any size, get back whatever filtered output became
    ready (numpy, as the reference's); the framer (``runtime.StreamFramer``,
    the native ring buffer) carries the overlap-save tail.  Real streams
    only.

    >>> sc = StreamingConv(h, device="cpu")
    >>> for chunk in chunks: out.append(sc.push(chunk))
    >>> out.append(sc.flush())
    """

    def __init__(self, filter_coeffs, block_len: int = 0, correlation: bool = False,
                 dtype="float32", device="cuda"):
        flags = ConvFlags.CORRELATION if correlation else ConvFlags.NONE
        self.setup = FastConv(filter_coeffs, block_len=block_len, flags=flags, dtype=dtype,
                              device=device)
        self._framer = _runtime.StreamFramer(
            frame_len=self.setup.nfft, hop=self.setup.num_out_per_block
        )

    @property
    def native(self) -> bool:
        """Whether the native ring buffer frames the stream (False only
        where no C++ compiler was found: then the numpy arm does)."""

        return self._framer.native

    def _filter(self, f: torch.Tensor) -> torch.Tensor:
        """The framer's frames [k, nfft] -> their valid samples [k, u]:
        two frames per column of the block pipeline (an odd k padded by a
        zero frame).  Differentiable with respect to the frames."""

        k = f.shape[0]
        if k % 2:
            f = torch.nn.functional.pad(f, (0, 0, 0, 1))
        return self.setup._conv_real_frames(f[None])[0, :k]

    def _run(self, frames: np.ndarray) -> np.ndarray:
        s = self.setup
        y = self._filter(_as_tensor(frames, s.device, s.dtype))
        return y.reshape(-1).cpu().numpy()

    def push(self, chunk) -> np.ndarray:
        """Feed samples; returns the filtered output that became ready
        (possibly empty): the valid-mode convolution stream."""

        self._framer.push(np.asarray(chunk, dtype=np.float32))
        frames = self._framer.frames()
        if frames.shape[0] == 0:
            return np.empty(0, dtype=self.setup.dtype)
        return self._run(frames)

    def flush(self) -> np.ndarray:
        """Drain the tail (zero-padded), like pffastconv's applyFlush."""

        pending = self._framer.pending()
        frames = self._framer.flush()
        if frames.shape[0] == 0:
            return np.empty(0, dtype=self.setup.dtype)
        y = self._run(frames)
        valid = max(0, pending - self.setup.filter_len + 1)
        return y[:valid]
