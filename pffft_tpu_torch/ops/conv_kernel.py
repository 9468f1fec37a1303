"""The fused spectral-convolution kernel: forward FFT, multiply by the
filter spectrum, backward FFT, in one pass over device memory.

Counterpart of ``pffft_tpu/ops/conv_kernel.py``.  The Pallas kernel becomes
``csrc/conv_fused.cu`` (B7), built on the chain's device code
(``csrc/chain.cuh``).  Layout and algebra are the chain's: time-major
planes [N, B], one overlap-save block per column, the forward chain's
canonical-order spectrum multiplied by Hf in the same order, the backward
chain back to time order.  The 1/N scale of the inverse is folded into Hf
on the host (:func:`filter_spectrum`), so neither chain scales.

For a REAL filter Hf is Hermitian, so a column holding two real frames
(re = a, im = b) comes back as (h*a) + i(h*b): two real convolutions per
complex column.  A complex filter's column holds one complex frame.

:func:`zconv_tmajor` takes its plain version, :func:`zconv_tmajor_plain`,
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises.  ``zconv_tmajor.launches`` counts its launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import plan as _plan
from . import _build
from . import pallas_fft as _pk

__all__ = ["filter_spectrum", "zconv_tmajor", "zconv_tmajor_plain"]


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


def zconv_tmajor(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor,
                 hfr: torch.Tensor, hfi: torch.Tensor, *, tb: Optional[int] = None):
    """Fused block convolution of time-major planes [N, B]: IFFT(FFT(x)·Hf)
    per column, with Hf = (hfr, hfi) [N] from :func:`filter_spectrum`
    (canonical order, 1/N folded in) on the planes' device.  Each column is
    one overlap-save block; the caller owns framing and the valid-sample
    slice.  ``tb`` overrides the tile's columns (measurement only).  The
    inputs are not modified."""

    n, b = _pk._planes(re, im)
    _pk._chain_plan_fits(plan, n)
    for h in (hfr, hfi):
        if h.shape != (n,) or h.device != re.device:
            raise ValueError(f"filter spectrum must be two [{n}] tensors on {re.device}; "
                             f"got {tuple(h.shape)} on {h.device}")
    if re.device.type == "cpu":
        return zconv_tmajor_plain(plan, re, im, hfr, hfi)
    _pk._check_cuda(re, im, hfr, hfi)
    if tb is None:
        tb = _pk._chain_tb(plan, re.device)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return ore, oim
    lib, fn = _pk._kernel("pf_conv_fused_tmajor")
    tw, desc, count = _pk._chain_tables(plan.stages, re.device)
    err = fn(re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(), hfr.data_ptr(),
             hfi.data_ptr(), tw.data_ptr(), desc, count, n, b, tb, re.device.index or 0,
             _pk._stream(re))
    _build.check(lib, err, f"fused conv kernel (N={n}, B={b}, tb={tb})")
    zconv_tmajor.launches += 1
    return ore, oim


zconv_tmajor.launches = 0
