"""The real transform's split step on batch-major planes [B, H] (kernel B6).

Counterpart of ``pffft_tpu/ops/real_kernel.py``.  The Pallas kernel becomes
``csrc/real_split_bmajor.cu``: one thread per Hermitian pair (k, H - k) of
a row, one read and one write of every value, at any H and B.  The TPU's
3-view mirror blocks and its roll network, and the H >= 2^14 limit they
bring, have no counterpart.

  forward:  REAL_FINALIZE, the length-H transform -> the packed real
            spectrum (``split.real_forward_split_planar``);
  backward: REAL_PREPROCESS, the packed spectrum -> 2*Z
            (``split.real_backward_split_planar``).

The arithmetic is the flat form of ``csrc/real.cuh``, which the plain
version :func:`real_split_plain` repeats.  :func:`real_split` takes the
plain version only for tensors on the CPU; for a CUDA tensor it launches
the kernel or raises.  ``real_split.launches`` counts its launches.  The
split twiddles are ``real_twiddle = (wr, wi)``, f32 tensors [H] on the
data's device (``split.real_split_twiddle``).
"""

from __future__ import annotations

import torch

from ..utils import profiling as _profiling
from . import _build
from . import pallas_fft as _pk
from . import split as _split

__all__ = ["real_split", "real_split_plain"]


def real_split_plain(zr, zi, real_twiddle, *, backward: bool = False):
    """Plain PyTorch version of the kernel: the flat split step on [B, H]."""

    if backward:
        return _split.real_backward_split_planar_flat(zr, zi, real_twiddle)
    return _split.real_forward_split_planar_flat(zr, zi, real_twiddle)


def real_split(zr: torch.Tensor, zi: torch.Tensor, real_twiddle, *,
               backward: bool = False):
    """ONE-pass real split step on batch-major planes [B, H], any H and B.

    Forward: REAL_FINALIZE, the length-H transform -> the packed real
    spectrum.  Backward: REAL_PREPROCESS, the packed spectrum -> 2*Z, the
    input of the backward length-H transform."""

    b, h = _pk._planes(zr, zi)
    _pk._check_real_twiddle(real_twiddle, h, zr.device)
    if zr.device.type == "cpu":
        return real_split_plain(zr, zi, real_twiddle, backward=backward)
    wr, wi = real_twiddle
    _pk._check_cuda(zr, zi, wr, wi)
    ore, oim = torch.empty_like(zr), torch.empty_like(zi)
    if b == 0 or h == 0:
        return ore, oim
    with _profiling.span("launch", "real_split"):
        lib, fn = _pk._kernel("pf_real_split_bmajor")
        err = fn(zr.data_ptr(), zi.data_ptr(), ore.data_ptr(), oim.data_ptr(), wr.data_ptr(),
                 wi.data_ptr(), h, b, int(backward), zr.device.index or 0, _pk._stream(zr))
        _build.check(lib, err, f"batch-major real split kernel (H={h}, B={b}, "
                               f"backward={backward})")
    real_split.launches += 1
    return ore, oim


real_split.launches = 0
