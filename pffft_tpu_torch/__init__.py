"""pffft_tpu_torch: the PyTorch/CUDA port of pffft_tpu.

A second package beside the JAX one, with the same conventions: unscaled
transforms (backward(forward(x)) == N*x), canonical bin order, planar
(re, im) split APIs.  Its kernels are CUDA C++ for Hopper (sm_90a) under
``csrc/``, built with nvcc on first use; on the CPU every kernel wrapper
runs its plain PyTorch version.  It imports neither jax nor pffft_tpu.

Ported so far: the transforms of float32 and float64 plans, complex and
real, on batch-major arrays [..., N] (the pffft.h parity API:
:func:`transform_ordered`, :func:`transform`, :func:`zreorder`, the
``zconvolve`` functions, the split-format and in-place forms, ``cfft`` /
``rfft_packed`` and the spectrum and frequency helpers) and on time-major
planes, :func:`transform_ordered_split_tmajor`; FIR filtering by
overlap-save, :mod:`conv` (``FastConv``, ``StreamingConv``, float32 and
float64); the host runtime, :mod:`runtime` (the native planner, the
stream ring buffer and the SDR sample converters, C++ built by g++ on
first use); the polyphase channelizers, float32 and float64, and the
``DDCChain`` downconverter, :mod:`channelizer`; the PFDSP mixers, carriers and CIC, :mod:`dsp`; the
STFT front end, :mod:`spectral`; the rational resampler, :mod:`resample`;
transforms of any length (Bluestein, the CZT and the spectral zoom),
:mod:`bluestein`; N-D transforms, :mod:`nd`; DCT/DST, :mod:`dct`; the
partitioned convolution, :mod:`pconv`; the pffft.hpp ``Fft`` object,
:mod:`wrapper`; measured plan and engine selection, :mod:`tune`
(``tuned_setup``); the distribution layer on ``torch.distributed``,
:mod:`parallel` (mesh sharding, the four-step FFT, the halo-exchange
FastConv, the pencil 2-D FFT); profiling, :mod:`utils`; the numpy FFTPACK
oracle, :mod:`oracle`.  Every kernel is f32; float64 plans run the einsum
stage engine.
"""

import time as _time

_T0 = _time.perf_counter()

from .utils import profiling as _profiling  # noqa: E402

# the package's own import, its first line to its last: setup.seconds.import
_import = _profiling.setup("import", start=_T0)
_import.__enter__()

from . import (bluestein, channelizer, conv, dct, dsp, fft, nd, ops, oracle, parallel, pconv,
               resample, runtime, spectral, tune, utils, wrapper)
from .bluestein import (
    BluesteinPlan,
    CztPlan,
    czt,
    czt_split,
    irfft_any,
    new_setup_any,
    next_smooth_size,
    rfft_any,
    transform_any,
    transform_any_split,
    zoom_fft,
    zoom_fft_setup,
)
from .channelizer import (
    Channelizer,
    ChannelizerState,
    DDCChain,
    DDCState,
    OversampledChannelizer,
    design_lowpass,
    state_from_arrays,
)
from .conv import ConvFlags, FastConv, StreamingConv, fastconv_valid
from .dct import cosqb, cosqf, cost, dct1, dct2, dct3, dst1, dst2, dst3, sinqb, sinqf, sint
from .fft import (
    cfft,
    fftfreq,
    fftshift,
    icfft,
    ifftshift,
    irfft_packed,
    rfft_packed,
    rfftfreq,
    spectrum_pack,
    spectrum_unpack,
    transform,
    transform_ordered,
    transform_ordered_split,
    transform_ordered_split_inplace,
    transform_ordered_split_tmajor,
    transform_split,
    transform_split_inplace,
    zconvolve_accumulate,
    zconvolve_no_accu,
    zconvolve_split,
    zreorder,
)
from .nd import NdPlan, fft2, fftn, fftn_setup, fftn_split, ifft2, ifftn, irfftn, rfftn
from .pconv import PartitionedConv
from .plan import (
    BACKWARD,
    COMPLEX,
    FORWARD,
    REAL,
    Direction,
    Plan,
    StageTables,
    TransformKind,
    decompose_smooth,
    is_power_of_two,
    is_valid_size,
    load_plan,
    min_fft_size,
    nearest_transform_size,
    new_setup,
    next_power_of_two,
    plan_factors,
    plan_from_reference,
    save_plan,
    simd_arch,
    simd_size,
)
from .tune import tuned_setup
from .wrapper import Fft

__version__ = "0.3.0"

__all__ = [
    "bluestein",
    "channelizer",
    "conv",
    "dct",
    "dsp",
    "fft",
    "nd",
    "ops",
    "oracle",
    "parallel",
    "pconv",
    "resample",
    "runtime",
    "spectral",
    "tune",
    "tuned_setup",
    "utils",
    "wrapper",
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
    "Channelizer",
    "ChannelizerState",
    "DDCChain",
    "DDCState",
    "OversampledChannelizer",
    "design_lowpass",
    "state_from_arrays",
    "ConvFlags",
    "FastConv",
    "StreamingConv",
    "fastconv_valid",
    "BACKWARD",
    "COMPLEX",
    "FORWARD",
    "REAL",
    "Direction",
    "Plan",
    "StageTables",
    "TransformKind",
    "decompose_smooth",
    "is_power_of_two",
    "is_valid_size",
    "load_plan",
    "min_fft_size",
    "nearest_transform_size",
    "new_setup",
    "next_power_of_two",
    "plan_factors",
    "plan_from_reference",
    "save_plan",
    "simd_size",
    "simd_arch",
    "BluesteinPlan",
    "new_setup_any",
    "next_smooth_size",
    "transform_any",
    "transform_any_split",
    "rfft_any",
    "irfft_any",
    "CztPlan",
    "czt",
    "czt_split",
    "zoom_fft",
    "zoom_fft_setup",
    "NdPlan",
    "fftn_setup",
    "fftn_split",
    "fftn",
    "ifftn",
    "fft2",
    "ifft2",
    "rfftn",
    "irfftn",
    "dct1",
    "dst1",
    "dct2",
    "dct3",
    "dst2",
    "dst3",
    "cost",
    "sint",
    "cosqb",
    "cosqf",
    "sinqb",
    "sinqf",
    "PartitionedConv",
    "Fft",
    "__version__",
]

_import.__exit__(None, None, None)
del _import, _T0, _time
