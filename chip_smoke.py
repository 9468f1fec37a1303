#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA GPU and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):
  1. environment: CUDA, compute capability, nvcc, triton, card and power limit;
  2. build: nvcc compiles pffft_tpu_torch/csrc/*.cu (sm_90a), in parallel;
  3. each kernel against its plain version on the card, at the shapes the
     main paths give it and at small, non-power-of-two and ragged ones (B1
     at its planner's launch shape and at every shape of its sweep; B3 in
     both directions, its backward as the pair and as the real signal, at
     every shape of its sweep and on buffers 4 bytes off; B7's column map
     and its stream map, with misaligned rows and ragged tails);
  4. the complex main path, ``transform_ordered_split_tmajor`` at the bench
     band shapes (64 MB per plane), forward and backward, checked against a
     complex128 oracle, the unscaled round trip and the 140 dB carrier
     bound; launch counters show which kernels served it;
  5. the real main path, the same entry point on REAL plans at the real band
     shapes (a 64 MB [N, B] signal), checked the same way against a
     complex128 ``torch.fft.rfft``; the launch counts of each shape must
     match its route (the fused real kernel, or the packed chain + combine
     + split kernel; phase 15 checks that the fused route's backward runs
     no interleave copy);
  6. FIR filtering by overlap-save: ``FastConv.apply_batched`` on a
     16-channel real stream [16, 2^22] (256 MB) with 64-, 1024- and
     4096-tap lowpass filters (the fused conv kernel's stream map at nfft
     128 and 2048, the composed kern2 route at 8192), CPLX_INP_OUT, CPLX_SINGLE_FFT and
     CORRELATION runs, each against a complex128 FFT convolution on
     sampled channels, and a ``StreamingConv`` run in odd-sized chunks
     against the one-shot output; launch counts per route; the stream
     map on [16, 2^22] sliced from a ring buffer's rows at F = 1024 and
     4096, read in place and bit-equal to the contiguous call, both timed;
  7. the polyphase channelizer at (M, P, batch, frames) = (4096, 8, 4,
     1024) and (1024, 8, 16, 1024) (64 MB per plane): ``process_split``
     and ``process_split_tmajor`` over two steps with the state carried,
     against a float64 polyphase and a complex128 inverse DFT, two chunks
     against one of twice the length, and one ``OversampledChannelizer``
     (V = 2) step; launch counts per step (one polyphase launch for both
     planes, one per residue when oversampled);
  8. the batch-major complex path: ``transform_ordered_split`` and the
     complex64 ``transform_ordered`` on [B, N] rows at the band shapes,
     forward and backward, against a complex128 ``torch.fft.fft(dim=-1)``,
     the unscaled round trip and the 140 dB carrier; ``transform`` +
     ``zreorder`` against the ordered call; launch counts per route (the
     fused two-stage kernel for N <= 16384, the chain / kern2 above);
  9. the batch-major real path: ``rfft_packed`` / ``irfft_packed`` and
     ``transform_ordered_split`` on REAL plans at the real band shapes as
     [B, N] signals, against a complex128 ``torch.fft.rfft``; the
     batch-major split kernel once per call and direction;
 10. B10, the in-kernel ksplit run by a thread-block cluster, through its
     entry point ``dispatch.cfft_ksplit2_tmajor`` (no route picks it) at the
     five time-major band shapes N = 4096 .. 65536 (64 MB per plane),
     forward and backward, against a complex128 ``torch.fft.fft(dim=0)``,
     the unscaled round trip and the 140 dB carrier; two launches per shape;
 11. float64 plans, complex and real, time-major and batch-major, at (N, B)
     = (4096, 2048) and (65536, 128) (64 MB per f64 plane) against complex128
     ``torch.fft``, the 215 dB carrier, one float64 FastConv run; no f32
     kernel may launch;
 12. the PFDSP chain (BASELINE.json config #4): ``mixer_apply_split`` at
     2^22 samples and on a [16, 2^22] stream through one NCO, against the
     float64 carrier of the exact fixed-point phase; ``CicDDC`` at 2^22 and
     2^24 samples for R = 16 and 64, two chunks with the state carried,
     against a float64 FFT convolution of the mixed stream with the triple
     boxcar at stride R; ``DDCChain`` on two chunks of 2^24 complex samples
     at 129 and 1024 taps (decim 8) and one float64 chunk, against a
     complex128 FFT convolution of the float64-mixed stream, one
     ``zconv_stream`` launch a float32 chunk; the ALGO C/E/I wrappers and
     the carriers at 2^14 against the port's CPU result; the CIC's and the
     resampler's products in full fp32 (the matmul precision checked);
 13. the STFT front end and the resampler on a [4, 2^22] signal:
     ``stft_split`` by both routes and ``stft_split_tmajor`` at n_fft 1024
     (hop 512) and 8192, against complex128 ``torch.fft.rfft`` of the
     windowed frames; an ``istft`` round trip, ``welch_psd``, and
     ``Resampler(3, 2, 16)`` against a float64 zero-stuff, FFT convolution
     and stride M; launches per call (B3 on the time-major route, B9 and B6
     on the batch-major one and in ``istft``); each call timed beside its
     bound (and the banded products' fp32 operation time), the STFT beside
     ``torch.stft``;
 14. the transforms past the 2/3/5-smooth size contract and long-FIR
     streaming (``anylen``), at the sizes of bench_pipeline's
     bluestein_prime, zoom_czt, fft2 and pconv_fdl: Bluestein at N = 4099
     (B9 at the inner M = 8640) and 12289 (kern2 at M = 25600) both ways,
     ``rfft_any`` at N = 4099 and 4096, ``zoom_fft`` / ``czt_split``, 2-D
     ``fftn_split`` on [64, 512, 512], ``dct2`` / ``dct3`` on [4096, 4096],
     ``dct1`` / ``dst1`` at N = 4097 / 4095, ``PartitionedConv`` at 48000
     and 4096 taps (B = 512, 8 channels, two calls with the state carried)
     and the ``Fft`` object, each path driven with the counts at 0, its
     kernels asserted, and held to a complex128 / float64 oracle (the
     direct sums and matrix products on 64 sampled rows); one float64 case
     per module; then each call timed beside its bytes bound, the PyTorch
     yardstick and its parts;
 15. timing with CUDA events (median of 10 after warm-up), per band shape,
     per kernel and per FIR pipeline, beside the bound, the plain version
     and a library yardstick (torch.fft, conv1d); B1's launch-shape sweep
     (batch columns x values a thread, as kern2's pass A too), B4's (the
     packed chain, at real N = 8192 and 131072), B3's (``real_fused_sweep``,
     at real N = 2048 and 4096, both directions) and B7's column-map sweep;
     B8's stream map beside ``conv1d(groups=M)`` and the time-major copy,
     and its tile sweep; FastConv's stream map beside the composition of
     copies around the column map it replaces; B10 beside kern2 on the
     same planes, with sweeps of its batch columns and cluster size; blocks
     per SM of B1, B3, B9 and B10 from the planner and from the card;
 16. the SDR capture path (``capture``): 4 channels x 2^23 complex samples,
     seeded noise and two tones quantized to cs16 by the port's
     ``runtime.convert_planar_f32_cs16``, converted back by the native
     ``convert_cs16_planar_f32``, moved to the card and channelized by
     ``Channelizer(4096, 8)`` in two chunks (B8 + kern2); cu8 at [16, 2^20]
     through ``convert_cu8_planar_f32`` into ``OversampledChannelizer(1024,
     2, 8)`` (B8 from offsets 0 and H, then B1); each against the float64
     polyphase / complex128-DFT oracle, two chunks against one, the tones in
     their channels; one float64 step of each channelizer (no f32 kernel,
     1e-12 of the oracle); ``StreamingConv`` at 1024 taps on the native ring
     buffer over 2^22 samples in seeded chunks of 1 .. 2^17 (B7's column
     map) against a float64 convolution; then the converters' GB/s, the
     framer's push + frames() native against its numpy arm, the whole
     capture step against the channelizer step alone, and float64 steps
     against float32 ones;
 17. the oracle phase (run after phase 3): the public transforms at small
     shapes (complex time-major at N = 1024 and 4096 on 16 columns, both
     directions, real at N = 2048, batch-major rows at N = 4096) against the
     port's numpy FFTPACK oracle (``pffft_tpu_torch.oracle``, the reference
     bench's --validate);
 18. the distribution layer (``parallel``, after phase 16) on a world of one
     NCCL rank built here: ``FourStepPlan`` complex at N = 2^24 (4096 x
     4096) on a batch of 2, ordered and internal with ``reorder``, the real
     four-step at 2^25, ``Pencil2D((4096, 4096))`` on [4, 4096, 4096] in both
     layouts, ``sharded_fastconv_valid`` at 1024 taps on [16, 2^22] against
     the local FastConv; each path from zero counts (kern2, B9, B7's stream
     map), held to complex128 ``torch.fft``, timed beside its bound and
     ``torch.fft``; then each path's gradient (the four-step, the real
     four-step, the pencil in both layouts, the sharded FastConv) against
     torch autograd through the plain versions (2e-6) and complex128
     autograd (1e-5), its backward's launches (no plain version) and its
     ms, device-busy ms and host enqueue µs beside the forward's bytes
     bound; phase 3 holds each kernel shape these paths give;
 19. measure mode (``tune``, after every timed phase; it empties the tables
     it fills): ``tune_engine`` at the band shapes time-major and at three
     batch-major shapes (each engine's median, the winner, the default
     route, and one public call after recording that must launch the
     winner's kernels; phase 3 holds every engine's kernel shapes at each
     of these shapes, whichever wins), ``tuned_setup`` at complex N = 1024,
     4096, 65536, real N = 8192 (one kernel route for every candidate:
     nothing timed) and complex float64 N = 4096 (the stage engine: the
     candidates race), each candidate's factors, route and time;
 20. the gradients (``phase_grad``, before measure mode): the transforms at
     (2048, 8192), (65536, 256) time-major and (4096, 4096) batch-major,
     complex and real ((2048, 8192), (131072, 128), batch-major (2048,
     4096)), both directions; FastConv on [16, 2^22] at 1024 and 4096 taps;
     a StreamingConv push of 2^22 samples; a channelizer step at (4096, 8,
     4, 1024) with gradients for the chunk and the history; an
     ``OversampledChannelizer(1024, 2, 8)`` step; ``DDCChain`` on 2^24
     samples; ``stft_split`` on [4, 2^22]: each gradient within 2e-6 of torch
     autograd through the plain versions on the card, the dot-product test
     within 1e-5, the transforms and the STFT within 1e-5 of complex128
     ``torch.fft`` autograd, the backward's launches (no plain version may
     run), forward and backward ms (CUDA events, device-busy time from the
     profiler, host enqueue time) beside the bytes bound and
     ``torch.fft``'s own backward; then three steps of gradient descent on
     [4, 2^22] toward a target magnitude spectrogram, the loss falling at
     each; phase 3 holds every kernel at the shapes the backward hands it;
 21. ``torch.func.vmap`` over the public calls (``vmap``, after phase 20),
     at BASELINE.json config #3's and #5's widths: ``FastConv.apply_batched``
     over [4, 4, 2^22] at 1024 taps (B7's stream map) and 4096 (the
     composed kern2 route), StreamingConv's block step over the frames of 4
     streams (B7's column map), ``Channelizer(4096, 8)`` over 4 streams of
     4096 x 1024 samples and ``OversampledChannelizer(1024, 2, 8)`` over
     [16, 2^20], each stream with its own state, ``DDCChain`` at 129 taps
     and ``CicDDC(16)`` over 4 x 2^22; ``vmap(grad(...))`` of FastConv at
     1024 taps on [4, 4, 2^20] and of the channelizer step (B8's identity
     maps): each against the loop of unbatched calls (2e-6), each kernel
     launched as often as by one unbatched call, the vmapped call's ms and
     host enqueue us beside the loop's and the batched call's; phase 3
     holds B7 at the folded calls' shapes;
 22. the ``kernels`` line, the card line, and the final ``ok`` line (the done
     line before them gives each phase's seconds).

Needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda), g++ (the
host runtime) and the repository checkout.  It imports neither jax nor pffft_tpu.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import pffft_tpu_torch as pt
from pffft_tpu_torch import channelizer as CH
from pffft_tpu_torch import conv as C
from pffft_tpu_torch import oracle as OR
from pffft_tpu_torch import parallel as PP
from pffft_tpu_torch import runtime as RT
from pffft_tpu_torch import tune as TU
from pffft_tpu_torch.ops import _build
from pffft_tpu_torch.ops import _grad
from pffft_tpu_torch.ops import conv_kernel as ck
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import fused_stage as fs
from pffft_tpu_torch.ops import pallas_fft as pk
from pffft_tpu_torch.ops import pfb_kernel as pfb
from pffft_tpu_torch.ops import real_kernel as rk
from pffft_tpu_torch.ops import split as S
from pffft_tpu_torch.utils import profiling as P

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
            pk.rfft_bwd_chain_tmajor_fused, pk.real_split_tmajor, ck.zconv_tmajor,
            ck.zconv_stream, pfb.pfb_fir, pfb.pfb_fir_stream_tmajor, fs.cfft_fused2, rk.real_split,
            D.cfft_ksplit2_tmajor)
# the fused two-stage kernel on two-stage plans (N, max_factor)
FUSED2_PLANS = ((1024, 32), (1536, 48), (2400, 64), (4096, 64))
# FastConv: a 16-channel real stream of 2^22 samples (256 MB), filtered by
# design_lowpass(F, 0.1) at F = 64, 1024 and 4096 (nfft 128, 2048, 8192)
CONV_ROWS, CONV_LEN, CONV_TAPS = 16, 1 << 22, (64, 1024, 4096)
# the benchmark's chunk: [16, 2^22] at an odd column offset of a ring
# buffer [16, 2^24 + 2^22 + 8192], read in place, at F = 1024 and 4096
RING_LEN, RING_OFFSET, RING_TAPS = (1 << 24) + (1 << 22) + 8192, 1001, (1024, 4096)
# the flag runs: [4, 2^20] complex64 streams at F = 1024
FLAG_ROWS, FLAG_LEN, FLAG_TAPS = 4, 1 << 20, 1024
# the channelizer: (M, P, batch, frames per step), 64 MB per plane per step
CHAN_CONFIGS = ((4096, 8, 4, 1024), (1024, 8, 16, 1024))
# B10 at the time-major band shapes, with the default conf (2048, N/2048)
KSPLIT2_BAND = ((4096, 4096), (8192, 2048), (16384, 1024), (32768, 512), (65536, 256))
# B10's launch-shape sweeps, (N, conf, tb, cluster): batch columns at (8192,
# 2048); cluster 16 (tb = 8) against 8 (tb = 4, two slabs a block) at N =
# 32768; the splits (2048, 32) and (4096, 16) at N = 65536; the split
# (1024, N/1024) with one slab of 8 columns a block (two blocks per SM)
KSPLIT2_SWEEP = ((8192, None, 4, None), (8192, None, 4, 4), (8192, None, 2, 4),
                 (32768, None, 4, 8), (65536, (4096, 16), None, None),
                 (4096, (1024, 4), 8, 4), (8192, (1024, 8), 8, 8),
                 (16384, (1024, 16), 8, 16))
# B1's launch-shape sweep, (N, B, conf): the two chain band shapes and kern2's
# pass A at (4096, 4096) and (65536, 256) (the chain on [2048, r*B]), at
# batch columns x values a thread (tb = 16 only where N <= 1024)
CHAIN_SWEEP = ((1024, 16384, None), (2048, 8192, None), (4096, 4096, (2048, 2)),
               (65536, 256, (2048, 32)))
CHAIN_SWEEP_SHAPES = ((16, 32), (8, 32), (8, 16), (4, 32), (4, 16))
# B8's stream-map block sizes: warps a block (32 frames a thread each)
PFB_SWEEP = (4, 1, 2, 8)
# B7's column map at FastConv's nfft = 2048 column count, (tb, values a thread)
CONV_SWEEP_SHAPES = ((4, 16), (8, 32), (4, 32))
# float64 plans: (N, B), a 64 MB float64 plane
F64_SHAPES = ((4096, 2048), (65536, 128))
F64_TOL = 1e-12      # vs the complex128 oracle, relative to max|oracle|
F64_CARRIER_DB = 215.0
# the dsp phase (BASELINE.json config #4): bench_pipeline's mixer_shift and
# cic_ddc (benchmarks/bench_pipeline.py:71-136), a 16-channel stream [16,
# 2^22] through one NCO, the DDC chain of examples/example_sdr_capture_chain.py:50-52
# on two chunks of 2^24 complex samples (and at 1024 taps), the ALGO C/E/I
# wrappers and the carriers at 2^14
MIX_N, MIX_CHANNELS, MIX_RATE = 1 << 22, 16, 0.123
CIC_NS, CIC_FACTORS = (1 << 22, 1 << 24), (16, 64)
DDC_N, DDC_DECIM, DDC_TAPS, DDC_RATE = 1 << 24, 8, (129, 1024), -0.1
ALGO_N = 1 << 14
MIXER_TOL = 2e-6     # vs the float64 carrier of the exact fixed-point phase
# the spectral phase: bench_pipeline's stft (:181-222) at a 64 MB input, one
# n_fft = 8192 case, and its resample_3_2 (:224-240) on the same signal
STFT_SHAPE, STFT_NFFT, STFT_HOP, STFT_BIG_NFFT = (4, 1 << 22), 1024, 512, 8192
RESAMPLE_UP, RESAMPLE_DOWN, RESAMPLE_TAPS = 3, 2, 16
# the anylen phase, at the full sizes of benchmarks/bench_pipeline.py:247-343
# (bluestein_prime, zoom_czt, fft2, pconv_fdl; 64 MB per f32 plane) and
# BASELINE.json config #1's N for the Fft object: Bluestein at a prime N
# (inner M 8640 on B9) and at N = 12289 (M 25600 = 1600 * 16 on kern2),
# rfft_any, the zoom (inner 4608 on B9), fftn_split on [64, 512, 512],
# DCT/DST (B9 at 4096 and 8192), PartitionedConv at 48000 taps (P = 94)
# and 4096 (P = 8), Fft real and complex
BS_N, BS_B = 4099, 4092
BS_TMAJOR_N, BS_TMAJOR_B = 12289, 1024
BS_M_SWEEP = (8640, 9216, 10240, 12288, 16384)   # smooth M >= 2*4099 - 1 on B9
RFFT_ANY_NS, RFFT_ANY_B = (4099, 4096), 4092
ZOOM_N, ZOOM_M, ZOOM_F, ZOOM_B = 4096, 512, (0.2, 0.3), 4096
FFT2_SHAPE = (64, 512, 512)
DCT_SHAPE = (4096, 4096)
DCT1_N, DST1_N, DCT_I_B = 4097, 4095, 2048
PCONV_TAPS, PCONV_BLOCK, PCONV_CH, PCONV_BLOCKS = (48000, 4096), 512, 8, 256
FFT_REAL_N, FFT_REAL_B = 1024, 16384
FFT_CPLX_N, FFT_CPLX_B = 4096, 4096
ORACLE_ROWS = 64     # rows of the direct-sum and matrix oracles
# the capture phase: BASELINE.json's channelizer stream (config #5) and
# streamed real blocks through pffastconv (config #3) fed from a radio, at
# CHAN_CONFIGS' full sizes: cs16 at 4 channels x 2^23 complex samples into
# Channelizer(4096, 8) in two chunks of 2^22; cu8 at [16, 2^20] into
# OversampledChannelizer(1024, 2, 8); one float64 step of each at [4,
# 2^22] and [16, 2^20]; StreamingConv at 1024 taps over 2^22 samples pushed
# in seeded chunks of 1 .. 2^17 samples
CAP_CS16_SHAPE, CAP_CU8_SHAPE, CAP_F64_SHAPE = (4, 1 << 23), (16, 1 << 20), (4, 1 << 22)
CAP_CHANNELIZERS = ((CAP_CS16_SHAPE, 4096, 1), (CAP_CU8_SHAPE, 1024, 2))  # (shape, M, V)
CAP_TAPS_PER_PHASE = 8
CAP_TONES = {4096: ((1000, 0.25), (3000, 0.2)), 1024: ((100, 0.25), (700, 0.2))}
CAP_NOISE = 0.05     # noise rms per plane, of full scale
CAP_TONE_TOL = 0.02  # a tone's mean channel magnitude within 2% of its amplitude
CAP_STREAM_N, CAP_STREAM_TAPS, CAP_CHUNK_MAX = 1 << 22, 1024, 1 << 17
CAP_FRAMER_N, CAP_FRAMER_REPS = 1 << 16, 64
# the oracle phase: the card's outputs at small shapes against the port's
# numpy FFTPACK oracle (the reference bench's --validate): complex
# time-major N on ORACLE_B columns, real time-major, batch-major rows
ORACLE_CPLX_NS, ORACLE_REAL_N, ORACLE_BMAJOR_N, ORACLE_B = (1024, 4096), 2048, 4096, 16
# the distribution layer on a world of one NCCL rank (BASELINE.json config
# #5's axis): the four-step at N = 2^24 (4096 x 4096) on a batch of 2, the
# real four-step at 2^25, Pencil2D on [4, 4096, 4096], the sharded FastConv
# at 1024 taps on CONV_ROWS x CONV_LEN
FOURSTEP_N, FOURSTEP_REAL_N, FOURSTEP_B = 1 << 24, 1 << 25, 2
PENCIL_SHAPE, PENCIL_B = (4096, 4096), 4
SHARDED_CONV_TAPS = 1024
# torch.func.vmap over V streams at the full widths: FastConv over [V, 4,
# 2^22] at 1024 and 4096 taps (config #3's rows as 4 x 4), the
# channelizers over CHAN_CONFIGS' streams (config #5), DDCChain and the CIC
# over V x 2^22, vmap(grad) of FastConv over [V, 4, 2^20]
VMAP_V = 4
VMAP_CONV_TAPS, VMAP_CONV_LEN, VMAP_GRAD_LEN = (1024, 4096), 1 << 22, 1 << 20
VMAP_DSP_N, VMAP_CIC_FACTOR = 1 << 22, 16
# measure mode: tune_engine at the time-major BAND shapes and at these
# batch-major (N, B); tuned_setup at these (N, kind, dtype)
TUNE_BMAJOR = ((4096, 4096), (16384, 256), (65536, 64))
TUNE_SETUPS = ((1024, "complex", "float32"), (4096, "complex", "float32"),
               (65536, "complex", "float32"), (8192, "real", "float32"),
               (4096, "complex", "float64"))
TUNE_ITERS, TUNE_ROUNDS = 2, 3
DEV = "cuda"


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


def time_ms(fn, inner: int = 5, warm: int = 3) -> float:
    """ms per call: the median over REPS CUDA-event windows, each around
    ``inner`` back-to-back calls, after ``warm`` calls of warm-up."""

    for _ in range(warm):
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


def device_ms(fn, calls: int = 5) -> float:
    """Device-busy ms per call of ``fn``: the CUDA kernels' and copies' own
    time in a ``torch.profiler`` trace of ``calls`` calls after one warm-up,
    without the host's gaps between them."""

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / calls / 1e3


def enqueue_us(fn, calls: int = 20) -> float:
    """Host µs per call of ``fn`` up to its last launch (no synchronize in
    the window): where it exceeds the device's time, the card waits."""

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


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


@contextlib.contextmanager
def recording(module, name: str):
    """Replace ``module.name`` by a wrapper that records its calls; yields
    the list of calls."""

    calls = []
    fn = getattr(module, name)
    setattr(module, name, lambda *a, **k: (calls.append(1), fn(*a, **k))[1])
    try:
        yield calls
    finally:
        setattr(module, name, fn)


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
        emit({"phase": "build", "source": name, "ptxas": _build.ptxas_report(name)})
    for name in ("chain_packed", "real_fused"):
        spills = {fn: r for fn, r in _build.ptxas_report(name).items()
                  if r.get("spill_stores") or r.get("spill_loads")}
        check(not spills, f"{name}.cu spills: {spills}")
    emit({"phase": "build", "seconds": secs})


def ptxas_of(name: str, kernel: str):
    """Registers and spill bytes ptxas gave the kernel of library ``name``
    whose mangled name holds ``kernel`` (a template instance)."""

    hits = [r for fn, r in _build.ptxas_report(name).items() if kernel in fn]
    return hits[0] if len(hits) == 1 else None


def phase_kernels(gen):
    """Each kernel against its plain version, at the shapes the main path
    gives it and at small, non-power-of-two and ragged ones; returns the
    max abs errors."""

    dev = torch.device("cuda")
    errs = {name: 0.0 for name in ("chain", "combine", "chain_packed", "real_fused",
                                   "real_split", "conv_fused", "pfb_fir", "fused2",
                                   "real_split_bmajor", "ksplit2")}

    def hold(name, kern, plain, case, dirs=(False, True)):
        for bwd in dirs:
            ks, ps = kern(bwd), plain(bwd)
            torch.cuda.synchronize()
            e = max(rel_err(k, p) for k, p in zip(ks, ps, strict=True))
            errs[name] = max(errs[name], *(float((k - p).abs().max()) for k, p in zip(ks, ps)))
            emit({"phase": "kernel", "kernel": name, **case, "backward": bwd,
                  "rel_err": e})
            check(e <= KERNEL_TOL, f"{name} {case} bwd={bwd}: {e}")

    def chain_case(plan, n, b, tb=None, elems=None):
        re, im = planes(n, b, gen)
        hold("chain",
             lambda bwd: pk.cfft_chain_tmajor(plan, re, im, backward=bwd, tb=tb, elems=elems),
             lambda bwd: pk.chain_tmajor_plain(plan, re, im, backward=bwd),
             {"n": n, "b": b, "tb": tb, "elems": elems, "factors": list(plan.factors),
              "tile": pk._core_launch(plan, dev, "chain kernel", tb, elems)._asdict()})

    def combine_case(last, b):
        n = last.l * last.r
        re, im = planes(n, b, gen)
        hold("combine",
             lambda bwd: pk.cfft_combine_tmajor(last, re, im, backward=bwd),
             lambda bwd: pk.combine_tmajor_plain(last, re, im, backward=bwd),
             {"m": last.l, "r": last.r, "b": b})

    def transform_case(n, b):
        # the time-major transform's kernel calls at [N, B]: the chain, or
        # kern2's pass A and combine
        if D.select_engine(pt.new_setup(n), b, True, dev) == "chain":
            chain_case(D._chain_plan(pt.new_setup(n), dev), n, b)
        else:
            m, r = D._kern2_conf(n, dev)
            mplan, last = D._build_ksplit(n, m, r)
            chain_case(mplan, m, r * b)
            combine_case(last, b)

    # the main path's kernel calls, shape for shape
    for n, b in BAND:
        transform_case(n, b)
    # small, non-power-of-two, ragged and odd batches; N=2400 is routed to
    # kern2 (the chain does not cover it), and the kernel still runs it at 4
    # columns; every launch shape of B1's sweep at N = 1024 and 2048
    for n in (96, 160, 640, 1024, 2400, pk.chain_max_n(dev)):
        plan = D._thin_plan(n)
        tb = None if pk.chain_core_tile(plan, dev) else 4
        for b in (1024, 1000, 1001):
            chain_case(plan, n, b, tb)
    for n in (1024, 2048):
        plan = D._thin_plan(n)
        for tb, el in CHAIN_SWEEP_SHAPES:
            if pk.chain_core_tile(plan, dev, tb=tb, elems=el) is not None:
                for b in (4096, 4093):
                    chain_case(plan, n, b, tb, el)
    for r in pk.COMBINE_RADICES:
        for b in (256, 250):
            combine_case(D._build_ksplit(2048 * r, 2048, r)[1], b)

    def packed_case(plan, m, b, slabs, tb=None, elems=None, offset=0):
        # offset: the buffer starts that many floats past an aligned one
        y = planes(1, m * slabs * 2 * b + offset, gen)[0].view(-1)[offset:]
        y = y.view(m, slabs * 2 * b)
        hold("chain_packed",
             lambda bwd: pk.cfft_chain_tmajor_packed(plan, y, slabs=slabs, tb=tb, elems=elems),
             lambda bwd: pk.chain_tmajor_packed_plain(plan, y, slabs=slabs),
             {"n": m, "b": b, "slabs": slabs, "factors": list(plan.factors), "offset": offset,
              "tile": pk._core_launch(plan, dev, "packed chain kernel", tb, elems)._asdict()},
             dirs=(False,))  # a forward-only kernel: the real forward's input

    def fused_case(plan, h, b, tb=None, elems=None, offset=0):
        # the backward writes the real [N, B] signal; offset as for
        # packed_case
        tw = real_tw(h)
        y = planes(1, 2 * h * b + offset, gen)[0].view(-1)[offset:].view(h, 2 * b)
        sr, si = (p.view(-1)[offset:].view(h, b) for p in planes(1, h * b + offset, gen))
        kw = dict(tb=tb, elems=elems)
        case = {"h": h, "b": b, "factors": list(plan.factors), "offset": offset,
                "tile": pk._core_launch(plan, dev, "fused real kernel", tb, elems)._asdict()}
        hold("real_fused",
             lambda bwd: ((pk.rfft_bwd_chain_tmajor_fused(plan, sr, si, tw, **kw),) if bwd
                          else pk.rfft_chain_tmajor_fused(plan, y, tw, **kw)),
             lambda bwd: ((pk.rfft_bwd_chain_tmajor_fused_plain(plan, sr, si, tw),) if bwd
                          else pk.rfft_chain_tmajor_fused_plain(plan, y, tw)),
             case)

    def split_case(h, b):
        tw = real_tw(h)
        zr, zi = planes(h, b, gen)
        hold("real_split",
             lambda bwd: pk.real_split_tmajor(zr, zi, tw, backward=bwd),
             lambda bwd: pk.real_split_tmajor_plain(zr, zi, tw, backward=bwd),
             {"h": h, "b": b})

    def real_tmajor_cases(n, b):
        # the kernels of the time-major real transform of length n on B
        # columns, as its route gives them
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

    # the real path's kernel calls, shape for shape
    for n, b in REAL_BAND:
        real_tmajor_cases(n, b)
    # small and non-power-of-two H, ragged and odd batches (B=1001 takes
    # the scalar loads and stores); B4 with a block's columns across two
    # slabs (B % tb != 0), an odd B and a buffer 4 bytes past an aligned
    # start, at every launch shape of its sweep
    for b in (1000, 1001):
        for h in (96, 960):
            fused_case(D._thin_plan(h), h, b)
            packed_case(D._thin_plan(h), h, b, 1)
        for h in (16, 1920):
            fused_case(D._thin_plan(h), h, b)
            split_case(h, b)
        packed_case(D._thin_plan(2048), 2048, b, 2)
        split_case(2400, b)
    for tb, el in CHAIN_SWEEP_SHAPES:
        if pk.chain_core_tile(D._thin_plan(2048), dev, tb=tb, elems=el) is not None:
            for slabs, b, off in ((1, 1001, 1), (2, 250, 0), (2, 1001, 1), (32, 37, 1)):
                packed_case(D._thin_plan(2048), 2048, b, slabs, tb, el, off)
    # B3 at every launch shape of its sweep (B1's), B % tb != 0, odd B and
    # buffers 4 bytes past an aligned start
    for h in (1024, 2048):
        for tb, el in CHAIN_SWEEP_SHAPES:
            if pk.chain_core_tile(D._thin_plan(h), dev, tb=tb, elems=el) is not None:
                for b, off in ((1001, 1), (7, 0)):
                    fused_case(D._thin_plan(h), h, b, tb, el, off)

    def conv_case(n, b, cplx, conj=False):
        # conj: the conjugate spectrum, as the column map's backward runs it
        plan = D._thin_plan(n)
        re, im = planes(n, b, gen)
        hfr, hfi = filter_spectrum(n, cplx)
        hfi = -hfi if conj else hfi
        hold("conv_fused",
             lambda bwd: ck.zconv_tmajor(plan, re, im, hfr, hfi),
             lambda bwd: ck.zconv_tmajor_plain(plan, re, im, hfr, hfi),
             {"n": n, "b": b, "complex_filter": cplx, "conjugate": conj}, dirs=(False,))

    def stream_case(n, u, x, total, cplx_filter, spectrum=None):
        # spectrum: (hfr, hfi) given, e.g. the reversed taps' of a backward;
        # the plain version on the kernel's own plan (radix 32 at nfft 8192)
        plan = ck.stream_plan(n)
        hfr, hfi = spectrum or filter_spectrum(n, cplx_filter, n - u + 1)
        hold("conv_fused",
             lambda bwd: (ck.zconv_stream(plan, x, hfr, hfi, u, total),),
             lambda bwd: (ck.zconv_stream_plain(plan, x, hfr, hfi, u, total),),
             {"map": "stream", "n": n, "u": u, "shape": list(x.shape), "total": total,
              "complex": x.is_complex(), "complex_filter": cplx_filter,
              "adjoint": spectrum is not None, "factors": list(plan.factors)}, dirs=(False,))

    def adjoint_stream_case(fc, rows, total, cplx_stream):
        # the stream map's backward: the reversed taps' spectrum over the
        # gradient [rows, total] with span - 1 zeros in front, to the forward
        # input's length total + span - 1
        hfr, hfi, span = fc._adjoint(dev)
        g = torch.randn((rows, total), generator=gen, device="cuda")
        if cplx_stream:
            g = torch.complex(g, torch.randn((rows, total), generator=gen, device="cuda"))
        x = torch.nn.functional.pad(g, (span - 1, 0))
        stream_case(fc.nfft, fc.num_out_per_block, x, total + span - 1, fc.cplx_filter,
                    (hfr, hfi))

    def pfb_case(m, p, r, k, maps=("rows", "stream"), offsets=(0,), lead=0, width=None):
        w = torch.randn((p, m), generator=gen, device="cuda")
        if "rows" in maps:
            rows = torch.randn((r, k + p - 1, m), generator=gen, device="cuda")
            hold("pfb_fir", lambda bwd: (pfb.pfb_fir(rows, w, k),),
                 lambda bwd: (pfb.pfb_fir_plain(rows, w, k),),
                 {"map": "rows", "m": m, "p": p, "r": r, "k": k}, dirs=(False,))
        if "stream" in maps:
            hist = planes(r, p * m, gen)
            # chunk rows that are slices of wider rows (``width`` samples,
            # the chunk from ``lead``), as a caller's chunk of a longer
            # stream is: read in place
            width = width or k * m + lead
            x = tuple(t[:, lead:lead + k * m] for t in planes(r, width, gen))
            for off in offsets:
                hold("pfb_fir", lambda bwd: pfb.pfb_fir_stream_tmajor(hist, x, w, k, off),
                     lambda bwd: pfb.pfb_fir_stream_tmajor_plain(hist, x, w, k, off),
                     {"map": "stream", "m": m, "p": p, "r": r, "k": k, "offset": off,
                      "lead": lead, "width": width}, dirs=(False,))

    # the FIR paths' kernel calls, shape for shape: the fused conv kernel's
    # stream map on FastConv's streams (its column map on StreamingConv's
    # frames and at the column count of the [16, 2^22] stream), the
    # polyphase FIR on the channelizer's streams
    xs = torch.randn((CONV_ROWS, CONV_LEN), generator=gen, device="cuda")
    for taps in CONV_TAPS:
        fc = C.FastConv(pt.design_lowpass(taps, 0.1))
        if D.conv_route_mode(fc.nfft, None, dev, stream=True) == "fused":
            stream_case(fc.nfft, fc.num_out_per_block, xs, CONV_LEN - taps + 1, False)
        if D.conv_route_mode(fc.nfft, None, dev) == "fused":
            conv_case(fc.nfft, conv_columns(fc, CONV_ROWS, CONV_LEN), False)
    del xs
    # the stream map on the FIR cells' rows, [16, 2^22 + F - 1] read in place
    # out of a ring buffer's, forward and backward (the reversed taps'
    # spectrum over the gradient) at nfft 2048, 4096 and 8192: the radix-32
    # launch counter counts both launches at 8192 (32*16*16) and none below
    ring = torch.randn((CONV_ROWS, RING_LEN), generator=gen, device="cuda")
    for taps in (1024, 2048, 4096):
        fc = C.FastConv(pt.design_lowpass(taps, 0.1))
        n, r32 = fc.nfft, ck.stream_plan(fc.nfft).factors[0] == 32
        c0, r0 = counts(), P.counters.get(ck.R32_LAUNCHES, 0)
        stream_case(n, fc.num_out_per_block,
                    ring[:, RING_OFFSET:RING_OFFSET + CONV_LEN + taps - 1], CONV_LEN, False)
        adjoint_stream_case(fc, CONV_ROWS, CONV_LEN, False)
        delta, r32_launches = launched(counts(), c0), P.counters.get(ck.R32_LAUNCHES, 0) - r0
        emit({"phase": "kernel", "kernel": "conv_fused", "map": "stream", "n": n,
              "taps": taps, "launches": delta, "r32_launches": r32_launches})
        check(delta == {"zconv_stream": 2} and r32 == (n == 8192)
              and r32_launches == (2 if r32 else 0),
              f"stream map at nfft {n}: launches {delta}, radix-32 launches {r32_launches}")
    del ring
    # the stream map's flag runs: a complex stream (complex filter), rows
    # that start unaligned (L odd), a ragged tail (total short of a frame),
    # R = 1 and 3, an odd number of frames in real mode
    for n, u, rows, length, cplx in ((2048, 1025, 3, 40001, False), (2048, 1025, 3, 40001, True),
                                     (128, 65, 1, 10007, False), (128, 65, 3, 5003, True),
                                     (480, 200, 3, 2880, False)):
        x = torch.randn((rows, length), generator=gen, device="cuda")
        if cplx:
            x = torch.complex(x, torch.randn((rows, length), generator=gen, device="cuda"))
        for total in (length - (n - u), length - (n - u) - 7):
            stream_case(n, u, x, total, cplx)
    # (the oversampled step reads the second configuration from offset H)
    for (m, p, batch, frames), offs in zip(CHAN_CONFIGS, ((0,), (0, CHAN_CONFIGS[1][0] // 2))):
        pfb_case(m, p, batch, frames, ("stream",), offs)
    pfb_case(4096, 8, 4, 1024, ("rows",))
    # the capture path's channelizer steps, shape for shape: B8 on the
    # chunks read in place from the stream's rows, at every residue's offset,
    # then the transform over the phases on batch x frames columns
    for m, v, b, k, lead, width in capture_channelizer_steps():
        pfb_case(m, CAP_TAPS_PER_PHASE, b, k, ("stream",), tuple(r * m // v for r in range(v)),
                 lead, width)
    for m, b in sorted({(m, b * k) for m, _, b, k, _, _ in capture_channelizer_steps()}):
        transform_case(m, b)
    # and its StreamingConv: the column map at every column count its
    # seeded pushes give
    fc = C.FastConv(pt.design_lowpass(CAP_STREAM_TAPS, 0.1))
    for cols in sorted(set(capture_launch_columns(fc.nfft, fc.num_out_per_block))):
        conv_case(fc.nfft, cols, False)
    # small, non-power-of-two nfft; ragged and odd column counts (scalar
    # loads); real and complex filters
    for n in (64, 128, 480, 2048):
        for b in (1024, 1000, 1001):
            for cplx in (False, True):
                conv_case(n, b, cplx)
    # the polyphase FIR at M not a multiple of the phase tile, P = 33 (the
    # plain loop), K < P, offsets 0 and H, sliced chunk rows
    for m in (64, 1000, 4096):
        for p in (1, 4, 8, 33):
            pfb_case(m, p, 3, 70, offsets=(0, m // 2))
    pfb_case(1000, 8, 3, 3, ("stream",), (0, 500))
    pfb_case(4096, 8, 4, 100, ("stream",), (0, 2048), lead=3)
    # the shapes phase_grad's backward hands the FIR kernels: B7's stream map
    # with the reversed taps' spectrum (FastConv at F = 1024 on [16, 2^22],
    # DDCChain's [I; Q] rows at 129 taps, a complex filter's conjugated taps
    # on a complex stream), its column map with the conjugate spectrum at a
    # StreamingConv push's column count, B8's identity maps on the gradient
    # rows of both planes padded to K + 2P - 2 frames (the channelizer step
    # and the oversampled step)
    fc = C.FastConv(pt.design_lowpass(GRAD_CONV_TAPS[0], 0.1))
    if D.conv_route_mode(fc.nfft, None, dev, stream=True) == "fused":
        adjoint_stream_case(fc, CONV_ROWS, CONV_LEN - fc.filter_len + 1, False)
    if D.conv_route_mode(fc.nfft, None, dev) == "fused":
        frames = (GRAD_PUSH - fc.nfft) // fc.num_out_per_block + 1
        conv_case(fc.nfft, -(-(-(-frames // 2)) // 4) * 4, False, conj=True)
    fc = CH.DDCChain(DDC_RATE, pt.design_lowpass(DDC_TAPS[0], 0.5 / DDC_DECIM), DDC_DECIM).conv
    adjoint_stream_case(fc, 2, DDC_N, False)
    h = pt.design_lowpass(65, 0.1) * np.exp(2j * np.pi * 0.05 * np.arange(65))
    adjoint_stream_case(C.FastConv(h, flags=C.ConvFlags.CPLX_INP_OUT | C.ConvFlags.CPLX_FILTER),
                        3, 5001, True)
    del fc
    for m, p, batch, frames in (CHAN_CONFIGS[0], (GRAD_OVERSAMPLED[0], GRAD_OVERSAMPLED[2],
                                                   *CHAN_CONFIGS[1][2:])):
        pfb_case(m, p, 2 * batch, frames + p - 1, ("rows",))

    def fused2_case(plan, n, b, orders=(True, False)):
        re, im = planes(b, n, gen)  # batch-major rows [B, N]
        for ordered in orders:
            hold("fused2",
                 lambda bwd: fs.cfft_fused2(plan, re, im, backward=bwd, ordered=ordered),
                 lambda bwd: fs.cfft_fused2_plain(plan, re, im, backward=bwd,
                                                  ordered=ordered),
                 {"n": n, "b": b, "ordered": ordered, "factors": list(plan.factors),
                  "tile": fs.fused2_tile(n, dev)._asdict()})

    def split_b_case(h, b):
        tw = real_tw(h)
        zr, zi = planes(b, h, gen)
        hold("real_split_bmajor",
             lambda bwd: rk.real_split(zr, zi, tw, backward=bwd),
             lambda bwd: rk.real_split_plain(zr, zi, tw, backward=bwd),
             {"h": h, "b": b})

    # the batch-major paths' kernel calls, shape for shape: B9 ordered on
    # each band plan it covers (a real plan's at its length N/2), B9's
    # internal-order store on the two-stage plan of the internal-order run,
    # B6 on every real shape
    for n, b in BAND:
        plan = pt.new_setup(n)
        if D.select_engine(plan, b, False, dev) == "fused2":
            fused2_case(plan, n, b, (True,))
    fused2_case(pt.new_setup(4096, max_factor=64), 4096, 4096, (False,))
    for n, b in REAL_BAND:
        plan = pt.new_setup(n, pt.REAL)
        if D.select_engine(plan, b, False, dev) == "fused2":
            fused2_case(plan, n // 2, b, (True,))
        split_b_case(n // 2, b)
    # two-stage plans in both output orders, a ragged last tile (B=13) and
    # an odd batch; small and non-power-of-two H at odd batches
    for n, mf in FUSED2_PLANS:
        for b in (13, 1001):
            fused2_case(pt.new_setup(n, max_factor=mf), n, b)
    for h in (16, 48, 4096, 3 << 14):
        for b in (33, 1001):
            split_b_case(h, b)
    def ksplit2_case(n, b, conf=None):
        plan = pt.new_setup(n, strict=False)
        mplan, last = D._build_ksplit(n, *(conf or (2048, n // 2048)))
        re, im = planes(n, b, gen)
        hold("ksplit2",
             lambda bwd: D.cfft_ksplit2_tmajor(plan, re, im, backward=bwd, conf=conf),
             lambda bwd: D.ksplit2_tmajor_plain(mplan, last, re, im, backward=bwd),
             {"n": n, "b": b, "m": mplan.engine_n, "r": last.r,
              "tile": D.ksplit2_tile(mplan, last.r, dev)._asdict()})

    # B10 at the shapes its phase gives it, and at small, non-power-of-two
    # and radix-16/32 splits with ragged and odd batches (scalar loads)
    for n, b in KSPLIT2_BAND:
        ksplit2_case(n, b)
    for n, conf in ((640, (128, 5)), (384, (128, 3)), (2048, (128, 16)), (4096, (128, 32))):
        for b in (1024, 1000, 1001):
            ksplit2_case(n, b, conf)
    # the dsp and spectral paths' kernel calls, shape for shape: B7's stream
    # map on DDCChain's [I; Q] rows, the STFT's real transforms on its rows*K
    # frames time-major (B3, or B4, B1, B2 and B5 past n_fft 4096) and
    # batch-major (B9 and B6, both directions as istft runs them)
    for taps in DDC_TAPS:
        fc = CH.DDCChain(DDC_RATE, pt.design_lowpass(taps, 0.5 / DDC_DECIM), DDC_DECIM).conv
        if D.conv_route_mode(fc.nfft, None, dev, stream=True) == "fused":
            xs = torch.randn((2, DDC_N + taps - 1), generator=gen, device="cuda")
            stream_case(fc.nfft, fc.num_out_per_block, xs, DDC_N, False)
            del xs
    rows, length = STFT_SHAPE
    for n_fft in (STFT_NFFT, STFT_BIG_NFFT):
        hop = STFT_HOP if n_fft == STFT_NFFT else n_fft // 2
        b = rows * ((length - n_fft) // hop + 1)
        real_tmajor_cases(n_fft, b)
        plan = pt.new_setup(n_fft, pt.REAL)
        if D.select_engine(plan, b, False, dev) == "fused2":
            fused2_case(plan, n_fft // 2, b, (True,))
        split_b_case(n_fft // 2, b)
    # the anylen paths' kernel calls, shape for shape: B9 ordered at their
    # row lengths (Bluestein's and the zoom's inner M, fftn_split's rows, the
    # DCTs' inner lengths, the real H of rfft_any, PartitionedConv and Fft,
    # Fft's complex rows), B6 at the real H, and kern2's chain and combine at
    # Bluestein's inner M = 25600
    for n, b in ((pt.new_setup_any(BS_N).m, BS_B),
                 (pt.zoom_fft_setup(ZOOM_N, ZOOM_F, ZOOM_M).m, ZOOM_B),
                 (FFT2_SHAPE[-1], FFT2_SHAPE[0] * FFT2_SHAPE[1]), (DCT_SHAPE[1], DCT_SHAPE[0]),
                 (2 * (DCT1_N - 1), DCT_I_B), (FFT_CPLX_N, FFT_CPLX_B)):
        fused2_case(pt.new_setup(n, strict=False), n, b, (True,))
    for h, b in ((RFFT_ANY_NS[1] // 2, RFFT_ANY_B), (PCONV_BLOCK, PCONV_CH * PCONV_BLOCKS),
                 (FFT_REAL_N // 2, FFT_REAL_B)):
        fused2_case(pt.new_setup(h, strict=False), h, b, (True,))
        split_b_case(h, b)
    m = pt.new_setup_any(BS_TMAJOR_N).m
    km, kr = D._kern2_conf(m, dev)
    mplan, last = D._build_ksplit(m, km, kr)
    chain_case(mplan, km, kr * BS_TMAJOR_B)
    combine_case(last, BS_TMAJOR_B)
    # the distribution layer's kernel calls, shape for shape: the columns
    # (time-major, kern2 at 4096) and rows (batch-major, B9) of the four-step
    # (the real four-step's engine is the complex one's) and of the pencil,
    # and B7's stream map on the sharded FastConv's rows and halo
    for col_n, col_b, row_n, row_b in parallel_shapes():
        transform_case(col_n, col_b)
        plan = pt.new_setup(row_n, strict=False)
        if D.select_engine(plan, row_b, False, dev) == "fused2":
            fused2_case(plan, row_n, row_b, (True,))
    fc = C.FastConv(pt.design_lowpass(SHARDED_CONV_TAPS, 0.1))
    if D.conv_route_mode(fc.nfft, None, dev, stream=True) == "fused":
        xs = torch.randn((CONV_ROWS, CONV_LEN + fc.filter_len - 1), generator=gen,
                         device="cuda")
        stream_case(fc.nfft, fc.num_out_per_block, xs, CONV_LEN, False)
        del xs
        # its backward at one rank: the reversed taps over the local
        # output's gradient, to the rows and halo's length
        adjoint_stream_case(fc, CONV_ROWS, CONV_LEN, False)
    # the shapes phase_vmap's folded calls hand B7 (B8's folded calls take
    # the channelizer phase's rows and phase_grad's identity-map rows):
    # FastConv's vmap(grad) rows [4V, 2^20] both ways, StreamingConv's
    # frames of V streams as columns, DDCChain's [I; Q] rows of V streams
    fc = C.FastConv(pt.design_lowpass(VMAP_CONV_TAPS[0], 0.1))
    if D.conv_route_mode(fc.nfft, None, dev, stream=True) == "fused":
        xs = torch.randn((CONV_ROWS, VMAP_GRAD_LEN), generator=gen, device="cuda")
        out_len = VMAP_GRAD_LEN - fc.filter_len + 1
        stream_case(fc.nfft, fc.num_out_per_block, xs, out_len, False)
        adjoint_stream_case(fc, CONV_ROWS, out_len, False)
        del xs
    if D.conv_route_mode(fc.nfft, None, dev) == "fused":
        frames = (VMAP_CONV_LEN - fc.nfft) // fc.num_out_per_block + 1
        conv_case(fc.nfft, VMAP_V * (-(-(-(-frames // 2)) // 4) * 4), False)
    fc = CH.DDCChain(DDC_RATE, pt.design_lowpass(DDC_TAPS[0], 0.5 / DDC_DECIM), DDC_DECIM).conv
    if D.conv_route_mode(fc.nfft, None, dev, stream=True) == "fused":
        xs = torch.randn((2 * VMAP_V, VMAP_DSP_N + fc.filter_len - 1), generator=gen,
                         device="cuda")
        stream_case(fc.nfft, fc.num_out_per_block, xs, VMAP_DSP_N, False)
        del xs
    del fc

    def tmajor_engine_case(plan, n, b, engine):
        # one time-major engine's kernel calls at [N, B]
        if engine == "chain":
            chain_case(D._chain_plan(plan, dev), n, b)
        elif engine == "kern2":
            mplan, last = D._kern2_build(n, dev, None)
            chain_case(mplan, mplan.engine_n, last.r * b)
            combine_case(last, b)

    # measure mode's public calls, shape for shape: after a race the call
    # runs whichever engine won, so every engine that can run each of
    # phase_tune's shapes is held (batch-major "tmajor" runs a time-major
    # engine, the measured one, on the transposed [N, B] planes)
    for n, b, tm in tune_shapes():
        plan = pt.new_setup(n)
        avail = D.available_engines(plan, b, tm, dev)
        if "fused2" in avail:
            fused2_case(plan, n, b, (True,))
        if tm or "tmajor" in avail:
            for engine in D._tmajor_engines(plan, b, dev):
                tmajor_engine_case(plan, n, b, engine)
    re, im = planes(1024, 16384, gen)
    cr, ci = pk.stream_copy(re, im)
    torch.cuda.synchronize()
    exact = bool(torch.equal(cr, re) and torch.equal(ci, im))
    emit({"phase": "kernel", "kernel": "copy", "bit_exact": exact})
    check(exact, "copy kernel is not bit-exact")
    errs["copy"] = 0.0
    return errs


def filter_spectrum(n: int, cplx: bool, taps: int = 0):
    """Hf of a lowpass of ``taps`` taps (n // 2 by default; shifted in
    frequency when ``cplx``) on the card."""

    h = pt.design_lowpass(taps or n // 2, 0.1)
    if cplx:
        h = h * np.exp(2j * np.pi * 0.05 * np.arange(h.size))
    return tuple(torch.from_numpy(a).to("cuda") for a in ck.filter_spectrum(D._thin_plan(n), h))


def conv_columns(fc, rows: int, length: int) -> int:
    """The column count of FastConv's block planes for a real [rows, length]
    stream with flush: two frames per column, padded to a multiple of 4."""

    nb = -(-(length - fc.filter_len + 1) // fc.num_out_per_block)
    nb += nb & 1
    return -(-(rows * nb // 2) // 4) * 4


def carrier_db(n: int, bmajor: bool = False, run=None, dtype: str = "float32") -> float:
    """Smallest carrier dynamic range over the test_pffft.c carrier sweep,
    through the time-major planes or (``bmajor``) the complex rows, on a
    plan of ``dtype``; ``run(plan, re, im)`` replaces the public time-major
    call."""

    ks = list(range(0, n, max(1, n // 16)))
    cols = []
    for j, k in enumerate(ks):
        amp = 1.0 if j % 3 == 0 else 1.1
        phi = (j % 4) * 0.125 * np.pi + 2.0 * np.pi * ((k if k < n / 2 else k - n) / n) \
            * np.arange(n, dtype=np.float64)
        cols.append(amp * np.exp(1j * phi))
    x = np.stack(cols, axis=1).astype(np.complex64 if dtype == "float32" else np.complex128)
    plan = pt.new_setup(n, dtype=dtype)
    if bmajor:
        y = pt.transform_ordered(plan, x.T.copy(), device="cuda").cpu().numpy().T
        y = y.astype(np.complex128)
    else:
        if run is None:
            run = lambda p, re, im: pt.transform_ordered_split_tmajor(p, (re, im))
        yr, yi = run(plan, *(torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
                             for a in (x.real, x.imag)))
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


def real_carrier_db(n: int, bmajor: bool = False, dtype: str = "float32") -> float:
    """Smallest carrier dynamic range over the test_pffft.c real carrier
    sweep (cosines at bins 0 .. N/2; the packed bin0 is DC + i*Nyquist),
    through the time-major planes or (``bmajor``) the [K, N] rows, on a
    plan of ``dtype``."""

    ks = list(range(0, n // 2 + 1, max(1, n // 16)))
    cols = []
    for j, k in enumerate(ks):
        amp = 1.0 if j % 3 == 0 else 1.1
        cols.append(amp * np.cos((j % 4) * 0.125 * np.pi
                                 + 2.0 * np.pi * (k / n) * np.arange(n, dtype=np.float64)))
    x = np.stack(cols, axis=1).astype(dtype)
    plan = pt.new_setup(n, pt.REAL, dtype=dtype)
    if bmajor:
        y = pt.rfft_packed(plan, x.T.copy(), device="cuda").cpu().numpy().T
        yr, yi = y.real.astype(np.float64), y.imag.astype(np.float64)
    else:
        yr, yi = pt.transform_ordered_split_tmajor(plan, x, device="cuda")
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
            # the public backward: one B3 launch, which writes the [N, B]
            # signal itself, and no interleave copy
            with recording(S, "interleave_to_real_split_tmajor") as inter:
                c0 = counts()
                pt.transform_ordered_split_tmajor(plan, (yr, yi), pt.BACKWARD)
                bwd_launches = launched(counts(), c0)
            check(bwd_launches == {"rfft_bwd_chain_tmajor_fused": 1} and not inter,
                  f"real N={n}: backward launches {bwd_launches}, {len(inter)} interleaves")
            k_f = time_ms(lambda: pk.rfft_chain_tmajor_fused(cplan, y, tw))
            k_b = time_ms(lambda: pk.rfft_bwd_chain_tmajor_fused(cplan, yr, yi, tw))
            p_f = time_ms(lambda: pk.rfft_chain_tmajor_fused_plain(cplan, y, tw))
            p_b = time_ms(lambda: pk.rfft_bwd_chain_tmajor_fused_plain(cplan, yr, yi, tw))
            rec.update(fused_fwd_ms=k_f, fused_bwd_ms=k_b,
                       plain_fwd_ms=p_f, plain_bwd_ms=p_b, bwd_launches=bwd_launches,
                       bwd_interleaves=len(inter))
            if n == 2048:
                tile = pk.chain_core_tile(cplan, dev)
                rows["real_fused"] = dict(
                    ms=k_f, bwd_ms=k_b, plain_ms=p_f, plain_bwd_ms=p_b,
                    library_ms=lib_fwd, library_bwd_ms=lib_bwd, shape=[n, b],
                    bound_ms=bnd[0], bound_by=bnd[1], tile=tile._asdict(),
                    card_blocks_per_sm={
                        "fwd": pk.rfft_fused_occupancy(h, tile, dev),
                        "bwd": pk.rfft_fused_occupancy(h, tile, dev, backward=True)},
                    ptxas=_build.ptxas_report("real_fused"))
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
            if n in (8192, 131072):
                # B4's launch shapes, and B1 on the unpacked planes
                re, im = (t.reshape(m, r * b).contiguous() for t in
                          (yw.view(m, r, 2, b)[:, :, 0], yw.view(m, r, 2, b)[:, :, 1]))
                rec["b1_unpacked_ms"] = time_ms(lambda: pk.cfft_chain_tmajor(mplan, re, im))
                default = pk.chain_core_tile(mplan, dev)
                for tb, el in CHAIN_SWEEP_SHAPES:
                    t = pk.chain_core_tile(mplan, dev, tb=tb, elems=el)
                    if t is None:
                        continue
                    emit({"phase": "packed_sweep", "n": n, "b": b, "m": m, "r": r,
                          "tile": t._asdict(), "default": t == default,
                          "ptxas": ptxas_of("chain_packed", f"chain_packed_kernelILi{el}E"),
                          "ms": time_ms(lambda: pk.cfft_chain_tmajor_packed(
                              mplan, yw, slabs=r, tb=tb, elems=el))})
                del re, im
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


def phase_real_fused_sweep(gen):
    """B3's launch shapes (batch columns x values a thread) at the fused
    route's real band shapes, H = 1024 and 2048, both directions, beside
    the planner's default; blocks per SM by the planner and the card, and the
    instance's ptxas registers and spills."""

    dev = torch.device("cuda")
    for n, b in REAL_BAND[:2]:
        h = n // 2
        plan = D._thin_plan(h)
        tw = S.real_split_twiddle(pt.new_setup(n, pt.REAL), dev)
        y = torch.randn((h, 2 * b), generator=gen, device="cuda")
        sr, si = planes(h, b, gen)
        default = pk.chain_core_tile(plan, dev)
        for tb, el in CHAIN_SWEEP_SHAPES:
            t = pk.chain_core_tile(plan, dev, tb=tb, elems=el)
            if t is None:
                continue
            kw = dict(tb=tb, elems=el)
            emit({"phase": "real_fused_sweep", "n": n, "b": b, "h": h, "tile": t._asdict(),
                  "default": t == default,
                  "card_blocks_per_sm": {
                      "fwd": pk.rfft_fused_occupancy(h, t, dev),
                      "bwd": pk.rfft_fused_occupancy(h, t, dev, backward=True)},
                  "ptxas": {"fwd": ptxas_of("real_fused", f"rfft_fused_fwdILi{el}E"),
                            "bwd": ptxas_of("real_fused", f"rfft_fused_bwdILi{el}E")},
                  "fwd_ms": time_ms(lambda: pk.rfft_chain_tmajor_fused(plan, y, tw, **kw)),
                  "bwd_ms": time_ms(lambda: pk.rfft_bwd_chain_tmajor_fused(
                      plan, sr, si, tw, **kw))})
        del y, sr, si


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
                tile = pk.chain_core_tile(cplan, dev)
                rows["chain"] = dict(
                    ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, shape=[n, b],
                    tile=tile._asdict(),
                    card_blocks_per_sm=pk.chain_core_occupancy(n, tile, dev),
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
    # B1's launch shapes: batch columns x values a thread, blocks per SM by
    # the planner and by the card, at the chain's band shapes and as kern2's
    # pass A (the chain on the free view [m, r*B])
    for n, b, conf in CHAIN_SWEEP:
        m, r = conf or (n, 1)
        plan = D._thin_plan(m)
        re, im = planes(m, r * b, gen)
        default = pk.chain_core_tile(plan, dev)
        default_ms = time_ms(lambda: pk.cfft_chain_tmajor(plan, re, im))
        for tb, el in CHAIN_SWEEP_SHAPES:
            t = pk.chain_core_tile(plan, dev, tb=tb, elems=el)
            if t is None:
                continue
            emit({"phase": "chain_sweep", "n": n, "b": b, "m": m, "cols": r * b,
                  "tile": t._asdict(), "card_blocks_per_sm": pk.chain_core_occupancy(m, t, dev),
                  "default": t == default,
                  "ms": time_ms(lambda: pk.cfft_chain_tmajor(plan, re, im, tb=tb, elems=el)),
                  "default_ms": default_ms})
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


def bmajor_route(plan, b: int):
    """(engine, wrappers launched by one call) of a batch-major transform:
    the fused two-stage kernel, or the time-major chain / kern2 between two
    transposes."""

    dev = torch.device("cuda")
    engine = D.select_engine(plan, b, False, dev)
    if engine == "fused2":
        return engine, {"cfft_fused2": 1}
    check(engine == "tmajor", f"N={plan.n}: batch-major engine {engine}")
    if D.select_engine(plan, b, True, dev) == "kern2":
        return engine, {"cfft_chain_tmajor": 1, "cfft_combine_tmajor": 1}
    return engine, {"cfft_chain_tmajor": 1}


def sample_rows(b: int) -> torch.Tensor:
    return torch.arange(0, b, max(1, b // 8), device="cuda")


def phase_bmajor_main(gen):
    """The batch-major complex API at the band shapes as [B, N] rows;
    returns the launch counts and the shapes with their engines."""

    reset_counts()
    per_shape = []
    for n, b in BAND:
        plan = pt.new_setup(n)
        engine, per_call = bmajor_route(plan, b)
        re, im = planes(b, n, gen)
        c0 = counts()
        yr, yi = pt.transform_ordered_split(plan, (re, im))
        br, bi = pt.transform_ordered_split(plan, (yr, yi), pt.BACKWARD)
        c1 = counts()
        z = torch.complex(re, im)
        y = pt.transform_ordered(plan, z)
        back = pt.transform_ordered(plan, y, pt.BACKWARD)
        torch.cuda.synchronize()
        c2 = counts()
        rows = sample_rows(b)
        ref = torch.fft.fft(z[rows].to(torch.complex128), dim=-1)
        e_split = rel_err(torch.complex(yr[rows].double(), yi[rows].double()), ref)
        e_cplx = rel_err(y[rows].to(torch.complex128), ref)
        e_rt = max(rel_err(br / n, re), rel_err(bi / n, im), rel_err(back / n, z))
        split_l, cplx_l = launched(c1, c0), launched(c2, c1)
        finite = bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()
                      and torch.isfinite(torch.view_as_real(y)).all())
        emit({"phase": "bmajor", "n": n, "b": b, "engine": engine,
              "split_fwd_rel_err": e_split, "complex_fwd_rel_err": e_cplx,
              "roundtrip_rel_err": e_rt, "finite": finite,
              "split_launches": split_l, "complex_launches": cplx_l})
        check(finite and yr.shape == (b, n) and y.shape == (b, n)
              and y.dtype == torch.complex64 and back.dtype == torch.complex64,
              f"batch-major N={n}: output not finite/shaped/typed")
        check(max(e_split, e_cplx) <= ORACLE_TOL, f"batch-major N={n}: forward error "
                                                  f"{e_split}, {e_cplx}")
        check(e_rt <= ROUND_TRIP_TOL, f"batch-major N={n}: round-trip error {e_rt}")
        want = {k: 2 * v for k, v in per_call.items()}
        check(split_l == want and cplx_l == want,
              f"batch-major N={n}: launches {split_l}, {cplx_l}, expected {want}")
        per_shape.append((n, b, engine))
        del re, im, yr, yi, br, bi, z, y, back
    # the internal order: transform + zreorder against the ordered call, on
    # the default plan (the ordered kernel call, then a reorder) and on a
    # two-stage plan (the kernel stores the internal order itself)
    n, b = 4096, 4096
    x = torch.complex(*planes(b, n, gen))
    for plan in (pt.new_setup(n), pt.new_setup(n, max_factor=64)):
        c0 = counts()
        ordered = pt.transform_ordered(plan, x)
        internal = pt.transform(plan, x)
        back = pt.transform(plan, internal, pt.BACKWARD)
        torch.cuda.synchronize()
        delta = launched(counts(), c0)
        e_order = rel_err(pt.zreorder(plan, internal), ordered)
        e_rt = rel_err(back / n, x)
        emit({"phase": "bmajor", "internal_n": n, "b": b, "factors": list(plan.factors),
              "zreorder_vs_ordered_rel_err": e_order, "roundtrip_rel_err": e_rt,
              "launches": delta})
        check(e_order <= KERNEL_TOL and e_rt <= ROUND_TRIP_TOL,
              f"batch-major internal order {plan.factors}: {e_order}, {e_rt}")
        check(delta == {"cfft_fused2": 3},
              f"batch-major internal order {plan.factors}: launches {delta}")
    del x, ordered, internal, back
    for n in (1024, 4096, 16384, 65536):
        db = carrier_db(n, bmajor=True)
        emit({"phase": "bmajor", "carrier_n": n, "dynamic_range_db": db})
        check(db >= CARRIER_DB, f"batch-major N={n}: carrier dynamic range {db} dB")
    launches = counts()
    emit({"phase": "bmajor", "launches": launches})
    return launches, per_shape


def phase_bmajor_real_main(gen):
    """The batch-major real API at the real band shapes as [B, N] signals;
    returns the launch counts and the shapes with their engines."""

    reset_counts()
    per_shape = []
    for n, b in REAL_BAND:
        plan, h = pt.new_setup(n, pt.REAL), n // 2
        engine, per_call = bmajor_route(plan, b)
        x = torch.randn((b, n), generator=gen, device="cuda")
        c = [counts()]
        s = pt.rfft_packed(plan, x)
        c.append(counts())
        back = pt.irfft_packed(plan, s)
        c.append(counts())
        sr, si = pt.transform_ordered_split(plan, x)
        c.append(counts())
        back2 = pt.transform_ordered_split(plan, (sr, si), pt.BACKWARD)
        torch.cuda.synchronize()
        c.append(counts())
        deltas = [launched(c[i + 1], c[i]) for i in range(4)]
        rows = sample_rows(b)
        ref = torch.fft.rfft(x[rows].double(), dim=-1)
        packed = ref[:, :h].clone()
        packed[:, 0] = torch.complex(ref[:, 0].real, ref[:, h].real)
        e_cplx = rel_err(s[rows].to(torch.complex128), packed)
        e_split = rel_err(torch.complex(sr[rows].double(), si[rows].double()), packed)
        e_rt = max(rel_err(back / n, x), rel_err(back2 / n, x))
        finite = bool(torch.isfinite(torch.view_as_real(s)).all()
                      and torch.isfinite(back).all() and torch.isfinite(back2).all())
        emit({"phase": "bmajor_real", "n": n, "b": b, "engine": engine,
              "complex_fwd_rel_err": e_cplx, "split_fwd_rel_err": e_split,
              "roundtrip_rel_err": e_rt, "finite": finite,
              "launches_rfft_irfft_split_fwd_bwd": deltas})
        check(finite and s.shape == (b, h) and s.dtype == torch.complex64
              and sr.shape == (b, h) and back.shape == (b, n) and back2.shape == (b, n),
              f"batch-major real N={n}: output not finite/shaped/typed")
        check(max(e_cplx, e_split) <= ORACLE_TOL,
              f"batch-major real N={n}: forward error {e_cplx}, {e_split}")
        check(e_rt <= ROUND_TRIP_TOL, f"batch-major real N={n}: round-trip error {e_rt}")
        want = {"real_split": 1, **per_call}
        check(all(d == want for d in deltas),
              f"batch-major real N={n}: launches {deltas}, expected {want} per call")
        per_shape.append((n, b, engine))
        del x, s, back, sr, si, back2
    for n in (2048, 32768, 131072):
        db = real_carrier_db(n, bmajor=True)
        emit({"phase": "bmajor_real", "carrier_n": n, "dynamic_range_db": db})
        check(db >= CARRIER_DB, f"batch-major real N={n}: carrier dynamic range {db} dB")
    launches = counts()
    emit({"phase": "bmajor_real", "launches": launches})
    return launches, per_shape


def phase_bmajor_timing(gen, per_shape, real_shapes):
    """Times of the batch-major public calls per band shape, their copies
    and kernels apart; returns the two batch-major kernels' rows."""

    dev = torch.device("cuda")
    rows = {}
    for n, b, engine in per_shape:
        plan = pt.new_setup(n)
        re, im = planes(b, n, gen)
        z = torch.complex(re, im)
        nbytes = 16.0 * n * b
        bnd = bound(nbytes, fft_flops(n, b))
        lib_ms = time_ms(lambda: torch.fft.fft(z, dim=-1))
        rec = {"phase": "bmajor_time", "n": n, "b": b, "engine": engine,
               "split_fwd_ms": time_ms(lambda: pt.transform_ordered_split(plan, (re, im))),
               "split_bwd_ms": time_ms(
                   lambda: pt.transform_ordered_split(plan, (re, im), pt.BACKWARD)),
               "complex_fwd_ms": time_ms(lambda: pt.transform_ordered(plan, z)),
               "to_split_ms": time_ms(lambda: S.to_split(z)),
               "from_split_ms": time_ms(lambda: S.from_split((re, im))),
               "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms}
        rec["frac_bound_split_fwd"] = bnd[0] / rec["split_fwd_ms"]
        if engine == "fused2":
            k_ms = time_ms(lambda: fs.cfft_fused2(plan, re, im))
            rec.update(fused2_ms=k_ms, fused2_bwd_ms=time_ms(
                lambda: fs.cfft_fused2(plan, re, im, backward=True)),
                fused2_tile=fs.fused2_tile(n, dev)._asdict())
            if n == 4096:
                p_ms = time_ms(lambda: fs.cfft_fused2_plain(plan, re, im), inner=1)
                rows["fused2"] = dict(ms=k_ms, bwd_ms=rec["fused2_bwd_ms"], plain_ms=p_ms,
                                      library_ms=lib_ms, shape=[b, n], bound_ms=bnd[0],
                                      bound_by=bnd[1])
                rec["fused2_plain_ms"] = p_ms
        else:
            # the "tmajor" route: a transposing copy each way around kern2
            rec["transpose_ms"] = time_ms(lambda: (re.T.contiguous(), im.T.contiguous()))
        emit(rec)
        del re, im, z
    for n, b, engine in real_shapes:
        plan, h = pt.new_setup(n, pt.REAL), n // 2
        x = torch.randn((b, n), generator=gen, device="cuda")
        s = pt.rfft_packed(plan, x)
        sr, si = pt.transform_ordered_split(plan, x)
        tw = S.real_split_twiddle(plan, dev)
        zr, zi = S.pack_real_input_split(x)
        # one read of the [B, N] signal, one write of the two [B, H] planes
        bnd = bound(8.0 * n * b, fft_flops(h, b) + 16.0 * h * b)
        lib_fwd = time_ms(lambda: torch.fft.rfft(x, dim=-1))
        spec = torch.fft.rfft(x, dim=-1)
        lib_bwd = time_ms(lambda: torch.fft.irfft(spec, n=n, dim=-1))
        del spec
        rec = {"phase": "bmajor_real_time", "n": n, "b": b, "engine": engine,
               "rfft_packed_ms": time_ms(lambda: pt.rfft_packed(plan, x)),
               "irfft_packed_ms": time_ms(lambda: pt.irfft_packed(plan, s)),
               "split_fwd_ms": time_ms(lambda: pt.transform_ordered_split(plan, x)),
               "split_bwd_ms": time_ms(
                   lambda: pt.transform_ordered_split(plan, (sr, si), pt.BACKWARD)),
               "pack_ms": time_ms(lambda: S.pack_real_input_split(x)),
               "interleave_ms": time_ms(lambda: S.interleave_to_real_split(sr, si)),
               "from_split_ms": time_ms(lambda: S.from_split((sr, si))),
               "split_kernel_fwd_ms": time_ms(lambda: rk.real_split(zr, zi, tw)),
               "split_kernel_bwd_ms": time_ms(
                   lambda: rk.real_split(sr, si, tw, backward=True)),
               "bound_ms": bnd[0], "bound_by": bnd[1],
               "library_fwd_ms": lib_fwd, "library_bwd_ms": lib_bwd}
        rec["frac_bound_split_fwd"] = bnd[0] / rec["split_fwd_ms"]
        if engine == "fused2":
            rec["fused2_ms"] = time_ms(lambda: fs.cfft_fused2(plan, zr, zi))
        if (b, h) == (2048, 4096):
            # four planes of [B, H]: two read, two written
            kb = bound(16.0 * h * b, 16.0 * h * b)
            p_ms = time_ms(lambda: rk.real_split_plain(zr, zi, tw))
            rows["real_split_bmajor"] = dict(
                ms=rec["split_kernel_fwd_ms"], bwd_ms=rec["split_kernel_bwd_ms"],
                plain_ms=p_ms, library_ms=None, shape=[b, h], bound_ms=kb[0],
                bound_by=kb[1])
            rec["split_kernel_plain_ms"] = p_ms
        emit(rec)
        del x, s, sr, si, zr, zi
    return rows


def conv_oracle(x: torch.Tensor, h: np.ndarray, correlation: bool = False) -> torch.Tensor:
    """Valid-mode y[i] = sum_j x[i+j] c[j] (c = reversed h, or h for
    correlation) of one stream, as a complex128 FFT convolution."""

    xd = x.to(torch.complex128)
    g = torch.from_numpy(np.asarray(h, np.complex128)).to(x.device)
    if correlation:
        g = g.flip(0)
    n, f = xd.shape[-1], g.shape[0]
    size = 1 << (n + f - 2).bit_length()
    full = torch.fft.ifft(torch.fft.fft(xd, size) * torch.fft.fft(g, size))
    ref = full[f - 1:n]
    return ref if x.is_complex() else ref.real


# launches of one apply_batched call per route (the fused route is the
# kernel's stream map, nfft <= 16384; the composed route past it rides kern2
# in both directions)
CONV_ROUTE_LAUNCHES = {"fused": {"zconv_stream": 1},
                       "tmajor": {"cfft_chain_tmajor": 2, "cfft_combine_tmajor": 2}}


def phase_fastconv(gen):
    """FastConv at full size on every route and flag; returns the launch
    counts and the runs to time."""

    dev = torch.device("cuda")
    reset_counts()
    runs = []

    def run(name, fc, x, sample_rows):
        route = fc._route(dev, stream=True)
        c0 = counts()
        y = fc.apply_batched(x, flush=True)
        torch.cuda.synchronize()
        delta = launched(counts(), c0)
        err = max(rel_err(y[r], conv_oracle(x[r], fc_taps[name], fc.correlation))
                  for r in sample_rows)
        finite = bool(torch.isfinite(torch.view_as_real(y) if y.is_complex() else y).all())
        emit({"phase": "fastconv", "run": name, "shape": list(x.shape), "taps": fc.filter_len,
              "nfft": fc.nfft, "route": route, "out_shape": list(y.shape),
              "oracle_rel_err": err, "finite": finite, "launches": delta})
        check(finite and y.shape == (*x.shape[:-1], x.shape[-1] - fc.filter_len + 1),
              f"FastConv {name}: output not finite/shaped {tuple(y.shape)}")
        check(err <= ORACLE_TOL, f"FastConv {name}: oracle error {err}")
        check(delta == CONV_ROUTE_LAUNCHES[route],
              f"FastConv {name}: launches {delta} do not match route {route}")
        runs.append((name, fc, x, route))
        return y

    fc_taps = {}
    x = torch.randn((CONV_ROWS, CONV_LEN), generator=gen, device="cuda")
    for taps in CONV_TAPS:
        name = f"real_f{taps}"
        fc_taps[name] = pt.design_lowpass(taps, 0.1)
        run(name, C.FastConv(fc_taps[name]), x, (0, CONV_ROWS - 1))
    # the composed route, forced at the longest taps: kern2 both ways
    name = f"real_f{CONV_TAPS[-1]}_tmajor"
    fc_taps[name] = fc_taps[f"real_f{CONV_TAPS[-1]}"]
    fc = C.FastConv(fc_taps[name])
    fc._force_conv_kernel = "tmajor"
    run(name, fc, x, (0, CONV_ROWS - 1))
    xc = torch.complex(*planes(FLAG_ROWS, FLAG_LEN, gen))
    h = pt.design_lowpass(FLAG_TAPS, 0.1)
    for name, flags in (("cplx_inp_out", C.ConvFlags.CPLX_INP_OUT),
                        ("cplx_single_fft", C.ConvFlags.CPLX_INP_OUT
                         | C.ConvFlags.CPLX_SINGLE_FFT)):
        fc_taps[name] = h
        run(name, C.FastConv(h, flags=flags), xc, (0, FLAG_ROWS - 1))
    fc_taps["correlation"] = np.random.default_rng(SEED).standard_normal(FLAG_TAPS)
    run("correlation", C.FastConv(fc_taps["correlation"], flags=C.ConvFlags.CORRELATION),
        x[:FLAG_ROWS, :FLAG_LEN], (0, FLAG_ROWS - 1))
    # the streaming entry, fed in odd-sized chunks, against the one-shot output
    sc = C.StreamingConv(h, device="cuda")
    xs = x[1, : 1 << 19].cpu().numpy()
    rng = np.random.default_rng(SEED)
    outs, pos = [], 0
    while pos < xs.size:
        step = int(rng.integers(1000, 30000)) | 1
        outs.append(sc.push(xs[pos:pos + step]))
        pos += step
    outs.append(sc.flush())
    got = np.concatenate(outs)
    want = C.FastConv(h).apply(x[1, : 1 << 19], flush=True)[0].cpu().numpy()
    serr = float(np.abs(got - want).max() / np.abs(want).max()) if got.shape == want.shape else 1.0
    emit({"phase": "fastconv", "run": "streaming", "taps": FLAG_TAPS, "samples": int(xs.size),
          "chunks": len(outs) - 1, "out": int(got.size), "rel_err_vs_one_shot": serr})
    check(got.shape == want.shape and serr <= KERNEL_TOL,
          f"StreamingConv: {got.shape} vs {want.shape}, rel err {serr}")
    fastconv_ring_view(gen)
    launches = counts()
    emit({"phase": "fastconv", "launches": launches})
    return launches, runs


def fastconv_ring_view(gen) -> None:
    """The stream map on a slice of a ring buffer's rows, as a streaming
    caller hands it: read in place (no layout copy, one strided read), bit
    for bit the call on the same rows made contiguous; both timed."""

    ring = torch.randn((CONV_ROWS, RING_LEN), generator=gen, device="cuda")
    x = ring[:, RING_OFFSET:RING_OFFSET + CONV_LEN]
    xc = x.contiguous()
    keys = ("entry.copy_bytes", P.STRIDED_READS)
    for taps in RING_TAPS:
        fc = C.FastConv(pt.design_lowpass(taps, 0.1))
        before = [P.counters.get(k, 0) for k in keys]
        y = fc.apply_batched(x, flush=False)
        moved = [P.counters.get(k, 0) - b for k, b in zip(keys, before)]
        same = bool(torch.equal(y, fc.apply_batched(xc, flush=False)))
        emit({"phase": "fastconv", "run": "ring_view", "taps": taps, "nfft": fc.nfft,
              "shape": list(x.shape), "row_stride": x.stride(0), "bitwise_equal": same,
              "copy_bytes": moved[0], "strided_reads": moved[1],
              "strided_ms": time_ms(lambda: fc.apply_batched(x, flush=False), inner=2),
              "contiguous_ms": time_ms(lambda: fc.apply_batched(xc, flush=False), inner=2)})
        check(same and moved == [0, 1],
              f"FastConv ring view at F = {taps}: equal {same}, (copy bytes, strided reads) "
              f"{moved}, expected (0, 1)")
    del ring, x, xc


def pfb_oracle(x: torch.Tensor, weights: np.ndarray, offset: int = 0) -> torch.Tensor:
    """Channels [K, M] of one complex stream x [K*M] from zero history, in
    float64: v[k, phi] = sum_s hb[s, phi] x_ext[(P + k - s)*M - phi + offset],
    then an unscaled inverse DFT over phi."""

    p, m = weights.shape
    k = x.shape[-1] // m
    ext = torch.cat([torch.zeros(p * m, dtype=torch.complex128, device=x.device),
                     x.to(torch.complex128)])
    ext = torch.nn.functional.pad(ext[offset:], (0, offset))
    w = torch.from_numpy(weights.astype(np.float64)).to(x.device)
    ks = torch.arange(k, device=x.device)[:, None]
    ph = torch.arange(m, device=x.device)[None, :]
    v = torch.zeros((k, m), dtype=torch.complex128, device=x.device)
    for s in range(p):
        v += ext[(p + ks - s) * m - ph] * w[s]
    return torch.fft.ifft(v, dim=-1) * m


def phase_channelizer(gen):
    """The channelizer at full size over two streaming steps; returns the
    launch counts and the runs to time."""

    dev = torch.device("cuda")
    reset_counts()
    runs = []
    for m, p, batch, frames in CHAN_CONFIGS:
        ch = CH.Channelizer(m, p, device="cuda")
        engine = D.select_engine(ch.plan, batch * frames, True, dev)
        step_launches = {"pfb_fir_stream_tmajor": 1, "cfft_chain_tmajor": 1}
        if engine == "kern2":
            step_launches["cfft_combine_tmajor"] = 1
        xr, xi = planes(batch, 2 * frames * m, gen)
        half = frames * m
        outs, outs_t, deltas = [], [], []
        st = st_t = ch.init_state((batch,))
        for j in range(2):
            sl = slice(j * half, (j + 1) * half)
            c0 = counts()
            y, st = ch.process_split(st, xr[:, sl], xi[:, sl])
            c1 = counts()
            y_t, st_t = ch.process_split_tmajor(st_t, xr[:, sl], xi[:, sl])
            torch.cuda.synchronize()
            deltas += [launched(c1, c0), launched(counts(), c1)]
            outs.append(y)
            outs_t.append(y_t)
        yr = torch.cat([o[0] for o in outs], dim=-2)
        yi = torch.cat([o[1] for o in outs], dim=-2)
        (ar, ai), _ = ch.process_split(ch.init_state((batch,)), xr, xi)
        torch.cuda.synchronize()
        e_chunks = max(rel_err(ar, yr), rel_err(ai, yi))
        e_tmajor = max(
            rel_err(o_t[c].reshape(m, batch, frames).permute(1, 2, 0), o[c])
            for o, o_t in zip(outs, outs_t) for c in (0, 1))
        err = 0.0
        for r in (0, batch - 1):
            ref = pfb_oracle(torch.complex(xr[r], xi[r]), ch.weights)
            err = max(err, rel_err(torch.complex(yr[r], yi[r]), ref))
        emit({"phase": "channelizer", "m": m, "p": p, "batch": batch, "frames": frames,
              "engine": engine, "oracle_rel_err": err, "two_chunks_vs_one_rel_err": e_chunks,
              "tmajor_vs_split_rel_err": e_tmajor, "launches_per_step": deltas})
        check(yr.shape == (batch, 2 * frames, m) and bool(torch.isfinite(yr).all()),
              f"channelizer M={m}: output not finite/shaped")
        check(err <= ORACLE_TOL, f"channelizer M={m}: oracle error {err}")
        check(e_chunks <= KERNEL_TOL and e_tmajor == 0.0,
              f"channelizer M={m}: chunked {e_chunks}, tmajor layout {e_tmajor}")
        check(all(d == step_launches for d in deltas),
              f"channelizer M={m}: launches {deltas}, expected {step_launches} per step")
        runs.append((ch, xr[:, :half].contiguous(), xi[:, :half].contiguous(), engine))
        del xr, xi, yr, yi, ar, ai, outs, outs_t
    # one oversampled step (V = 2) at the second configuration
    m, p, batch, frames = CHAN_CONFIGS[1]
    och = CH.OversampledChannelizer(m, 2, p, device="cuda")
    xr, xi = planes(batch, frames * m, gen)
    c0 = counts()
    (yr, yi), _ = och.process_split(och.init_state((batch,)), xr, xi)
    torch.cuda.synchronize()
    over = launched(counts(), c0)
    x0 = torch.complex(xr[0], xi[0])
    ref = torch.empty((frames, 2, m), dtype=torch.complex128, device="cuda")
    for r in range(2):
        ph = torch.from_numpy(och.ph_re[r] + 1j * och.ph_im[r].astype(np.float64)).to("cuda")
        ref[:, r] = pfb_oracle(x0, och.base.weights, r * och.hop) * ph
    err = rel_err(torch.complex(yr[0], yi[0]), ref.reshape(2 * frames, m))
    emit({"phase": "channelizer", "oversampled": 2, "m": m, "p": p, "batch": batch,
          "frames": frames, "out_shape": list(yr.shape), "oracle_rel_err": err,
          "launches_per_step": over})
    check(yr.shape == (batch, 2 * frames, m) and err <= ORACLE_TOL,
          f"oversampled channelizer: shape {tuple(yr.shape)}, oracle error {err}")
    # one polyphase launch (both planes) and one FFT per residue
    check(over.get("pfb_fir_stream_tmajor") == 2,
          f"oversampled channelizer: launches {over}, expected 2 polyphase launches")
    launches = counts()
    emit({"phase": "channelizer", "launches": launches})
    return launches, runs


# the plain version of every kernel wrapper a main path runs, by wrapper
PLAIN = {
    (pk, "cfft_chain_tmajor"): lambda plan, re, im, *, backward=False, tb=None, elems=None:
        pk.chain_tmajor_plain(plan, re, im, backward=backward),
    (pk, "cfft_combine_tmajor"): lambda last, re, im, *, backward=False:
        pk.combine_tmajor_plain(last, re, im, backward=backward),
    (pk, "cfft_chain_tmajor_packed"): lambda plan, y, *, slabs=1, tb=None, elems=None:
        pk.chain_tmajor_packed_plain(plan, y, slabs=slabs),
    (pk, "rfft_chain_tmajor_fused"): lambda plan, y, tw, *, tb=None, elems=None:
        pk.rfft_chain_tmajor_fused_plain(plan, y, tw),
    (pk, "rfft_bwd_chain_tmajor_fused"): lambda plan, sr, si, tw, *, tb=None, elems=None:
        pk.rfft_bwd_chain_tmajor_fused_plain(plan, sr, si, tw),
    (pk, "real_split_tmajor"): lambda zr, zi, tw, *, backward=False:
        pk.real_split_tmajor_plain(zr, zi, tw, backward=backward),
    (fs, "cfft_fused2"): lambda plan, re, im, *, backward=False, ordered=True:
        fs.cfft_fused2_plain(plan, re, im, backward=backward, ordered=ordered),
    (rk, "real_split"): lambda zr, zi, tw, *, backward=False:
        rk.real_split_plain(zr, zi, tw, backward=backward),
    (ck, "zconv_tmajor"): lambda plan, re, im, hfr, hfi, *, tb=None, elems=None:
        ck.zconv_tmajor_plain(plan, re, im, hfr, hfi),
    (ck, "zconv_stream"): lambda plan, x, hfr, hfi, u, total, adjoint=None:
        ck.zconv_stream_plain(plan, x, hfr, hfi, u, total),
    (pfb, "pfb_fir"): lambda rows, w, k: pfb.pfb_fir_plain(rows, w, k),
    (pfb, "pfb_fir_stream_tmajor"): lambda hist, x, w, k, offset=0, warps=None:
        pfb.pfb_fir_stream_tmajor_plain(hist, x, w, k, offset),
}


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper of :data:`PLAIN` swapped for its plain version:
    the pipelines' plain-version timing."""

    saved = [(mod, name, getattr(mod, name)) for mod, name in PLAIN]
    for (mod, name), fn in PLAIN.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_fir_timing(gen, conv_runs, chan_runs):
    """Times of the FIR pipelines and their two kernels; returns the
    kernels' rows."""

    dev = torch.device("cuda")
    rows = {}
    for name, fc, x, route in conv_runs:
        if not name.startswith("real_f"):
            continue
        samples = x.numel()
        out = x.shape[0] * (x.shape[1] - fc.filter_len + 1)
        c0 = counts()
        ms = time_ms(lambda: fc.apply_batched(x), inner=2)
        calls = 3 + REPS * 2
        per_call = {k: v / calls for k, v in launched(counts(), c0).items()}
        with plain_kernels():
            plain = time_ms(lambda: fc.apply_batched(x), inner=1, warm=1)
        cols = conv_columns(fc, x.shape[0], x.shape[1])
        n = fc.nfft
        u = fc.num_out_per_block
        total = x.shape[1] - fc.filter_len + 1
        # the stream read once and the output written once; the two
        # transforms and the multiply on every column
        bnd = bound(4.0 * (samples + out), 2 * fft_flops(n, cols) + 6.0 * n * cols)
        rec = {"phase": "fir_time", "pipeline": "fastconv", "run": name, "nfft": n,
               "route": route, "ms": ms, "msamples_per_s": samples / ms / 1e3,
               "bound_ms": bnd[0], "bound_by": bnd[1], "frac_bound": bnd[0] / ms,
               "plain_ms": plain, "launches_per_call": per_call}
        if route == "fused" and D.conv_kernel_choice(n, cols, dev) is not None:
            # the stream map against the composition it replaced, in this run:
            # framing into column planes, the column map, unpacking
            cplan = D.conv_kernel_choice(n, cols, dev)[0]
            hfr, hfi = fc._spectrum(dev)
            col_map = lambda re, im: ck.zconv_tmajor(cplan, re, im, hfr, hfi)
            nb = -(-total // u)
            nb += nb & 1
            v = ck.frames(x, n, u, nb)
            pre, pim = ck.columns(v[:, 0::2], v[:, 1::2])
            yr, yi = col_map(pre, pim)
            rec.update(
                stream_ms=time_ms(lambda: ck.zconv_stream(cplan, x, hfr, hfi, u, total),
                                  inner=2),
                composed_ms=time_ms(lambda: ck.stream_conv(col_map, x, n, u, total), inner=2),
                frame_ms=time_ms(lambda: ck.columns(v[:, 0::2], v[:, 1::2]), inner=2),
                column_map_ms=time_ms(lambda: col_map(pre, pim), inner=2),
                unpack_ms=time_ms(lambda: ck.unpack_pairs(yr, yi, u, x.shape[0], nb // 2),
                                  inner=2))
            rec["faster_than_composed"] = rec["ms"] < rec["composed_ms"]
            del v, pre, pim, yr, yi
            re, im = planes(n, cols, gen)
            k_ms = time_ms(lambda: ck.zconv_tmajor(cplan, re, im, hfr, hfi))
            p_ms = time_ms(lambda: ck.zconv_tmajor_plain(cplan, re, im, hfr, hfi), inner=1)
            z = torch.complex(re, im)
            hc = torch.complex(hfr, hfi)[:, None]
            lib_ms = time_ms(lambda: torch.fft.ifft(torch.fft.fft(z, dim=0) * hc, dim=0))
            kb = bound(16.0 * n * cols, 2 * fft_flops(n, cols) + 6.0 * n * cols)
            rec.update(kernel_ms=k_ms, kernel_plain_ms=p_ms, kernel_bound_ms=kb[0],
                       library_fft_mul_ifft_ms=lib_ms, library_calls=3, cols=cols,
                       tile=ck.column_tile(cplan, dev)._asdict())
            if n == 2048:
                rows["conv_fused"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                          library="torch.fft.fft, multiply, torch.fft.ifft "
                                                  "(3 calls)",
                                          shape=[n, cols], bound_ms=kb[0], bound_by=kb[1],
                                          stream_ms=rec["stream_ms"], stream_bound_ms=bnd[0])
                # the column map's launch shapes at this column count
                for tb, el in CONV_SWEEP_SHAPES:
                    t = pk._core_launch(cplan, dev, "fused conv kernel", tb, el)
                    emit({"phase": "conv_sweep", "n": n, "b": cols, "tile": t._asdict(),
                          "ms": time_ms(lambda: ck.zconv_tmajor(cplan, re, im, hfr, hfi,
                                                                tb=tb, elems=el)),
                          "default_ms": k_ms})
            del re, im, z
        else:
            # where a call's time goes: framing into column planes, the block
            # convolution (the route), unpacking the valid samples
            nb = -(-total // u)
            nb += nb & 1
            v = ck.frames(x, n, u, nb)
            pre, pim = ck.columns(v[:, 0::2], v[:, 1::2])
            yr, yi = fc._block_conv(pre, pim)
            rec.update(
                frame_ms=time_ms(lambda: ck.columns(v[:, 0::2], v[:, 1::2]), inner=2),
                block_conv_ms=time_ms(lambda: fc._block_conv(pre, pim), inner=2),
                unpack_ms=time_ms(lambda: ck.unpack_pairs(yr, yi, u, x.shape[0], nb // 2),
                                  inner=2))
            del v, pre, pim, yr, yi
        if route == "fused" and "stream_ms" not in rec:
            # the stream map alone beside the chunk's bound (bytes at nfft 8192)
            hfr, hfi = fc._spectrum(dev)
            splan = ck.stream_plan(n)
            rec.update(stream_ms=time_ms(lambda: ck.zconv_stream(splan, x, hfr, hfi, u, total),
                                         inner=2),
                       stream_factors=list(splan.factors), stream_bound_ms=bnd[0],
                       stream_tile=ck.stream_tile(n, dev)._asdict())
        emit(rec)
    torch.backends.cudnn.allow_tf32 = False  # the conv1d yardstick in full f32
    for ch, xr, xi, engine in chan_runs:
        m, p = ch.m, ch.p
        batch, frames = xr.shape[0], xr.shape[1] // m
        st = ch.init_state((batch,))
        c0 = counts()
        ms = time_ms(lambda: ch.process_split_tmajor(st, xr, xi), inner=2)
        calls = 3 + REPS * 2
        per_call = {k: v / calls for k, v in launched(counts(), c0).items()}
        with plain_kernels():
            plain = time_ms(lambda: ch.process_split_tmajor(st, xr, xi), inner=1, warm=1)
        samples = xr.numel()
        # both input planes read once, both output planes written once
        bnd = bound(16.0 * samples, 2 * (2.0 * p * samples) + fft_flops(m, batch * frames))
        # where a step's time goes: the new state (a copy of the chunk's
        # tail), the polyphase launch (both planes), the FFT over the phases
        _, x, _, _ = ch._advance(st, xr, xi)
        w = ch._weights(dev)
        v = pfb.pfb_fir_stream_tmajor(st, x, w, frames)
        k_ms = time_ms(lambda: pfb.pfb_fir_stream_tmajor(st, x, w, frames))
        stage = {"state_ms": time_ms(lambda: ch._advance(st, xr, xi), inner=2),
                 "pfb_ms": k_ms,
                 "fft_ms": time_ms(lambda: pt.transform_ordered_split_tmajor(
                     ch.plan, v, pt.BACKWARD), inner=2)}
        rec = {"phase": "fir_time", "pipeline": "channelizer", "m": m, "p": p, "batch": batch,
               "frames": frames, "engine": engine, "ms": ms,
               "msamples_per_s": samples / ms / 1e3, "bound_ms": bnd[0], "bound_by": bnd[1],
               "frac_bound": bnd[0] / ms, "plain_ms": plain, "launches_per_call": per_call,
               **stage}
        p_ms = time_ms(lambda: pfb.pfb_fir_stream_tmajor_plain(st, x, w, frames), inner=1)
        rws = torch.randn((batch, frames + p - 1, m), generator=gen, device="cuda")
        id_ms = time_ms(lambda: pfb.pfb_fir(rws, w, frames))
        # conv1d(groups=M) computes pfb_fir's function on channels-first rows;
        # the yardstick of the stream map is that call on both planes' rows
        # followed by the copy into the time-major [M, batch*frames] v
        xin = torch.randn((2 * batch, m, frames + p - 1), generator=gen, device="cuda")
        wconv = w.t().contiguous().unsqueeze(1)
        lib = torch.nn.functional.conv1d(xin[:batch], wconv, groups=m)
        lib_err = rel_err(lib.permute(0, 2, 1),
                          pfb.pfb_fir_plain(xin[:batch].permute(0, 2, 1), w, frames))
        to_tmajor = lambda y: y.view(2, batch, m, frames).permute(0, 2, 1, 3).reshape(
            2, m, batch * frames)
        lib_ms = time_ms(lambda: to_tmajor(torch.nn.functional.conv1d(xin, wconv, groups=m)))
        # both planes: history and chunk read once, v written once
        kb = bound(4.0 * 2 * (batch * p * m + samples + m * batch * frames),
                   2 * 2.0 * p * m * batch * frames)
        rec.update(pfb_stream_ms=k_ms, pfb_stream_plain_ms=p_ms, pfb_rows_ms=id_ms,
                   pfb_bound_ms=kb[0], pfb_frac_bound=kb[0] / k_ms,
                   library_conv1d_tmajor_ms=lib_ms, library_conv1d_rel_err=lib_err)
        if m == 4096:
            rows["pfb_fir"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                   library="torch.nn.functional.conv1d(groups=M) on both "
                                           "planes' rows, then the time-major copy",
                                   rows_map_ms=id_ms, shape=[m, p, batch, frames],
                                   bound_ms=kb[0], bound_by=kb[1])
        emit(rec)
        # the stream map's launch shapes at this configuration
        pm = next(q for q in (4, 8, 16, 32) if p <= q) if p <= 32 else 0
        for warps in PFB_SWEEP:
            emit({"phase": "pfb_sweep", "m": m, "p": p, "batch": batch, "frames": frames,
                  "warps": warps, "frames_a_block": 32 * warps,
                  "default": warps == pfb.STREAM_WARPS,
                  "ptxas": ptxas_of("pfb_fir", f"pfb_stream_kernelILi{pm}E"),
                  "ms": time_ms(lambda: pfb.pfb_fir_stream_tmajor(st, x, w, frames,
                                                                  warps=warps)),
                  "bound_ms": kb[0]})
        del x, v, rws, xin, lib
    return rows


def sampled_oracle(re, im, cols):
    """complex128 ``torch.fft.fft(dim=0)`` of the sampled columns."""

    return torch.fft.fft(torch.complex(re[:, cols].double(), im[:, cols].double()), dim=0)


def phase_ksplit2(gen):
    """B10 through its entry point at the band shapes its tile holds (no
    route of the dispatcher picks it, as in the reference); returns the
    launch counts."""

    reset_counts()
    for n, b in KSPLIT2_BAND:
        plan = pt.new_setup(n)
        re, im = planes(n, b, gen)
        c0 = counts()
        yr, yi = D.cfft_ksplit2_tmajor(plan, re, im)
        br, bi = D.cfft_ksplit2_tmajor(plan, yr, yi, backward=True)
        torch.cuda.synchronize()
        delta = launched(counts(), c0)
        cols = sample_rows(b)
        e_fwd = rel_err(torch.complex(yr[:, cols].double(), yi[:, cols].double()),
                        sampled_oracle(re, im, cols))
        y = torch.complex(yr[:, cols].double(), yi[:, cols].double())
        e_bwd = rel_err(torch.complex(br[:, cols].double(), bi[:, cols].double()),
                        torch.fft.ifft(y, dim=0) * n)
        e_rt = max(rel_err(br / n, re), rel_err(bi / n, im))
        finite = bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()
                      and torch.isfinite(br).all() and torch.isfinite(bi).all())
        emit({"phase": "ksplit2", "n": n, "b": b, "conf": [2048, n // 2048],
              "fwd_rel_err": e_fwd, "bwd_rel_err": e_bwd, "roundtrip_rel_err": e_rt,
              "finite": finite, "launches": delta})
        check(finite and yr.shape == (n, b), f"ksplit2 N={n}: output not finite/shaped")
        check(max(e_fwd, e_bwd) <= ORACLE_TOL, f"ksplit2 N={n}: oracle error {e_fwd}, {e_bwd}")
        check(e_rt <= ROUND_TRIP_TOL, f"ksplit2 N={n}: round-trip error {e_rt}")
        check(delta == {"cfft_ksplit2_tmajor": 2}, f"ksplit2 N={n}: launches {delta}")
        del re, im, yr, yi, br, bi
    for n, _ in KSPLIT2_BAND:
        db = carrier_db(n, run=lambda p, re, im: D.cfft_ksplit2_tmajor(p, re, im))
        emit({"phase": "ksplit2", "carrier_n": n, "dynamic_range_db": db})
        check(db >= CARRIER_DB, f"ksplit2 N={n}: carrier dynamic range {db} dB")
    launches = counts()
    emit({"phase": "ksplit2", "launches": launches})
    return launches


def phase_ksplit2_timing(gen):
    """B10 beside kern2 on the same planes, the plain version, the bound and
    ``torch.fft.fft(dim=0)``, per band shape, and B10's launch-shape sweeps;
    returns B10's row."""

    dev = torch.device("cuda")
    rows = {}
    sweeps = {}
    for n, conf, tb, cluster in KSPLIT2_SWEEP:
        sweeps.setdefault(n, []).append((conf, tb, cluster))

    def shape(n, conf=None, tb=None, cluster=None):
        mplan, last = D._build_ksplit(n, *(conf or (2048, n // 2048)))
        tile = D.ksplit2_tile(mplan, last.r, dev, tb=tb, cluster=cluster)
        clusters, blocks = D.ksplit2_occupancy(mplan, last.r, tile, dev)
        return {"conf": [mplan.engine_n, last.r], "tile": tile._asdict(),
                "card_clusters": clusters, "card_blocks_per_sm": blocks}

    for n, b in KSPLIT2_BAND:
        plan = pt.new_setup(n)
        re, im = planes(n, b, gen)
        mplan, last = D._build_ksplit(n, 2048, n // 2048)
        z = torch.complex(re, im)
        bnd = bound(16.0 * n * b, fft_flops(n, b))
        rec = {"phase": "ksplit2_time", "n": n, "b": b, **shape(n),
               "ksplit2_ms": time_ms(lambda: D.cfft_ksplit2_tmajor(plan, re, im)),
               "ksplit2_bwd_ms": time_ms(
                   lambda: D.cfft_ksplit2_tmajor(plan, re, im, backward=True)),
               "kern2_ms": time_ms(lambda: D.cfft_kern2_tmajor(plan, re, im)),
               "kern2_conf": list(D._kern2_conf(n, dev)),
               "plain_ms": time_ms(lambda: D.ksplit2_tmajor_plain(mplan, last, re, im),
                                   inner=1),
               "library_ms": time_ms(lambda: torch.fft.fft(z, dim=0)),
               "bound_ms": bnd[0], "bound_by": bnd[1]}
        rec["frac_bound"] = bnd[0] / rec["ksplit2_ms"]
        emit(rec)
        if n == 4096:
            rows["ksplit2"] = dict(ms=rec["ksplit2_ms"], bwd_ms=rec["ksplit2_bwd_ms"],
                                   plain_ms=rec["plain_ms"], library_ms=rec["library_ms"],
                                   kern2_ms=rec["kern2_ms"], shape=[n, b], bound_ms=bnd[0],
                                   bound_by=bnd[1])
        for conf, tb, cluster in sweeps.get(n, ()):
            sw = shape(n, conf, tb, cluster)
            emit({"phase": "ksplit2_sweep", "n": n, "b": b, **sw,
                  "ksplit2_ms": time_ms(lambda: D.cfft_ksplit2_tmajor(
                      plan, re, im, conf=conf, tb=tb, cluster=cluster)),
                  "default_ms": rec["ksplit2_ms"]})
        del re, im, z
    return rows


def phase_f64(gen):
    """Float64 plans through the public calls, against complex128
    ``torch.fft``, with their times; no f32 kernel may launch."""

    c0 = counts()
    f64 = {"dtype": torch.float64, "device": "cuda", "generator": gen}
    for n, b in F64_SHAPES:
        plan = pt.new_setup(n, dtype="float64")
        rplan = pt.new_setup(n, pt.REAL, dtype="float64")
        re, im = torch.randn((n, b), **f64), torch.randn((n, b), **f64)
        z = torch.complex(re, im)
        zb = z.T.contiguous()
        ref = torch.fft.fft(z, dim=0)
        yr, yi = pt.transform_ordered_split_tmajor(plan, (re, im))
        y = torch.complex(yr, yi)
        br, bi = pt.transform_ordered_split_tmajor(plan, (yr, yi), pt.BACKWARD)
        yb = pt.transform_ordered(plan, zb)
        bb = pt.transform_ordered(plan, yb, pt.BACKWARD)
        x = re
        rref = torch.fft.rfft(x, dim=0)
        packed = rref[: n // 2].clone()
        packed[0] = torch.complex(rref[0].real, rref[n // 2].real)
        sr, si = pt.transform_ordered_split_tmajor(rplan, x)
        xb = pt.transform_ordered_split_tmajor(rplan, (sr, si), pt.BACKWARD)
        s = pt.rfft_packed(rplan, x.T.contiguous())
        xb2 = pt.irfft_packed(rplan, s)
        torch.cuda.synchronize()
        errs = {
            "tmajor_fwd": rel_err(y, ref),
            "tmajor_bwd": rel_err(torch.complex(br, bi), torch.fft.ifft(y, dim=0) * n),
            "tmajor_roundtrip": rel_err(torch.complex(br, bi) / n, z),
            "bmajor_fwd": rel_err(yb, ref.T),
            "bmajor_bwd": rel_err(bb, torch.fft.ifft(yb, dim=-1) * n),
            "real_tmajor_fwd": rel_err(torch.complex(sr, si), packed),
            "real_tmajor_roundtrip": rel_err(xb / n, x),
            "real_bmajor_fwd": rel_err(s, packed.T),
            "real_bmajor_roundtrip": rel_err(xb2 / n, x.T),
        }
        typed = (yr.dtype == sr.dtype == xb.dtype == xb2.dtype == torch.float64
                 and yb.dtype == s.dtype == torch.complex128)
        emit({"phase": "f64", "n": n, "b": b, "typed": typed,
              **{k + "_rel_err": v for k, v in errs.items()}})
        check(typed, f"f64 N={n}: output dtypes")
        check(max(errs.values()) <= F64_TOL, f"f64 N={n}: errors {errs}")
        # complex: two f64 planes read and written; real: the [N, B] signal
        # read, two [N/2, B] planes written
        cb = bound(32.0 * n * b, fft_flops(n, b))
        rb = bound(16.0 * n * b, fft_flops(n // 2, b) + 16.0 * (n // 2) * b)
        rec = {"phase": "f64_time", "n": n, "b": b, "engine": D.select_engine(plan, b),
               "tmajor_fwd_ms": time_ms(lambda: pt.transform_ordered_split_tmajor(
                   plan, (re, im)), inner=2),
               "bmajor_fwd_ms": time_ms(lambda: pt.transform_ordered(plan, zb), inner=2),
               "real_tmajor_fwd_ms": time_ms(lambda: pt.transform_ordered_split_tmajor(
                   rplan, x), inner=2),
               "library_tmajor_ms": time_ms(lambda: torch.fft.fft(z, dim=0)),
               "library_bmajor_ms": time_ms(lambda: torch.fft.fft(zb, dim=-1)),
               "library_real_tmajor_ms": time_ms(lambda: torch.fft.rfft(x, dim=0)),
               "bound_ms": cb[0], "bound_by": cb[1], "real_bound_ms": rb[0]}
        emit(rec)
        del re, im, z, zb, ref, y, yr, yi, br, bi, yb, bb, rref, packed, sr, si, xb, s, xb2
    for n in (4096, 65536):
        dbs = {"tmajor": carrier_db(n, dtype="float64"),
               "bmajor": carrier_db(n, bmajor=True, dtype="float64"),
               "real_tmajor": real_carrier_db(n, dtype="float64"),
               "real_bmajor": real_carrier_db(n, bmajor=True, dtype="float64")}
        emit({"phase": "f64", "carrier_n": n, "dynamic_range_db": dbs})
        check(min(dbs.values()) >= F64_CARRIER_DB, f"f64 N={n}: carrier dynamic range {dbs}")
    # one float64 FastConv run: the "tmajor" route on the stage engine
    h = pt.design_lowpass(FLAG_TAPS, 0.1)
    fc = C.FastConv(h, dtype="float64")
    x = torch.randn((FLAG_ROWS, FLAG_LEN), **f64)
    y = fc.apply_batched(x)
    torch.cuda.synchronize()
    err = max(rel_err(y[r], conv_oracle(x[r], h)) for r in (0, FLAG_ROWS - 1))
    ms = time_ms(lambda: fc.apply_batched(x), inner=1)
    emit({"phase": "f64", "fastconv": list(x.shape), "taps": FLAG_TAPS, "nfft": fc.nfft,
          "dtype": str(y.dtype), "oracle_rel_err": err, "ms": ms})
    check(y.dtype == torch.float64 and y.shape == (FLAG_ROWS, FLAG_LEN - FLAG_TAPS + 1)
          and err <= F64_TOL, f"f64 FastConv: {y.dtype} {tuple(y.shape)}, error {err}")
    delta = launched(counts(), c0)
    emit({"phase": "f64", "f32_kernel_launches": delta})
    check(delta == {}, f"float64 calls launched f32 kernels: {delta}")


def check_fp32_matmul() -> None:
    """The CIC's and the resampler's banded products run in full fp32."""

    prec = torch.get_float32_matmul_precision()
    emit({"phase": "fp32", "float32_matmul_precision": prec,
          "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    check(prec == "highest" and not torch.backends.cuda.matmul.allow_tf32,
          f"float32 matmuls are not full fp32: precision {prec!r}")


def exact_phase(phase_fp: int, rate_fp: int, n: int) -> torch.Tensor:
    """The NCO's phase of samples 0..n-1 in turns, float64, from the exact
    fixed-point phase (phase_fp + k*rate_fp) mod 2^32."""

    k = torch.arange(n, dtype=torch.int64, device=DEV)
    return ((k * rate_fp + phase_fp) & 0xFFFFFFFF).double() / 2.0 ** 32


def time_once(fn) -> float:
    """ms of one call (CUDA events), after one call of warm-up."""

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def phase_dsp(gen):
    """The PFDSP chain (BASELINE.json config #4) at full size: the NCO mixer,
    the CIC downconverter and DDCChain against float64 oracles, the ALGO
    C/E/I wrappers and the carriers against the port's own CPU result;
    times beside their bounds.  Returns the launch counts of the run."""

    check_fp32_matmul()
    reset_counts()
    dsp = pt.dsp
    # the mixer: one NCO over 2^22 samples, then over a 16-channel stream
    st = dsp.mixer_init(MIX_RATE, 0.7)
    car = torch.exp(2j * math.pi * exact_phase(st.phase_fp, st.rate_fp, MIX_N))
    xr, xi = planes(MIX_CHANNELS, MIX_N, gen)
    for name, (ar, ai) in (("mixer_shift", (xr[0], xi[0])), ("mixer_multichannel", (xr, xi))):
        (yr, yi), st2 = dsp.mixer_apply_split(st, ar, ai)
        torch.cuda.synchronize()
        rows = (0,) if ar.ndim == 1 else (0, MIX_CHANNELS - 1)
        pick = (lambda t, r: t) if ar.ndim == 1 else (lambda t, r: t[r])
        err = max(rel_err(torch.complex(pick(yr, r), pick(yi, r)).to(torch.complex128),
                          torch.complex(pick(ar, r), pick(ai, r)).to(torch.complex128) * car)
                  for r in rows)
        ms = time_ms(lambda: dsp.mixer_apply_split(st, ar, ai))
        # where the time goes: the carrier (the int64 phase, its angle, cos, sin)
        angles = lambda: dsp.mixer.nco_angles(st.phase_fp, st.rate_fp, MIX_N, ar.device)
        carrier_ms = time_ms(lambda: (lambda a: (torch.cos(a), torch.sin(a)))(angles()))
        # both planes read once, both written once
        bnd = bound(16.0 * ar.numel(), 8.0 * ar.numel())
        emit({"phase": "dsp", "call": name, "shape": list(ar.shape), "oracle_rel_err": err,
              "ms": ms, "carrier_ms": carrier_ms,
              "bound_ms": bnd[0], "bound_by": bnd[1], "frac_bound": bnd[0] / ms,
              "msamples_per_s": ar.numel() / ms / 1e3, "library_ms": None,
              "next_phase_fp": st2.phase_fp})
        check(err <= MIXER_TOL, f"{name}: oracle error {err}")
        check(st2.phase_fp == (st.phase_fp + MIX_N * st.rate_fp) & 0xFFFFFFFF,
              f"{name}: next phase {st2.phase_fp}")
    del xr, xi, yr, yi, car
    # the CIC: two chunks with the state carried, against the float64 mix
    # convolved with the triple boxcar, taken at stride R
    for n in CIC_NS:
        xr, xi = planes(1, n, gen)
        xr, xi = xr[0], xi[0]
        rate_fp = int(round(MIX_RATE * 2.0 ** 32)) & 0xFFFFFFFF
        ph = exact_phase(0, rate_fp, n) * (2 * math.pi)
        mixed = torch.complex(xr.double(), xi.double()) * torch.complex(-torch.sin(ph),
                                                                         torch.cos(ph))
        del ph
        for r in CIC_FACTORS:
            cic = dsp.CicDDC(r, device=DEV)
            cst = cic.init_state()
            outs = []
            for half in (slice(0, n // 2), slice(n // 2, n)):
                (yr, yi), cst = cic.apply_split(cst, xr[half], xi[half], MIX_RATE)
                outs.append(torch.complex(yr, yi))
            y = torch.cat(outs)
            # the full convolution: the valid part of the zero-prefixed stream
            full = conv_oracle(torch.cat([mixed.new_zeros(3 * r - 3), mixed]), cic.b3_rev[::-1])
            ref = full[r - 3 :: r][: n // r] / r ** 3
            err = rel_err(y.to(torch.complex128), ref)
            ms = time_ms(lambda: cic.apply_split(cic.init_state(), xr, xi, MIX_RATE), inner=2)
            rows_n = -(-(n // r) // cic.BLOCK_S)
            # where the time goes: the overlapping rows' copy and the product
            ext = torch.randn((2, r * rows_n * cic.BLOCK_S + 2 * r), generator=gen, device=DEV)
            view = ext.unfold(1, (cic.BLOCK_S + 2) * r, cic.BLOCK_S * r)
            rows = view.reshape(-1, (cic.BLOCK_S + 2) * r)
            parts = {"rows_ms": time_ms(lambda: view.reshape(-1, (cic.BLOCK_S + 2) * r)),
                     "matmul_ms": time_ms(lambda: torch.matmul(rows, cic._weight(rows.device)))}
            del ext, view, rows
            # the bound: both planes read once and the outputs written once,
            # against the function's own operations (the mix, and 3R-2 taps
            # an output a plane); the banded product's dense FLOPs, zeros
            # included, are printed beside it
            mm_flops = 2.0 * 2 * rows_n * (cic.BLOCK_S + 2) * r * cic.BLOCK_S
            bnd = bound(4.0 * (2 * n + 2 * n // r), 6.0 * n + 2 * 2.0 * (3 * r - 2) * (n // r))
            emit({"phase": "dsp", "call": "cic_ddc", "factor": r, "samples": n,
                  "out_shape": list(y.shape), "oracle_rel_err": err, "ms": ms, **parts,
                  "bound_ms": bnd[0], "bound_by": bnd[1], "frac_bound": bnd[0] / ms,
                  "bytes_ms": 4.0 * (2 * n + 2 * n // r) / HBM_BYTES_PER_S * 1e3,
                  "matmul_fp32_ms": mm_flops / F32_FLOPS_PER_S * 1e3,
                  "msamples_per_s": n / ms / 1e3, "library_ms": None})
            check(y.shape == (n // r,) and bool(torch.isfinite(torch.view_as_real(y)).all()),
                  f"CIC R={r} n={n}: output not finite/shaped")
            check(err <= ORACLE_TOL, f"CIC R={r} n={n}: oracle error {err}")
            del y, full, ref, outs
        del xr, xi, mixed
    # DDCChain: two chunks of 2^24 with the state carried, against the
    # float64 mix convolved with the taps by a complex128 FFT, decimated
    x = torch.complex(*planes(1, 2 * DDC_N, gen))[0]
    ddc_runs = []
    for taps, dtype in [(t, "float32") for t in DDC_TAPS] + [(DDC_TAPS[0], "float64")]:
        h = pt.design_lowpass(taps, 0.5 / DDC_DECIM)
        ddc = CH.DDCChain(DDC_RATE, h, DDC_DECIM, dtype=dtype, device=DEV)
        chunks = 2 if dtype == "float32" else 1
        ref_n = chunks * DDC_N
        dst = ddc.init_state()
        outs, deltas = [], []
        for j in range(chunks):
            c0 = counts()
            y, dst = ddc.process(dst, x[j * DDC_N:(j + 1) * DDC_N])
            torch.cuda.synchronize()
            deltas.append(launched(counts(), c0))
            outs.append(y)
        y = torch.cat(outs)
        st0 = ddc.init_state().mixer
        car = torch.exp(2j * math.pi * exact_phase(st0.phase_fp, st0.rate_fp, ref_n))
        mixed = x[:ref_n].to(torch.complex128) * car
        del car
        ref = conv_oracle(torch.cat([mixed.new_zeros(taps - 1), mixed]), h)[::DDC_DECIM]
        del mixed
        err = rel_err(y.to(torch.complex128), ref)
        want_dtype = torch.complex64 if dtype == "float32" else torch.complex128
        want_launches = {"zconv_stream": 1} if dtype == "float32" else {}
        rec = {"phase": "dsp", "call": "ddc_chain", "taps": taps, "decim": DDC_DECIM,
               "dtype": dtype, "nfft": ddc.conv.nfft, "chunks": chunks, "chunk": DDC_N,
               "route": ddc.conv._route(torch.device(DEV), stream=True), "oracle_rel_err": err,
               "launches_per_chunk": deltas}
        check(y.shape == (ref_n // DDC_DECIM,) and y.dtype == want_dtype,
              f"DDCChain {taps} {dtype}: output {tuple(y.shape)} {y.dtype}")
        check(err <= ORACLE_TOL, f"DDCChain {taps} {dtype}: oracle error {err}")
        check(all(d == want_launches for d in deltas),
              f"DDCChain {taps} {dtype}: launches {deltas}, expected {want_launches}")
        if dtype == "float32":
            ddc_runs.append((rec, ddc))  # timed after the launch counts are read
        else:
            rec["ms_one_call"] = time_once(lambda: ddc.process(ddc.init_state(), x[:DDC_N]))
            emit(rec)
        del y, ref, outs
    # the ALGO C/E/I wrappers and the carriers on the card against the
    # port's CPU result
    xa = torch.complex(*planes(1, ALGO_N, gen))[0]
    xc = xa.cpu()
    algo = {
        "C": lambda dv, xx: dsp.shift_addfast_cc(xx, dsp.shift_addfast_init(0.0123), 0.4)[0],
        "E": lambda dv, xx: dsp.shift_limited_unroll_cc(
            xx, dsp.shift_limited_unroll_init(0.0123, 0.4)),
        "I": lambda dv, xx: dsp.shift_recursive_osc_cc(
            xx, dsp.shift_recursive_osc_init(0.0123, 0.4)),
        "I_gen": lambda dv, xx: dsp.gen_recursive_osc_c(
            ALGO_N, dsp.shift_recursive_osc_init(0.0123, 0.4), device=dv),
    }
    errs = {}
    for name, fn in algo.items():
        got, want = fn(DEV, xa), fn("cpu", xc)
        errs[name] = rel_err(got.cpu(), want)
    carriers_equal = all(
        torch.equal(getattr(dsp, c)(ALGO_N, device=DEV).cpu(),
                    getattr(dsp, c)(ALGO_N, device="cpu"))
        for c in dsp.carrier.__all__)
    emit({"phase": "dsp", "call": "algo_c_e_i", "n": ALGO_N, "rel_err_vs_cpu": errs,
          "carriers_equal_cpu": carriers_equal})
    check(max(errs.values()) <= KERNEL_TOL and carriers_equal,
          f"ALGO C/E/I on the card vs the CPU: {errs}, carriers equal {carriers_equal}")
    launches = counts()
    emit({"phase": "dsp", "launches": launches})
    check(launches["zconv_stream"] > 0, f"DDCChain did not launch zconv_stream: {launches}")
    xc = x[:DDC_N]
    for rec, ddc in ddc_runs:
        st1 = ddc.init_state()
        ms = time_ms(lambda: ddc.process(st1, xc), inner=2)
        # the bound: the chunk read once, the decimated output written once,
        # against the mix's operations; the filter's least operations depend
        # on the algorithm, so the overlap-save blocks' transforms on both
        # rows (every output, before the decimation) are printed beside it
        cols = -(-DDC_N // ddc.conv.num_out_per_block)
        bnd = bound(8.0 * DDC_N * (1 + 1 / DDC_DECIM), 6.0 * DDC_N)
        os_flops = 2 * fft_flops(ddc.conv.nfft, cols) + 6.0 * ddc.conv.nfft * cols
        # where the time goes: the mixer, and the lowpass on [I; Q] (one
        # launch of B7's stream map)
        ext = torch.randn((2, DDC_N + ddc.filter_len - 1), generator=gen, device=DEV)
        rec.update(ms=ms, bound_ms=bnd[0], bound_by=bnd[1], frac_bound=bnd[0] / ms,
                   overlap_save_fp32_ms=os_flops / F32_FLOPS_PER_S * 1e3,
                   msamples_per_s=DDC_N / ms / 1e3, library_ms=None,
                   mixer_ms=time_ms(lambda: dsp.mixer_apply_split(st1.mixer, xc.real, xc.imag)),
                   conv_ms=time_ms(lambda: ddc.conv._conv_stream(ext, DDC_N)))
        emit(rec)
        del ext
    del x, xc, ddc_runs
    torch.cuda.empty_cache()
    return launches


def stft_oracle(x: torch.Tensor, n_fft: int, hop: int, w: np.ndarray) -> torch.Tensor:
    """Packed [..., K, H] complex128 STFT: ``torch.fft.rfft`` of the
    windowed frames in float64, bin0 = DC + i*Nyquist."""

    fr = x.double().unfold(-1, n_fft, hop) * torch.from_numpy(w.astype(np.float64)).to(x.device)
    full = torch.fft.rfft(fr, dim=-1)
    h = n_fft // 2
    packed = full[..., :h].clone()
    packed[..., 0] = torch.complex(full[..., 0].real, full[..., h].real)
    return packed


def phase_spectral(gen):
    """The STFT front end and the resampler at full size: ``stft_split`` by
    both routes and ``stft_split_tmajor`` on a 64 MB signal (n_fft 1024 and
    8192), an ``istft`` round trip, ``welch_psd`` and ``Resampler(3, 2,
    16)``, against float64 / complex128 oracles; launch counts per call;
    times beside their bounds and ``torch.stft``.  Returns the launch counts
    of the run."""

    check_fp32_matmul()
    reset_counts()
    sp = pt.spectral
    x = torch.randn(STFT_SHAPE, generator=gen, device=DEV)
    rows, length = STFT_SHAPE
    runs = []
    for n_fft in (STFT_NFFT, STFT_BIG_NFFT):
        hop = STFT_HOP if n_fft == STFT_NFFT else n_fft // 2
        w = sp.hann(n_fft)
        ref = stft_oracle(x, n_fft, hop, w)
        k, h = ref.shape[-2], n_fft // 2
        for route in ("bmajor", "tmajor", "tmajor_out"):
            sp._TMAJOR_STFT = route != "bmajor"
            c0 = counts()
            if route == "tmajor_out":
                sr, si = sp.stft_split_tmajor(x, n_fft, hop)
                sr, si = sr.permute(1, 2, 0), si.permute(1, 2, 0)
            else:
                sr, si = sp.stft_split(x, n_fft, hop)
            torch.cuda.synchronize()
            delta = launched(counts(), c0)
            sp._TMAJOR_STFT = None
            err = rel_err(torch.complex(sr.double(), si.double()), ref)
            emit({"phase": "spectral", "call": "stft", "route": route, "n_fft": n_fft,
                  "hop": hop, "shape": list(x.shape), "out_shape": list(sr.shape),
                  "oracle_rel_err": err, "launches": delta})
            check(sr.shape == (rows, k, h) and bool(torch.isfinite(sr).all()),
                  f"STFT {route} n_fft={n_fft}: output not finite/shaped {tuple(sr.shape)}")
            check(err <= ORACLE_TOL, f"STFT {route} n_fft={n_fft}: oracle error {err}")
            if n_fft <= 4096:
                want = ("cfft_fused2", "real_split") if route == "bmajor" else (
                    "rfft_chain_tmajor_fused",)
                check(all(delta.get(name, 0) > 0 for name in want),
                      f"STFT {route} n_fft={n_fft}: launches {delta}, expected {want}")
            runs.append((n_fft, hop, route))
            del sr, si
        del ref
    # the round trip and the PSD at bench_pipeline's shape
    s = sp.stft(x, STFT_NFFT, STFT_HOP)
    c0 = counts()
    y = sp.istft(s, STFT_HOP, length=length)
    torch.cuda.synchronize()
    d_istft = launched(counts(), c0)
    core = slice(STFT_NFFT, length - STFT_NFFT)
    e_rt = rel_err(y[:, core], x[:, core])
    psd = sp.welch_psd(x, STFT_NFFT, STFT_HOP)
    w64 = torch.from_numpy(sp.hann(STFT_NFFT).astype(np.float64)).to(DEV)
    full = torch.fft.rfft(x.double().unfold(-1, STFT_NFFT, STFT_HOP) * w64, dim=-1)
    psd_ref = (full.abs() ** 2).mean(dim=-2) / float((w64 ** 2).sum())
    e_psd = rel_err(psd.double(), psd_ref)
    del full
    emit({"phase": "spectral", "call": "istft_welch", "roundtrip_rel_err": e_rt,
          "welch_rel_err": e_psd, "istft_launches": d_istft, "istft_shape": list(y.shape),
          "psd_shape": list(psd.shape)})
    check(y.shape == x.shape and e_rt <= ROUND_TRIP_TOL, f"istft: {tuple(y.shape)}, {e_rt}")
    check(psd.shape == (rows, STFT_NFFT // 2 + 1) and e_psd <= ORACLE_TOL,
          f"welch_psd: {tuple(psd.shape)}, {e_psd}")
    check(all(d_istft.get(n, 0) > 0 for n in ("cfft_fused2", "real_split")),
          f"istft launches {d_istft}, expected cfft_fused2 and real_split")
    # the resampler against the float64 zero-stuff, FFT convolution, stride M
    rs = pt.resample.Resampler(RESAMPLE_UP, RESAMPLE_DOWN, RESAMPLE_TAPS, device=DEV)
    yr = rs(x)
    torch.cuda.synchronize()
    n_out = length * rs.up // rs.down
    proto = rs.taps_rev[::-1].reshape(-1)
    e_rs = 0.0
    for r in (0, rows - 1):
        u = torch.zeros(length * rs.up, dtype=torch.complex128, device=DEV)
        u[:: rs.up] = x[r].double()
        ref = conv_oracle(torch.cat([u.new_zeros(proto.size - 1), u]), proto)[:: rs.down][:n_out]
        e_rs = max(e_rs, rel_err(yr[r].to(torch.complex128), ref))
        del u, ref
    emit({"phase": "spectral", "call": "resample", "up": rs.up, "down": rs.down,
          "taps_per_phase": rs.p, "out_shape": list(yr.shape), "oracle_rel_err": e_rs})
    check(yr.shape == (rows, n_out) and e_rs <= ORACLE_TOL,
          f"resampler: {tuple(yr.shape)}, oracle error {e_rs}")
    launches = counts()
    emit({"phase": "spectral", "launches": launches})
    for name in ("rfft_chain_tmajor_fused", "cfft_fused2", "real_split"):
        check(launches[name] > 0, f"spectral path did not launch {name}: {launches}")
    del s, y, yr, psd
    # times: each call at its shape, beside its bound and torch.stft
    for n_fft, hop, route in runs:
        w = torch.from_numpy(sp.hann(n_fft)).to(DEV)
        k = (length - n_fft) // hop + 1
        if route == "tmajor_out":
            fn = lambda: sp.stft_split_tmajor(x, n_fft, hop)
        else:
            fn = lambda: sp.stft_split(x, n_fft, hop)
        sp._TMAJOR_STFT = route != "bmajor"
        ms = time_ms(fn, inner=2)
        sp._TMAJOR_STFT = None
        # where the time goes: the windowed frames, the transform and (public
        # layout, time-major) the two transposes back
        plan = pt.new_setup(n_fft, pt.REAL)
        wv = w.reshape(n_fft, 1, 1)
        if route == "bmajor":
            frame = lambda: sp.frame_signal(x, n_fft, hop) * w
            fr = frame()
            parts = {"frame_ms": time_ms(frame, inner=2),
                     "transform_ms": time_ms(lambda: pt.transform_ordered_split(plan, fr),
                                             inner=2)}
        else:
            frame = lambda: sp.frame_signal(x, n_fft, hop).movedim(-1, 0) * wv
            fr = frame().reshape(n_fft, -1)
            sr, si = pt.transform_ordered_split_tmajor(plan, fr)
            parts = {"frame_ms": time_ms(frame, inner=2),
                     "transform_ms": time_ms(lambda: pt.transform_ordered_split_tmajor(plan, fr),
                                             inner=2)}
            if route == "tmajor":
                sr, si = sr.reshape(-1, rows, k), si.reshape(-1, rows, k)
                parts["transpose_ms"] = time_ms(
                    lambda: (sr.movedim(0, -1).contiguous(), si.movedim(0, -1).contiguous()),
                    inner=2)
            del sr, si
        del fr
        # the signal read once, the packed spectrum planes written once
        bnd = bound(4.0 * x.numel() + 8.0 * rows * k * (n_fft // 2),
                    fft_flops(n_fft // 2, rows * k) + 16.0 * (n_fft // 2) * rows * k)
        lib = time_ms(lambda: torch.stft(x, n_fft, hop_length=hop, window=w, center=False,
                                         onesided=True, return_complex=True), inner=2)
        emit({"phase": "spectral_time", "call": "stft", "route": route, "n_fft": n_fft,
              "hop": hop, "ms": ms, **parts, "bound_ms": bnd[0], "bound_by": bnd[1],
              "frac_bound": bnd[0] / ms, "msamples_per_s": x.numel() / ms / 1e3,
              "library_ms": lib, "library": "torch.stft(center=False, onesided=True, "
                                            "return_complex=True), unpacked bins"})
    sp._TMAJOR_STFT = None
    s = sp.stft(x, STFT_NFFT, STFT_HOP)
    k = s.shape[-2]
    ms_istft = time_ms(lambda: sp.istft(s, STFT_HOP, length=length), inner=2)
    b_istft = bound(8.0 * rows * k * (STFT_NFFT // 2) + 4.0 * x.numel(),
                    fft_flops(STFT_NFFT // 2, rows * k))
    ms_welch = time_ms(lambda: sp.welch_psd(x, STFT_NFFT, STFT_HOP), inner=2)
    b_welch = bound(4.0 * x.numel(), fft_flops(STFT_NFFT // 2, rows * k))
    ms_rs = time_ms(lambda: rs(x), inner=2)
    # the resampler's bound: the signal read once, the output written once,
    # against P taps an output; the banded product's dense FLOPs beside it
    jn = -(-n_out // (rs.g_blk * rs.up))
    mm_flops = 2.0 * rows * jn * rs.w_frame * rs.g_blk * rs.up
    b_rs = bound(4.0 * (x.numel() + rows * n_out), 2.0 * rs.p * rows * n_out)
    emit({"phase": "spectral_time", "istft_ms": ms_istft, "istft_bound_ms": b_istft[0], "istft_bound_by": b_istft[1],
          "welch_ms": ms_welch, "welch_bound_ms": b_welch[0], "welch_bound_by": b_welch[1],
          "resample_ms": ms_rs, "resample_bound_ms": b_rs[0], "resample_bound_by": b_rs[1],
          "resample_bytes_ms": 4.0 * (x.numel() + rows * n_out) / HBM_BYTES_PER_S * 1e3,
          "resample_matmul_fp32_ms": mm_flops / F32_FLOPS_PER_S * 1e3,
          "resample_msamples_per_s": x.numel() / ms_rs / 1e3, "library_ms": None})
    del x, s
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Any-length transforms, N-D, DCT/DST, the partitioned convolution, Fft
# ---------------------------------------------------------------------------


def any_rows(b: int) -> torch.Tensor:
    """ORACLE_ROWS rows spread over a batch of b."""

    return torch.arange(0, b, max(1, b // ORACLE_ROWS), device=DEV)[:ORACLE_ROWS]


def drive(name: str, fn, want, phase: str = "anylen"):
    """Run ``fn`` with every count at 0 and read the counts just after;
    fails unless each wrapper named in ``want`` launched.  Returns (fn's
    result, the counts)."""

    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = counts()
    emit({"phase": phase, "path": name, "launches": launched(got, {k: 0 for k in got})})
    check(all(got[w] > 0 for w in want), f"{name}: launches {got}, expected {want}")
    return out, got


def hold_oracle(name: str, err: float, tol: float = ORACLE_TOL, **extra) -> None:
    emit({"phase": "anylen", "path": name, "oracle_rel_err": err, **extra})
    check(math.isfinite(err) and err <= tol, f"{name}: oracle error {err} > {tol}")


def cplx(re, im) -> torch.Tensor:
    return torch.complex(re.double(), im.double())


def dct_oracle(name: str, x: torch.Tensor) -> torch.Tensor:
    """FFTPACK's DCT-I/DST-I/DCT-II/DCT-III of the rows of x as a float64
    matrix product, the phases reduced exactly in integers."""

    n = x.shape[-1]
    j = torch.arange(n, dtype=torch.int64, device=x.device)
    k = j[:, None]
    w = torch.full((n,), 2.0, dtype=torch.float64, device=x.device)
    trig = torch.cos
    if name == "dct1":
        period, e = 2 * (n - 1), j[None, :] * k
        w[0] = w[-1] = 1.0
    elif name == "dst1":
        period, e, trig = 2 * (n + 1), (j[None, :] + 1) * (k + 1), torch.sin
    elif name == "dct2":
        period, e = 4 * n, k * (2 * j[None, :] + 1)
    else:  # dct3
        period, e = 4 * n, j[None, :] * (2 * k + 1)
        w[0] = 1.0
    mat = trig((e % period).double() * (2.0 * math.pi / period)) * w[None, :]
    return x.double() @ mat.T


def czt_oracle(x: torch.Tensor, cp) -> torch.Tensor:
    """sum_j x[j] A^-j W^jk of the rows of x, complex128."""

    j = torch.arange(cp.n, dtype=torch.float64, device=x.device)
    k = torch.arange(cp.m_out, dtype=torch.float64, device=x.device)[:, None]
    turns = cp.a_phase * j[None, :] + cp.w_phase * (k * j[None, :])
    return x.to(torch.complex128) @ torch.exp(-2j * math.pi * turns).T


def stream_oracle(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """np.convolve(x, h)[:len(x)] of one stream (zero history), float64."""

    return conv_oracle(torch.cat([x.new_zeros(h.size - 1), x]), h)


def phase_anylen(gen):
    """The transform family past the 2/3/5-smooth size contract and
    long-FIR streaming, at the full sizes of bench_pipeline's
    bluestein_prime, zoom_czt, fft2 and pconv_fdl: Bluestein at N = 4099 (B9
    at M = 8640) and 12289 (kern2 at M = 25600), ``rfft_any``,
    ``zoom_fft`` / ``czt_split``, 2-D ``fftn_split``, DCT/DST, the
    partitioned convolution at P = 94 and 8 and the ``Fft`` object, each
    path driven with the counts at 0 and held to a float64 / complex128
    oracle; one float64 case per module, no f32 kernel launched.  Returns
    the launch counts of each path."""

    check_fp32_matmul()
    paths = []
    # Bluestein, both directions, on [B, N] planes
    for n, b, want in ((BS_N, BS_B, ("cfft_fused2",)),
                       (BS_TMAJOR_N, BS_TMAJOR_B, ("cfft_chain_tmajor", "cfft_combine_tmajor"))):
        plan = pt.new_setup_any(n)
        re, im = planes(b, n, gen)
        (fwd, bwd), got = drive(f"bluestein N={n}", lambda: (
            pt.transform_ordered_split(plan, (re, im)),
            pt.transform_ordered_split(plan, (re, im), pt.BACKWARD)), want)
        paths.append(got)
        z = cplx(re, im)
        ref = torch.fft.fft(z, dim=-1)
        e_fwd = rel_err(cplx(*fwd), ref)
        del ref
        e_bwd = rel_err(cplx(*bwd), torch.fft.ifft(z, dim=-1) * n)
        hold_oracle(f"bluestein N={n}", max(e_fwd, e_bwd), m=plan.m, b=b, fwd=e_fwd, bwd=e_bwd,
                    engine=D.select_engine(plan.inner, b, False, torch.device(DEV)))
        check(fwd[0].shape == (b, n), f"bluestein N={n}: shape {tuple(fwd[0].shape)}")
        del re, im, z, fwd, bwd
    # rfft_any: Bluestein at N = 4099, the real plan (B9 at H, B6) at 4096
    for n in RFFT_ANY_NS:
        x = torch.randn((RFFT_ANY_B, n), generator=gen, device=DEV)
        want = ("cfft_fused2", "real_split") if n % 2 == 0 else ("cfft_fused2",)
        s, got = drive(f"rfft_any N={n}", lambda: pt.rfft_any(x), want)
        paths.append(got)
        back = pt.irfft_any(s, n)
        hold_oracle(f"rfft_any N={n}", rel_err(s.to(torch.complex128),
                                              torch.fft.rfft(x.double(), dim=-1)),
                    roundtrip=rel_err(back / n, x))
        check(s.shape == (RFFT_ANY_B, n // 2 + 1) and rel_err(back / n, x) <= ROUND_TRIP_TOL,
              f"rfft_any N={n}: {tuple(s.shape)}")
        del x, s, back
    # zoom_fft and czt_split (B9 at M = 4608), oracle on sampled rows
    cp = pt.zoom_fft_setup(ZOOM_N, ZOOM_F, ZOOM_M)
    re, im = planes(ZOOM_B, ZOOM_N, gen)
    (zoom, (zr, zi)), got = drive("zoom", lambda: (
        pt.zoom_fft(re, ZOOM_F, ZOOM_M), pt.czt_split(cp, (re, im))), ("cfft_fused2",))
    paths.append(got)
    rows = any_rows(ZOOM_B)
    e_zoom = rel_err(zoom[rows].to(torch.complex128), czt_oracle(re[rows], cp))
    e_czt = rel_err(cplx(zr, zi)[rows], czt_oracle(cplx(re, im)[rows], cp))
    hold_oracle("zoom", max(e_zoom, e_czt), m=cp.m, zoom=e_zoom, czt=e_czt)
    check(zr.shape == (ZOOM_B, ZOOM_M), f"czt_split: shape {tuple(zr.shape)}")
    del re, im, zoom, zr, zi
    # 2-D fftn_split, both directions
    nd = pt.fftn_setup(FFT2_SHAPE[-2:])
    re = torch.randn(FFT2_SHAPE, generator=gen, device=DEV)
    im = torch.randn(FFT2_SHAPE, generator=gen, device=DEV)
    (fwd, bwd), got = drive("fftn_split", lambda: (
        pt.fftn_split(nd, (re, im)), pt.fftn_split(nd, (re, im), pt.BACKWARD)),
        ("cfft_fused2",))
    paths.append(got)
    z = cplx(re, im)
    e_fwd = rel_err(cplx(*fwd), torch.fft.fft2(z))
    e_bwd = rel_err(cplx(*bwd), torch.fft.ifft2(z) * nd.size)
    hold_oracle("fftn_split", max(e_fwd, e_bwd), fwd=e_fwd, bwd=e_bwd)
    del re, im, z, fwd, bwd
    # DCT/DST: B9 at N = 4096 (dct2, dct3) and 8192 (dct1, dst1)
    xq = torch.randn(DCT_SHAPE, generator=gen, device=DEV)
    x1 = torch.randn((DCT_I_B, DCT1_N), generator=gen, device=DEV)
    xs = torch.randn((DCT_I_B, DST1_N), generator=gen, device=DEV)
    outs, got = drive("dct", lambda: {"dct2": pt.dct2(xq), "dct3": pt.dct3(xq),
                                      "dct1": pt.dct1(x1), "dst1": pt.dst1(xs)},
                      ("cfft_fused2",))
    paths.append(got)
    errs = {}
    for name, x in (("dct2", xq), ("dct3", xq), ("dct1", x1), ("dst1", xs)):
        rows = any_rows(x.shape[0])
        errs[name] = rel_err(outs[name][rows].double(), dct_oracle(name, x[rows]))
    hold_oracle("dct", max(errs.values()), **errs)
    del xq, x1, xs, outs
    # the partitioned convolution, two calls with the state carried
    for taps in PCONV_TAPS:
        h = np.random.default_rng(SEED + taps).standard_normal(taps).astype(np.float32) * 0.01
        pc = pt.PartitionedConv(h, PCONV_BLOCK, device=DEV)
        n = PCONV_BLOCKS * PCONV_BLOCK
        x = torch.randn((PCONV_CH, 2 * n), generator=gen, device=DEV)

        def run():
            st = pc.init_state((PCONV_CH,))
            y1, st = pc.process(st, x[:, :n])
            y2, st = pc.process(st, x[:, n:])
            return torch.cat([y1, y2], dim=-1)

        y, got = drive(f"pconv taps={taps}", run, ("cfft_fused2", "real_split"))
        paths.append(got)
        err = max(rel_err(y[r].double(), stream_oracle(x[r].double(), h))
                  for r in (0, PCONV_CH - 1))
        hold_oracle(f"pconv taps={taps}", err, parts=pc.parts, block=PCONV_BLOCK)
        del x, y
    # the Fft object: a real and a complex setup, each equal to
    # transform_ordered on the same input
    fr = pt.Fft(np.float32, FFT_REAL_N, device=DEV)
    fc = pt.Fft(np.complex64, FFT_CPLX_N, device=DEV)
    xr = torch.randn((FFT_REAL_B, FFT_REAL_N), generator=gen, device=DEV)
    xc = torch.complex(*planes(FFT_CPLX_B, FFT_CPLX_N, gen))
    (sr, br, sc, bc), got = drive("Fft", lambda: (
        fr.forward(xr), fr.inverse(fr.forward(xr)), fc.forward(xc), fc.inverse(fc.forward(xc))),
        ("cfft_fused2", "real_split"))
    paths.append(got)
    same = bool(torch.equal(sr, pt.transform_ordered(fr.plan, xr))
                and torch.equal(sc, pt.transform_ordered(fc.plan, xc)))
    e_r = rel_err(pt.spectrum_unpack(sr).to(torch.complex128), torch.fft.rfft(xr.double(), dim=-1))
    e_c = rel_err(sc.to(torch.complex128), torch.fft.fft(xc.to(torch.complex128), dim=-1))
    e_rt = max(rel_err(br / FFT_REAL_N, xr), rel_err(bc / FFT_CPLX_N, xc))
    hold_oracle("Fft", max(e_r, e_c), real=e_r, complex=e_c, roundtrip=e_rt,
                equals_transform_ordered=same)
    check(same and e_rt <= ROUND_TRIP_TOL, f"Fft: equal {same}, round trip {e_rt}")
    del xr, xc, sr, br, sc, bc
    # float64, one shape per module: the stage engine, no f32 kernel
    reset_counts()
    f64 = {"dtype": torch.float64, "device": DEV, "generator": gen}
    e64 = {}
    re, im = torch.randn((64, BS_N), **f64), torch.randn((64, BS_N), **f64)
    e64["bluestein"] = rel_err(cplx(*pt.transform_ordered_split(
        pt.new_setup_any(BS_N, dtype="float64"), (re, im))), torch.fft.fft(cplx(re, im), dim=-1))
    re, im = torch.randn((4, 512, 512), **f64), torch.randn((4, 512, 512), **f64)
    e64["fftn"] = rel_err(cplx(*pt.fftn_split(pt.fftn_setup((512, 512), "float64"), (re, im))),
                          torch.fft.fft2(cplx(re, im)))
    x = torch.randn((ORACLE_ROWS, DCT_SHAPE[1]), **f64)
    e64["dct2"] = rel_err(pt.dct2(x), dct_oracle("dct2", x))
    h = np.random.default_rng(SEED).standard_normal(PCONV_TAPS[1]) * 0.01
    pc = pt.PartitionedConv(h, PCONV_BLOCK, dtype="float64", device=DEV)
    x = torch.randn((2, 16 * PCONV_BLOCK), **f64)
    y, _ = pc.process(pc.init_state((2,)), x)
    e64["pconv"] = max(rel_err(y[r], stream_oracle(x[r], h)) for r in (0, 1))
    z = torch.complex(torch.randn((64, FFT_CPLX_N), **f64), torch.randn((64, FFT_CPLX_N), **f64))
    e64["Fft"] = rel_err(pt.Fft(np.complex128, FFT_CPLX_N, device=DEV).forward(z),
                         torch.fft.fft(z, dim=-1))
    torch.cuda.synchronize()
    delta = launched(counts(), {k: 0 for k in counts()})
    emit({"phase": "anylen", "path": "float64", **{k + "_rel_err": v for k, v in e64.items()},
          "f32_kernel_launches": delta})
    check(max(e64.values()) <= F64_TOL, f"anylen float64: errors {e64}")
    check(delta == {}, f"anylen float64 calls launched f32 kernels: {delta}")
    del re, im, x, y, z
    torch.cuda.empty_cache()
    return paths


def phase_anylen_timing(gen):
    """Times of the any-length, N-D, DCT, partitioned-convolution and Fft
    calls at their full sizes: ms per call beside the bytes bound (the planes
    read once and written once; bench_pipeline's FDL model for the
    partitioned convolution), the PyTorch yardstick where one call computes
    the function, and the parts (chirps, transforms, product, copies)."""

    dev = torch.device(DEV)

    def row(call, shape, ms, nbytes, flops, library_ms=None, library=None, **parts):
        bnd = bound(nbytes, flops)
        emit({"phase": "anylen_time", "call": call, "shape": list(shape), "ms": ms,
              "bound_ms": bnd[0], "bound_by": bnd[1], "frac_bound": bnd[0] / ms,
              "library_ms": library_ms, "library": library, **parts})

    def chirp_parts(plan, re, im, n_out):
        """The chirp-Z pipeline's steps apart (pre-chirp and pad, one inner
        transform, the product, the post-chirp), each elementwise step
        beside its bytes bound (f32 planes read once and written once)."""

        pre, kern, post = plan._device_tables(dev, False)
        b, n = re.shape
        pad = (0, plan.m - n)
        ar, ai = S.split_mul((re, im), pre)
        ar, ai = torch.nn.functional.pad(ar, pad), torch.nn.functional.pad(ai, pad)
        sr, si = D.cfft_dispatch(plan.inner, ar, ai, time_major=False)
        out = {"chirp_ms": time_ms(lambda: tuple(torch.nn.functional.pad(t, pad) for t in
                                                 S.split_mul((re, im), pre)), inner=2),
               "transform_ms": time_ms(lambda: D.cfft_dispatch(plan.inner, ar, ai,
                                                               time_major=False), inner=2),
               "product_ms": time_ms(lambda: S.split_mul((sr, si), kern), inner=2),
               "post_ms": time_ms(lambda: S.split_mul(
                   (sr[..., :n_out], si[..., :n_out]), (post[0][:n_out], post[1][:n_out])),
                   inner=2),
               "inner_m": plan.m,
               "inner_engine": D.select_engine(plan.inner, b, False, dev),
               "chirp_bound_ms": bound(8.0 * b * (n + plan.m), 0)[0],
               "product_bound_ms": bound(16.0 * b * plan.m, 0)[0],
               "post_bound_ms": bound(16.0 * b * n_out, 0)[0]}
        return out

    for n, b in ((BS_N, BS_B), (BS_TMAJOR_N, BS_TMAJOR_B)):
        plan = pt.new_setup_any(n)
        re, im = planes(b, n, gen)
        z = torch.complex(re, im)
        row("bluestein", (b, n), time_ms(lambda: pt.transform_ordered_split(plan, (re, im)),
                                         inner=2),
            16.0 * n * b, fft_flops(n, b),
            time_ms(lambda: torch.fft.fft(z, dim=-1), inner=2), "torch.fft.fft(dim=-1)",
            bwd_ms=time_ms(lambda: pt.transform_ordered_split(plan, (re, im), pt.BACKWARD),
                           inner=2),
            **chirp_parts(plan, re, im, n))
        del re, im, z
    # the inner transform at other smooth lengths >= 2N - 1 that B9 runs, on
    # Bluestein's batch at N = 4099: what the inner-length rule trades
    sweep = {}
    for m in BS_M_SWEEP:
        ar, ai = planes(BS_B, m, gen)
        sweep[m] = time_ms(lambda: D.cfft_dispatch(pt.new_setup(m, strict=False), ar, ai,
                                                   time_major=False), inner=2)
        del ar, ai
    emit({"phase": "anylen_time", "call": "bluestein inner transform", "b": BS_B,
          "fused2_ms_by_m": sweep})
    for n in RFFT_ANY_NS:
        x = torch.randn((RFFT_ANY_B, n), generator=gen, device=DEV)
        row("rfft_any", (RFFT_ANY_B, n), time_ms(lambda: pt.rfft_any(x), inner=2),
            4.0 * n * RFFT_ANY_B + 8.0 * (n // 2 + 1) * RFFT_ANY_B, fft_flops(n, RFFT_ANY_B) / 2,
            time_ms(lambda: torch.fft.rfft(x, dim=-1), inner=2), "torch.fft.rfft(dim=-1)")
        del x
    cp = pt.zoom_fft_setup(ZOOM_N, ZOOM_F, ZOOM_M)
    re, im = planes(ZOOM_B, ZOOM_N, gen)
    row("czt_split (zoom)", (ZOOM_B, ZOOM_N), time_ms(lambda: pt.czt_split(cp, (re, im)),
                                                      inner=2),
        8.0 * ZOOM_B * ZOOM_N * (1 + ZOOM_M / ZOOM_N), 2 * fft_flops(cp.m, ZOOM_B),
        zoom_fft_ms=time_ms(lambda: pt.zoom_fft(re, ZOOM_F, ZOOM_M), inner=2),
        **chirp_parts(cp, re, im, ZOOM_M))
    del re, im
    nd = pt.fftn_setup(FFT2_SHAPE[-2:])
    re = torch.randn(FFT2_SHAPE, generator=gen, device=DEV)
    im = torch.randn(FFT2_SHAPE, generator=gen, device=DEV)
    z = torch.complex(re, im)
    p1 = nd.plans[1]
    numel = re.numel()
    row("fftn_split (2-D)", FFT2_SHAPE, time_ms(lambda: pt.fftn_split(nd, (re, im)), inner=2),
        16.0 * numel, fft_flops(nd.size, FFT2_SHAPE[0]),
        time_ms(lambda: torch.fft.fft2(z), inner=2), "torch.fft.fft2",
        axis_transform_ms=time_ms(lambda: pt.transform_ordered_split(p1, (re, im)), inner=2),
        movedim_copy_ms=time_ms(lambda: (re.movedim(-2, -1).contiguous(),
                                         im.movedim(-2, -1).contiguous()), inner=2))
    del re, im, z
    xq = torch.randn(DCT_SHAPE, generator=gen, device=DEV)
    x1 = torch.randn((DCT_I_B, DCT1_N), generator=gen, device=DEV)
    xs = torch.randn((DCT_I_B, DST1_N), generator=gen, device=DEV)
    for name, x, m in (("dct2", xq, DCT_SHAPE[1]), ("dct3", xq, DCT_SHAPE[1]),
                       ("dct1", x1, 2 * (DCT1_N - 1)), ("dst1", xs, 2 * (DST1_N + 1))):
        b = x.shape[0]
        ip = pt.new_setup(m)
        zr, zi = torch.randn((b, m), generator=gen, device=DEV), torch.zeros((b, m), device=DEV)
        fn = getattr(pt, name)
        row(name, tuple(x.shape), time_ms(lambda: fn(x), inner=2),
            8.0 * x.numel(), fft_flops(m, b),
            inner_n=m, transform_ms=time_ms(lambda: D.cfft_dispatch(
                ip, zr, zi, time_major=False), inner=2))
        del zr, zi
    del xq, x1, xs
    for taps in PCONV_TAPS:
        h = np.random.default_rng(SEED + taps).standard_normal(taps).astype(np.float32) * 0.01
        pc = pt.PartitionedConv(h, PCONV_BLOCK, device=DEV)
        n = PCONV_BLOCKS * PCONV_BLOCK
        x = torch.randn((PCONV_CH, n), generator=gen, device=DEV)
        st = pc.init_state((PCONV_CH,))
        y, st = pc.process(st, x)
        frames = torch.randn((PCONV_CH, PCONV_BLOCKS, 2 * PCONV_BLOCK), generator=gen,
                             device=DEV)
        xr, xi = pt.transform_ordered_split(pc.plan, frames)
        ar, ai = torch.cat([st.sr, xr], dim=-2), torch.cat([st.si, xi], dim=-2)
        acc = pc._accumulate(ar, ai, PCONV_BLOCKS)
        tot = PCONV_CH * n
        ms = time_ms(lambda: pc.process(st, x), inner=2)
        # bench_pipeline's FDL model: the input read and the output written
        # (4 bytes each), P spectra read and one written a block, both planes
        row(f"PartitionedConv.process, taps={taps}", (PCONV_CH, n), ms,
            tot * (8.0 + 8.0 * (pc.parts + 1)),
            2 * fft_flops(PCONV_BLOCK, PCONV_CH * PCONV_BLOCKS) + 8.0 * pc.parts * tot,
            parts=pc.parts, msamples_per_s=tot / ms / 1e3,
            forward_ms=time_ms(lambda: pt.transform_ordered_split(pc.plan, frames), inner=2),
            frame_ms=time_ms(lambda: torch.cat([st.tail, x], dim=-1).unfold(
                -1, 2 * PCONV_BLOCK, PCONV_BLOCK).contiguous(), inner=2),
            history_ms=time_ms(lambda: (torch.cat([st.sr, xr], dim=-2),
                                        torch.cat([st.si, xi], dim=-2)), inner=2),
            accumulate_ms=time_ms(lambda: pc._accumulate(ar, ai, PCONV_BLOCKS), inner=2),
            backward_ms=time_ms(lambda: pt.transform_ordered_split(pc.plan, acc, pt.BACKWARD),
                                inner=2))
        del x, y, st, frames, xr, xi, ar, ai, acc
    fr = pt.Fft(np.float32, FFT_REAL_N, device=DEV)
    fc = pt.Fft(np.complex64, FFT_CPLX_N, device=DEV)
    xr = torch.randn((FFT_REAL_B, FFT_REAL_N), generator=gen, device=DEV)
    xc = torch.complex(*planes(FFT_CPLX_B, FFT_CPLX_N, gen))
    sr, sc = fr.forward(xr), fc.forward(xc)
    row("Fft(float32).forward", tuple(xr.shape), time_ms(lambda: fr.forward(xr)),
        8.0 * xr.numel(), fft_flops(FFT_REAL_N, FFT_REAL_B) / 2,
        time_ms(lambda: torch.fft.rfft(xr, dim=-1)), "torch.fft.rfft(dim=-1)",
        inverse_ms=time_ms(lambda: fr.inverse(sr)))
    row("Fft(complex64).forward", tuple(xc.shape), time_ms(lambda: fc.forward(xc)),
        16.0 * xc.numel(), fft_flops(FFT_CPLX_N, FFT_CPLX_B),
        time_ms(lambda: torch.fft.fft(xc, dim=-1)), "torch.fft.fft(dim=-1)",
        inverse_ms=time_ms(lambda: fc.inverse(sc)),
        to_split_ms=time_ms(lambda: S.to_split(xc)))
    del xr, xc, sr, sc
    torch.cuda.empty_cache()


def capture_chunks() -> list:
    """The seeded push sizes of the capture phase's StreamingConv run."""

    rng = np.random.default_rng(SEED)
    sizes, total = [], 0
    while total < CAP_STREAM_N:
        sizes.append(min(int(rng.integers(1, CAP_CHUNK_MAX + 1)), CAP_STREAM_N - total))
        total += sizes[-1]
    return sizes


def capture_channelizer_steps() -> list:
    """The capture phase's float32 channelizer steps in the order it runs
    them, (M, V, batch, frames, lead, width): for each stream two chunks of
    half its length, read in place from its rows of ``width`` samples at
    ``lead``, then the whole stream in one step."""

    steps = []
    for (b, n), m, v in CAP_CHANNELIZERS:
        half = n // 2
        steps += [(m, v, b, half // m, j * half, n) for j in range(2)]
        steps.append((m, v, b, n // m, 0, n))
    return steps


def capture_launch_columns(nfft: int, hop: int) -> list:
    """B7's column count at each launch of that run: the frames the framer
    emits after each push (and the flush's one), two frames a column,
    padded to a multiple of 4."""

    frames, pending = [], 0
    for n in capture_chunks():
        pending += n
        k = 0 if pending < nfft else (pending - nfft) // hop + 1
        pending -= k * hop
        frames += [k] if k else []
    frames += [1] if pending else []
    return [-(-((k + (k & 1)) // 2) // 4) * 4 for k in frames]


@contextlib.contextmanager
def numpy_arm():
    """The host runtime's numpy arm (``load`` finds no library), to time
    the native arm against."""

    load = RT.load
    RT.load = lambda: None
    try:
        yield
    finally:
        RT.load = load


def capture_signal(shape, m: int, gen, dtype=torch.float32):
    """Seeded complex noise (CAP_NOISE rms a plane) plus the tones
    CAP_TONES[m] at their channels' centre frequencies c/M, each row at a
    seeded phase: planes on the card."""

    f64 = {"generator": gen, "device": "cuda", "dtype": torch.float64}
    xr, xi = torch.randn(shape, **f64) * CAP_NOISE, torch.randn(shape, **f64) * CAP_NOISE
    t = torch.arange(shape[-1], device="cuda", dtype=torch.int64)
    for c, a in CAP_TONES[m]:
        ang = 2 * math.pi * ((c * t) % m).to(torch.float64) / m
        ang = ang + torch.rand((shape[0], 1), **f64) * (2 * math.pi)
        xr += a * torch.cos(ang)
        xi += a * torch.sin(ang)
    return xr.to(dtype), xi.to(dtype)


def tone_levels(yr, yi, m: int, skip: int):
    """(ok, record): the mean |Y| of each channel over rows and the frames
    past the first ``skip`` (those read the zero history); the two strongest
    channels must be the tones', each within CAP_TONE_TOL of its amplitude
    (the prototype's DC gain is 1)."""

    y = torch.complex(yr[..., skip:, :], yi[..., skip:, :])
    mag = y.abs().double().mean(dim=tuple(range(y.ndim - 1)))
    top = sorted(torch.topk(mag, 2).indices.tolist())
    levels = {c: float(mag[c]) for c, _ in CAP_TONES[m]}
    ok = (top == sorted(levels)
          and all(abs(levels[c] - a) <= CAP_TONE_TOL * a for c, a in CAP_TONES[m]))
    return ok, {"strongest": top, "levels": levels,
                "amplitudes": {c: a for c, a in CAP_TONES[m]}}


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn`` over ``reps`` calls (``fn`` ends in a
    synchronize where it launches work on the card)."""

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def phase_capture(gen, smi: str):
    """The SDR capture path on the native host runtime: sample bytes, the
    native converters, planar float32 on the card, the channelizers (and
    StreamingConv on the native ring buffer), driven with the counts at 0
    and held to float64 oracles; then float64 steps and the timings.
    Returns the launch counts of the float32 runs."""

    check(RT.HAVE_NATIVE, "the native host runtime did not load")
    dev = torch.device("cuda")
    ((rows, n), m, _), ((urows, un), om, ov) = CAP_CHANNELIZERS
    p = CAP_TAPS_PER_PHASE
    # the sample bytes: cs16 quantized by the port's converter, cu8 offset
    # binary (round(128 x + 127.4)); made before the counted run
    xr, xi = capture_signal(CAP_CS16_SHAPE, m, gen)
    cs16 = RT.convert_planar_f32_cs16(xr.cpu().numpy(), xi.cpu().numpy()).reshape(rows, 2 * n)
    ur, ui = capture_signal(CAP_CU8_SHAPE, om, gen)
    cu8 = torch.stack([(u * 128 + 127.4).round().clamp(0, 255) for u in (ur, ui)], dim=-1)
    cu8 = cu8.to(torch.uint8).reshape(urows, 2 * un).cpu().numpy()
    xs = torch.randn(CAP_STREAM_N, generator=gen, device="cuda")
    xs_host = xs.cpu().numpy()
    del xr, xi, ur, ui
    h = pt.design_lowpass(CAP_STREAM_TAPS, 0.1)
    torch.cuda.synchronize()

    reset_counts()
    # cs16 -> the critically sampled channelizer, two chunks, then one
    re, im = RT.convert_cs16_planar_f32(cs16)
    xr = torch.from_numpy(re.reshape(rows, n)).to(dev)
    xi = torch.from_numpy(im.reshape(rows, n)).to(dev)
    ch = CH.Channelizer(m, p)
    st, outs, half = ch.init_state((rows,)), [], n // 2
    for j in range(2):
        y, st = ch.process_split(st, xr[:, j * half:(j + 1) * half], xi[:, j * half:(j + 1) * half])
        outs.append(y)
    (ar, ai), _ = ch.process_split(ch.init_state((rows,)), xr, xi)
    # cu8 -> the oversampled channelizer, two chunks, then one
    ure, uim = RT.convert_cu8_planar_f32(cu8)
    ur = torch.from_numpy(ure.reshape(urows, un)).to(dev)
    ui = torch.from_numpy(uim.reshape(urows, un)).to(dev)
    och = CH.OversampledChannelizer(om, ov, p)
    ost, oouts, uhalf = och.init_state((urows,)), [], un // 2
    for j in range(2):
        y, ost = och.process_split(ost, ur[:, j * uhalf:(j + 1) * uhalf],
                                   ui[:, j * uhalf:(j + 1) * uhalf])
        oouts.append(y)
    (oar, oai), _ = och.process_split(och.init_state((urows,)), ur, ui)
    # a real stream on the native ring buffer through StreamingConv
    sc = C.StreamingConv(h)
    parts, pos = [], 0
    for size in capture_chunks():
        parts.append(sc.push(xs_host[pos:pos + size]))
        pos += size
    parts.append(sc.flush())
    torch.cuda.synchronize()
    launches = counts()

    # each channelizer step: one B8 launch and one transform per residue
    # (B1, and B2 where kern2 serves it), on the chunk's and the whole
    # stream's columns; each StreamingConv run one column-map launch
    want = {"pfb_fir_stream_tmajor": 0, "cfft_chain_tmajor": 0, "cfft_combine_tmajor": 0}
    for sm, residues, b, k, _, _ in capture_channelizer_steps():
        want["pfb_fir_stream_tmajor"] += residues
        want["cfft_chain_tmajor"] += residues
        if D.select_engine({m: ch.plan, om: och.base.plan}[sm], b * k, True, dev) == "kern2":
            want["cfft_combine_tmajor"] += residues
    want = {k: v for k, v in want.items() if v}
    want["zconv_tmajor"] = len(capture_launch_columns(sc.setup.nfft, sc.setup.num_out_per_block))
    emit({"phase": "capture", "launches": launches, "expected": want,
          "native": RT.HAVE_NATIVE, "streaming_native": sc.native})
    check(launched(launches, {k: 0 for k in launches}) == want,
          f"capture path: launches {launches}, expected {want}")
    check(sc.native, "StreamingConv did not take the native ring buffer")

    # the converters' native arm against the numpy arm, bit for bit, on a slice
    with numpy_arm():
        nre, nim = RT.convert_cs16_planar_f32(cs16[:, :1 << 17])
        nure, nuim = RT.convert_cu8_planar_f32(cu8[:, :1 << 17])
    same = (np.array_equal(nre, re.reshape(rows, n)[:, :1 << 16].ravel())
            and np.array_equal(nim, im.reshape(rows, n)[:, :1 << 16].ravel())
            and np.array_equal(nure, ure.reshape(urows, un)[:, :1 << 16].ravel())
            and np.array_equal(nuim, uim.reshape(urows, un)[:, :1 << 16].ravel()))
    check(same, "native converters differ from the numpy arm")
    # the critically sampled run against the oracle, two chunks against one,
    # the tones in their channels
    yr = torch.cat([o[0] for o in outs], dim=-2)
    yi = torch.cat([o[1] for o in outs], dim=-2)
    e_chunks = max(rel_err(ar, yr), rel_err(ai, yi))
    err = max(rel_err(torch.complex(yr[r], yi[r]), pfb_oracle(torch.complex(xr[r], xi[r]),
                                                              ch.weights))
              for r in (0, rows - 1))
    tones_ok, tone_rec = tone_levels(yr, yi, m, p)
    emit({"phase": "capture", "run": "cs16_channelizer", "shape": [rows, n], "m": m, "p": p,
          "out_shape": list(yr.shape), "oracle_rel_err": err,
          "two_chunks_vs_one_rel_err": e_chunks, "tones": tone_rec, "converters_bit_exact": same})
    check(yr.shape == (rows, n // m, m) and bool(torch.isfinite(yr).all()),
          "capture cs16: output not finite/shaped")
    check(err <= ORACLE_TOL and e_chunks <= KERNEL_TOL,
          f"capture cs16: oracle {err}, chunks {e_chunks}")
    check(tones_ok, f"capture cs16: tones {tone_rec}")
    # the oversampled run, the same checks (the oracle per residue, times
    # the residue's phase table)
    oyr = torch.cat([o[0] for o in oouts], dim=-2)
    oyi = torch.cat([o[1] for o in oouts], dim=-2)
    oe_chunks = max(rel_err(oar, oyr), rel_err(oai, oyi))
    oerr = 0.0
    for r in (0, urows - 1):
        x0 = torch.complex(ur[r], ui[r])
        ref = torch.empty((un // om, ov, om), dtype=torch.complex128, device="cuda")
        for res in range(ov):
            ph = torch.from_numpy(och.ph_re[res] + 1j * och.ph_im[res].astype(np.float64))
            ref[:, res] = pfb_oracle(x0, och.base.weights, res * och.hop) * ph.to("cuda")
        oerr = max(oerr, rel_err(torch.complex(oyr[r], oyi[r]), ref.reshape(-1, om)))
    otones_ok, otone_rec = tone_levels(oyr, oyi, om, ov * p)
    emit({"phase": "capture", "run": "cu8_oversampled", "shape": [urows, un], "m": om, "v": ov,
          "p": p, "out_shape": list(oyr.shape), "oracle_rel_err": oerr,
          "two_chunks_vs_one_rel_err": oe_chunks, "tones": otone_rec})
    check(oyr.shape == (urows, ov * un // om, om) and bool(torch.isfinite(oyr).all()),
          "capture cu8: output not finite/shaped")
    check(oerr <= ORACLE_TOL and oe_chunks <= KERNEL_TOL,
          f"capture cu8: oracle {oerr}, chunks {oe_chunks}")
    check(otones_ok, f"capture cu8: tones {otone_rec}")
    # StreamingConv on the native ring against a float64 convolution
    got = np.concatenate(parts)
    serr = (rel_err(torch.from_numpy(got).to(dev).double(), conv_oracle(xs, h))
            if got.shape == (CAP_STREAM_N - CAP_STREAM_TAPS + 1,) else 1.0)
    emit({"phase": "capture", "run": "streaming_conv", "taps": CAP_STREAM_TAPS,
          "samples": CAP_STREAM_N, "pushes": len(parts) - 1, "out": int(got.size),
          "native": sc.native, "oracle_rel_err": serr})
    check(serr <= ORACLE_TOL, f"capture StreamingConv: {got.shape}, oracle error {serr}")
    del yr, yi, ar, ai, outs, oyr, oyi, oar, oai, oouts

    # one float64 step of each channelizer: no f32 kernel, 1e-12 of the oracle
    c0 = counts()
    f64 = {"generator": gen, "device": "cuda", "dtype": torch.float64}
    dr, di = torch.randn(CAP_F64_SHAPE, **f64), torch.randn(CAP_F64_SHAPE, **f64)
    ch64 = CH.Channelizer(m, p, dtype="float64")
    (dyr, dyi), _ = ch64.process_split(ch64.init_state((CAP_F64_SHAPE[0],)), dr, di)
    our, oui = torch.randn(CAP_CU8_SHAPE, **f64), torch.randn(CAP_CU8_SHAPE, **f64)
    och64 = CH.OversampledChannelizer(om, ov, p, dtype="float64")
    (doyr, doyi), _ = och64.process_split(och64.init_state((urows,)), our, oui)
    torch.cuda.synchronize()
    f32_launches = launched(counts(), c0)
    e64 = max(rel_err(torch.complex(dyr[r], dyi[r]),
                      pfb_oracle(torch.complex(dr[r], di[r]), ch64.weights))
              for r in (0, CAP_F64_SHAPE[0] - 1))
    oe64 = 0.0
    for r in (0, urows - 1):
        ref = torch.empty((un // om, ov, om), dtype=torch.complex128, device="cuda")
        for res in range(ov):
            ph = torch.from_numpy(och64.ph_re[res] + 1j * och64.ph_im[res]).to("cuda")
            ref[:, res] = pfb_oracle(torch.complex(our[r], oui[r]), och64.base.weights,
                                     res * och64.hop) * ph
        oe64 = max(oe64, rel_err(torch.complex(doyr[r], doyi[r]), ref.reshape(-1, om)))
    typed = dyr.dtype == doyr.dtype == torch.float64
    emit({"phase": "capture", "run": "float64", "channelizer": list(CAP_F64_SHAPE),
          "oversampled": [urows, un], "typed": typed, "oracle_rel_err": e64,
          "oversampled_oracle_rel_err": oe64, "f32_kernel_launches": f32_launches})
    check(typed and e64 <= F64_TOL and oe64 <= F64_TOL,
          f"capture float64: {dyr.dtype}, oracle {e64}, oversampled {oe64}")
    check(f32_launches == {}, f"float64 channelizers launched f32 kernels: {f32_launches}")
    del dyr, dyi, doyr, doyi

    # timings: the converters on the host, native against the numpy arm
    conv_cases = (
        ("s16_f32", lambda: RT.convert_s16_f32(cs16), 3 * cs16.nbytes),
        ("cs16_planar_f32", lambda: RT.convert_cs16_planar_f32(cs16), 3 * cs16.nbytes),
        ("cu8_planar_f32", lambda: RT.convert_cu8_planar_f32(cu8), 5 * cu8.nbytes),
        ("planar_f32_cs16", lambda: RT.convert_planar_f32_cs16(re, im), 3 * re.nbytes))
    for name, fn, nbytes in conv_cases:
        fn()
        nat = host_ms(fn)
        with numpy_arm():
            nump = host_ms(fn, 3)
        emit({"phase": "capture_time", "converter": name, "bytes": nbytes, "native_ms": nat,
              "native_gbps": nbytes / nat / 1e6, "numpy_ms": nump,
              "numpy_gbps": nbytes / nump / 1e6, "card": smi})
    # where a converter's time goes: the same native loop into planes whose
    # pages are touched already, against the first and the second touch of
    # a buffer the planes' size (each call of the public converter writes
    # fresh pages)
    lib = RT.load()
    pre_re, pre_im = np.zeros_like(re), np.zeros_like(im)
    pre_re.fill(1.0)
    pre_im.fill(1.0)
    args = (RT._ptr(cs16, ctypes.c_int16), RT._ptr(pre_re, ctypes.c_float),
            RT._ptr(pre_im, ctypes.c_float), re.size)
    warm_buf = np.zeros(2 * re.size, np.float32)
    warm_buf.fill(1.0)
    emit({"phase": "capture_time", "converter": "cs16_planar_f32", "bytes": 3 * cs16.nbytes,
          "native_touched_out_ms": host_ms(lambda: lib.pftt_convert_cs16_planar_f32(*args)),
          "first_touch_fill_ms": host_ms(
              lambda: np.empty(2 * re.size, np.float32).fill(0.0)),
          "second_touch_fill_ms": host_ms(lambda: warm_buf.fill(0.0)),
          "out_bytes": 2 * re.nbytes, "card": smi})
    del pre_re, pre_im, warm_buf
    # the framer: push + frames() per CAP_FRAMER_N samples at StreamingConv's
    # frame and hop, native against the numpy arm
    blk = np.random.default_rng(SEED).standard_normal(CAP_FRAMER_N).astype(np.float32)

    def framer_ms():
        fr = RT.StreamFramer(sc.setup.nfft, sc.setup.num_out_per_block)

        def run():
            for _ in range(CAP_FRAMER_REPS):
                fr.push(blk)
                fr.frames()

        run()
        return host_ms(run, 3) / CAP_FRAMER_REPS, fr.native

    nat_ms, nat_native = framer_ms()
    with numpy_arm():
        np_ms, np_native = framer_ms()
    check(nat_native and not np_native, "framer arms")
    emit({"phase": "capture_time", "framer": [sc.setup.nfft, sc.setup.num_out_per_block],
          "samples_per_push": CAP_FRAMER_N, "native_ms": nat_ms, "numpy_ms": np_ms,
          "card": smi})
    # the whole capture step (convert, copy to the card, channelize) against
    # the channelizer step alone, on one chunk of the cs16 stream
    chunk = np.ascontiguousarray(cs16[:, :n])  # 2^22 complex samples a channel
    st0 = ch.init_state((rows,))
    cre, cim = RT.convert_cs16_planar_f32(chunk)

    def h2d():
        torch.from_numpy(cre).to(dev), torch.from_numpy(cim).to(dev)
        torch.cuda.synchronize()

    def capture_step():
        a, b = RT.convert_cs16_planar_f32(chunk)
        ch.process_split(st0, torch.from_numpy(a.reshape(rows, -1)).to(dev),
                         torch.from_numpy(b.reshape(rows, -1)).to(dev))
        torch.cuda.synchronize()

    capture_step()
    xr_c, xi_c = xr[:, :half], xi[:, :half]
    rec = {"phase": "capture_time", "step": [rows, half], "m": m, "p": p,
           "capture_step_ms": host_ms(capture_step),
           "convert_ms": host_ms(lambda: RT.convert_cs16_planar_f32(chunk)),
           "h2d_ms": host_ms(h2d),
           "channelizer_step_ms": time_ms(lambda: ch.process_split(st0, xr_c, xi_c), inner=2),
           "channelizer_tmajor_step_ms": time_ms(
               lambda: ch.process_split_tmajor(st0, xr_c, xi_c), inner=2),
           "f64_step_ms": time_ms(lambda: ch64.process_split(
               ch64.init_state((rows,)), dr, di), inner=1),
           "oversampled_step_ms": time_ms(lambda: och.process_split(
               och.init_state((urows,)), ur, ui), inner=2),
           "oversampled_f64_step_ms": time_ms(lambda: och64.process_split(
               och64.init_state((urows,)), our, oui), inner=1),
           "card": smi}
    emit(rec)
    del xr, xi, ur, ui, dr, di, our, oui, xs
    torch.cuda.empty_cache()
    return launches


def tune_shapes():
    """(N, B, time_major) of measure mode's races and of the public call
    made after each."""

    return tuple((n, b, True) for n, b in BAND) + tuple((n, b, False) for n, b in TUNE_BMAJOR)


def parallel_shapes():
    """(column length, columns, row length, rows) of the distribution
    layer's local transforms on one rank: the four-step's [N1, B*N2] and
    [B*N1, N2] (the real four-step runs the complex one at N/2), the
    pencil's [n0, B*n1] and [B*n0, n1]."""

    out = []
    for n in (FOURSTEP_N, FOURSTEP_REAL_N // 2):
        n1, n2 = PP.fourstep._split_n(n, None, 1)
        out.append((n1, FOURSTEP_B * n2, n2, FOURSTEP_B * n1))
    n0, n1 = PENCIL_SHAPE
    out.append((n0, PENCIL_B * n1, n1, PENCIL_B * n0))
    return sorted(set(out))


def phase_oracle(gen):
    """The card's public outputs at small shapes against the port's numpy
    FFTPACK oracle (``pffft_tpu_torch.oracle``, float64, no np.fft): the
    complex time-major transform both ways at N = 1024 and 4096 on 16
    columns, the real one at N = 2048, batch-major rows at N = 4096; each
    within ORACLE_TOL of max|oracle|."""

    def host(re, im):
        return re.double().cpu().numpy() + 1j * im.double().cpu().numpy()

    def hold(name, got, want):
        err = float(np.abs(got - want).max() / np.abs(want).max())
        emit({"phase": "oracle", "call": name, "rel_err": err})
        check(math.isfinite(err) and err <= ORACLE_TOL, f"oracle {name}: {err}")

    for n in ORACLE_CPLX_NS:
        plan = pt.new_setup(n)
        re, im = planes(n, ORACLE_B, gen)
        z = host(re, im).T  # the oracle transforms rows
        hold(f"tmajor complex forward {n}",
             host(*pt.transform_ordered_split_tmajor(plan, (re, im), pt.FORWARD)).T,
             OR.cfftf(z))
        hold(f"tmajor complex backward {n}",
             host(*pt.transform_ordered_split_tmajor(plan, (re, im), pt.BACKWARD)).T,
             OR.cfftb(z))
    x = torch.randn((ORACLE_REAL_N, ORACLE_B), generator=gen, device="cuda")
    spec = pt.transform_ordered_split_tmajor(pt.new_setup(ORACLE_REAL_N, pt.REAL), x, pt.FORWARD)
    hold(f"tmajor real forward {ORACLE_REAL_N}", host(*spec).T,
         OR.packed_spectrum(x.double().cpu().numpy().T))
    re, im = planes(ORACLE_B, ORACLE_BMAJOR_N, gen)
    hold(f"bmajor complex forward {ORACLE_BMAJOR_N}",
         host(*pt.transform_ordered_split(pt.new_setup(ORACLE_BMAJOR_N), (re, im), pt.FORWARD)),
         OR.cfftf(host(re, im)))


def phase_parallel(gen):
    """The distribution layer on a world of one NCCL rank, started here
    (``init_process_group`` with a ``file://`` rendezvous in a temporary
    directory, ``device_id`` cuda:0) and destroyed at the end; one rank
    sends nothing, so the local phases run as on a shard of a larger world:
    the four-step's columns on kern2 and rows on B9, the pencil's the same,
    the sharded FastConv on B7's stream map.  Each path from zero counts,
    held to a complex128 ``torch.fft`` oracle (the four-step, ordered and
    internal with ``reorder``, and the pencil in both layouts), the unscaled
    round trips, and the sharded FastConv to the local one (KERNEL_TOL);
    then each call timed beside its bytes bound and ``torch.fft``; then the
    gradient of each path's forward (both pencil layouts) through
    :func:`grad_case`.  At one rank every exchange is the identity: the
    multi-rank adjoints are held in gloo worlds on the CPU.  Returns the
    launch counts of the four paths and of the gradients."""

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120),
                                device_id=torch.device("cuda", 0))
        try:
            mesh = PP.make_mesh(device_type="cuda")
            emit({"phase": "parallel", "backend": str(dist.get_backend()),
                  "world": dist.get_world_size(), "mesh": list(mesh.shape),
                  "axes": list(mesh.mesh_dim_names)})
            return parallel_paths(gen, mesh)
        finally:
            dist.destroy_process_group()


def parallel_paths(gen, mesh):
    path_kernels = ("cfft_chain_tmajor", "cfft_combine_tmajor", "cfft_fused2")
    paths = []

    def hold(name, case, **errs):
        emit({"phase": "parallel", "path": name, **case, **errs})
        for k, e in errs.items():
            check(math.isfinite(e) and e <= ORACLE_TOL, f"{name} {k}: {e}")

    def grad(name, fn, xs, oracle, flops, want=path_kernels, **info):
        # the path's gradient: its backward runs the forward's kernels
        got = {w.__name__: 0 for w in WRAPPERS}
        grad_case("parallel", name, fn, xs, want, gen, got, oracle, flops, inner=2, **info)
        paths.append(got)
        torch.cuda.empty_cache()

    def timed(name, shape, ms, nbytes, flops, library_ms, library, **parts):
        bnd = bound(nbytes, flops)
        emit({"phase": "parallel_time", "call": name, "shape": list(shape), "ms": ms,
              "bound_ms": bnd[0], "bound_by": bnd[1], "frac_bound": bnd[0] / ms,
              "library_ms": library_ms, "library": library, **parts})

    # the four-step, complex: forward ordered and internal, reorder, backward
    n, b = FOURSTEP_N, FOURSTEP_B
    fp = PP.FourStepPlan(n, mesh)
    x = torch.complex(*planes(b, n, gen))
    xd = PP.shard_batch(x, mesh, axis=1)

    def fourstep():
        y = fp.forward(xd)
        yi = fp.forward(xd, ordered=False)
        return y, yi, fp.reorder(yi), fp.backward(y), fp.backward(yi, ordered=False)

    (y, yi, yre, back, backi), got = drive("fourstep", fourstep, path_kernels, "parallel")
    paths.append(got)
    ref = torch.fft.fft(x.to(torch.complex128), dim=-1)
    hold("fourstep", {"n": n, "b": b, "n1": fp.n1, "n2": fp.n2},
         fwd_rel_err=rel_err(y.to_local().to(torch.complex128), ref),
         reorder_rel_err=rel_err(yre.to_local().to(torch.complex128), ref),
         roundtrip_rel_err=rel_err(back.to_local() / n, x),
         internal_roundtrip_rel_err=rel_err(backi.to_local() / n, x))
    check(tuple(y.shape) == (b, n) and bool(torch.isfinite(torch.view_as_real(y.to_local())).all()),
          "four-step: output not finite/shaped")
    del y, yi, yre, back, backi, ref
    cols = planes(fp.n1, b * fp.n2, gen)
    rows = planes(b * fp.n1, fp.n2, gen)
    ax = fp._ax
    xl = xd.to_local()
    # the forward's parts outside the kernels: the split into planes and the
    # join, the twiddle multiply, the three layout passes around the
    # exchanges (rows to columns, columns to rows, the ordered transpose)
    parts = {
        "split_join_ms": time_ms(lambda: torch.complex(*PP.fourstep.to_planes(
            xl, torch.float32)), inner=2),
        "twiddle_ms": time_ms(lambda: PP.fourstep.cmul(
            *(t.view(fp.n1, b, -1) for t in cols), *fp._tw), inner=2),
        "layout_ms": time_ms(lambda: (
            ax.rows_to_cols([t.view(b, fp.n1, fp.n2) for t in rows], fp.n1, fp.n2),
            ax.cols_to_rows([t.view(fp.n1, b, fp.n2) for t in cols], fp.n1, fp.n2),
            ax.transpose_rows([t.view(b, fp.n1, fp.n2) for t in rows], fp.n1, fp.n2)),
            inner=2)}
    timed("fourstep forward", (b, n), time_ms(lambda: fp.forward(xd), inner=2),
          16.0 * n * b, fft_flops(n, b), time_ms(lambda: torch.fft.fft(x, dim=-1), inner=2),
          "torch.fft.fft(dim=-1)",
          bwd_ms=time_ms(lambda: fp.backward(xd), inner=2),
          internal_ms=time_ms(lambda: fp.forward(xd, ordered=False), inner=2),
          cols_ms=time_ms(lambda: D.cfft_dispatch(fp.plan1, *cols), inner=2),
          cols_engine=D.select_engine(fp.plan1, b * fp.n2, True, torch.device("cuda")),
          rows_ms=time_ms(lambda: D.cfft_dispatch(fp.plan2, *rows, time_major=False), inner=2),
          rows_engine=D.select_engine(fp.plan2, b * fp.n1, False, torch.device("cuda")),
          **parts)
    del x, xd, xl, cols, rows
    grad("fourstep_grad", lambda re, im: (fp.forward(torch.complex(re, im)).to_local(),),
         planes(b, n, gen), lambda re, im: (as_real(torch.fft.fft(torch.complex(re, im))),),
         fft_flops(n, b), n=n, b=b)
    del fp

    # the real four-step
    n = FOURSTEP_REAL_N
    fr = PP.FourStepPlan(n, mesh, kind=pt.REAL)
    x = torch.randn((b, n), generator=gen, device="cuda")
    xd = PP.shard_batch(x, mesh, axis=1)
    (s, back), got = drive("fourstep_real",
                           lambda: (lambda s: (s, fr.backward(s)))(fr.forward(xd)),
                           path_kernels, "parallel")
    paths.append(got)
    ref = torch.fft.rfft(x.double(), dim=-1)
    packed = ref[:, :-1].clone()
    packed[:, 0] = torch.complex(ref[:, 0].real, ref[:, -1].real)
    hold("fourstep_real", {"n": n, "b": b}, fwd_rel_err=rel_err(s.to_local().to(torch.complex128), packed),
         roundtrip_rel_err=rel_err(back.to_local() / n, x))
    del s, back, ref, packed
    zr, zi = planes(b, n // 2, gen)
    timed("fourstep_real forward", (b, n), time_ms(lambda: fr.forward(xd), inner=2),
          4.0 * n * b + 4.0 * n * b, fft_flops(n // 2, b),
          time_ms(lambda: torch.fft.rfft(x, dim=-1), inner=2), "torch.fft.rfft(dim=-1)",
          split_step_ms=time_ms(lambda: fr._real_post_fwd(zr, zi), inner=2),
          split_step_bound_ms=bound(16.0 * n // 2 * b, 0)[0])
    del zr, zi
    del x, xd
    grad("fourstep_real_grad", lambda v: (fr.forward(v).to_local(),),
         [torch.randn((b, n), generator=gen, device=DEV)],
         lambda v: (torch.stack(packed_rfft(v, -1), -1),), fft_flops(n // 2, b), n=n, b=b)
    del fr

    # the pencil, both layouts
    p = PP.Pencil2D(PENCIL_SHAPE, mesh)
    n0, n1 = PENCIL_SHAPE
    x = torch.complex(*planes(PENCIL_B * n0, n1, gen)).view(PENCIL_B, n0, n1)
    xd = PP.shard_batch(x, mesh, axis=1)

    def pencil():
        s, st = p.forward(xd), p.forward(xd, transposed=True)
        return s, st, p.backward(s), p.backward(st, transposed=True)

    (s, st, back, backt), got = drive("pencil", pencil, path_kernels, "parallel")
    paths.append(got)
    ref = torch.fft.fft2(x.to(torch.complex128))
    hold("pencil", {"shape": [PENCIL_B, n0, n1]},
         fwd_rel_err=rel_err(s.to_local().to(torch.complex128), ref),
         transposed_rel_err=rel_err(st.to_local().to(torch.complex128), ref.transpose(-1, -2)),
         roundtrip_rel_err=rel_err(back.to_local() / (n0 * n1), x),
         transposed_roundtrip_rel_err=rel_err(backt.to_local() / (n0 * n1), x))
    del s, st, back, backt, ref
    timed("pencil forward", (PENCIL_B, n0, n1), time_ms(lambda: p.forward(xd), inner=2),
          16.0 * PENCIL_B * n0 * n1, fft_flops(n0 * n1, PENCIL_B),
          time_ms(lambda: torch.fft.fft2(x), inner=2), "torch.fft.fft2",
          transposed_ms=time_ms(lambda: p.forward(xd, transposed=True), inner=2))
    del x, xd
    def pencil_oracle(re, im, transposed):
        y = torch.fft.fft2(torch.complex(re, im).view(PENCIL_B, n0, n1))
        return (as_real(y.transpose(-1, -2) if transposed else y),)

    for transposed in (False, True):
        grad("pencil_grad", lambda re, im, _t=transposed: (p.forward(
            torch.complex(re, im).view(PENCIL_B, n0, n1), transposed=_t).to_local(),),
            planes(PENCIL_B * n0, n1, gen),
            lambda re, im, _t=transposed: pencil_oracle(re, im, _t),
            fft_flops(n0 * n1, PENCIL_B), shape=[PENCIL_B, n0, n1], transposed=transposed)
    del p

    # the sharded FastConv against the local one
    h = pt.design_lowpass(SHARDED_CONV_TAPS, 0.1)
    fc = C.FastConv(h)
    x = torch.randn((CONV_ROWS, CONV_LEN), generator=gen, device="cuda")
    xd = PP.shard_batch(x, mesh, axis=1)
    y, got = drive("sharded_fastconv", lambda: PP.sharded_fastconv_valid(fc, xd, mesh),
                   ("zconv_stream",), "parallel")
    paths.append(got)
    local = fc.apply_batched(x)
    y = y.to_local()
    err = rel_err(y, local) if y.shape == local.shape else float("inf")
    emit({"phase": "parallel", "path": "sharded_fastconv", "taps": SHARDED_CONV_TAPS,
          "shape": list(x.shape), "out_shape": list(y.shape), "rel_err_vs_local": err})
    check(err <= KERNEL_TOL, f"sharded FastConv: {tuple(y.shape)}, rel err {err} vs local")
    del y, local
    out_len = CONV_LEN - SHARDED_CONV_TAPS + 1
    timed("sharded_fastconv_valid", (CONV_ROWS, CONV_LEN),
          time_ms(lambda: PP.sharded_fastconv_valid(fc, xd, mesh), inner=2),
          4.0 * CONV_ROWS * (CONV_LEN + out_len), 0.0, None, None,
          local_ms=time_ms(lambda: fc.apply_batched(x), inner=2))
    del x, xd
    grad("sharded_fastconv_grad",
         lambda v: (PP.sharded_fastconv_valid(fc, v, mesh).to_local(),),
         [torch.randn((CONV_ROWS, CONV_LEN), generator=gen, device=DEV)],
         lambda v: (torch.stack([conv_oracle(r, h) for r in v]),), 0.0, want=("zconv_stream",),
         taps=SHARDED_CONV_TAPS, shape=[CONV_ROWS, CONV_LEN])
    return paths


# the wrappers one public call launches on each engine (time-major
# "tmajor" runs the time-major route the dispatcher picks)
ENGINE_LAUNCHES = {"chain": {"cfft_chain_tmajor": 1},
                   "kern2": {"cfft_chain_tmajor": 1, "cfft_combine_tmajor": 1},
                   "stages": {},
                   "fused2": {"cfft_fused2": 1}}


def phase_tune(gen):
    """Measure mode on the card, after every other timed phase: the tables
    it fills are process-wide, and are emptied again at the end.
    ``tune_engine`` at the time-major band shapes and at TUNE_BMAJOR: each
    engine's median, the winner, the route the dispatcher took before, and
    the launches of one public call made after recording (from zero counts),
    which must be the winner's kernels (``phase_kernels`` holds every
    engine's shapes at ``tune_shapes``); ``tuned_setup`` at TUNE_SETUPS: each
    candidate's factors, local split, kernel route and time.  The kernels
    run their own thin chains whatever the plan's factors, so where every
    candidate takes one kernel route nothing may be timed or cached.
    Returns the launch counts of the public calls."""

    dev = torch.device("cuda")
    check(not os.environ.get("PFFFT_TPU_TUNE_CACHE"),
          "PFFFT_TPU_TUNE_CACHE is set: the tune phase writes no disk cache")
    saved = dict(D._MEASURED_TABLE)
    time_engine, time_plan = TU._time_engine, TU._time_plan
    race, tried = [], []
    TU._time_engine = lambda e, *a: (lambda t: (race.append((e, t)), t)[1])(time_engine(e, *a))
    TU._time_plan = lambda n, k, dt, pol, *a: (
        lambda t: (tried.append((pol, t)), t)[1])(time_plan(n, k, dt, pol, *a))
    total = {k: 0 for k in counts()}
    try:
        for n, b, tm in tune_shapes():
            plan = pt.new_setup(n)
            before = D.select_engine(plan, b, tm, dev)
            race.clear()
            winner = TU.tune_engine(n, b, time_major=tm, iters=TUNE_ITERS, rounds=TUNE_ROUNDS)
            med = {e: float(np.median([t for en, t in race if en == e])) * 1e3
                   for e, _ in race}
            check(D._MEASURED_TABLE.get((D.capability(dev), n, tm)) == winner,
                  f"tune_engine({n}, {b}): {winner} not recorded")
            x = planes(n, b, gen) if tm else planes(b, n, gen)
            call = pt.transform_ordered_split_tmajor if tm else pt.transform_ordered_split
            _, got = drive(f"{'tmajor' if tm else 'bmajor'} {n} x {b}",
                           lambda: call(plan, x, pt.FORWARD), (), "tune")
            ran = launched(got, {k: 0 for k in got})
            want = ENGINE_LAUNCHES[D.select_engine(plan, b, True, dev)
                                   if winner == "tmajor" else winner]
            emit({"phase": "tune", "n": n, "b": b, "time_major": tm, "median_ms": med,
                  "winner": winner, "default_route": before, "launches_after": ran})
            check(ran == want, f"tune {n} x {b}: winner {winner} but the call ran {ran}")
            total = {k: v + got[k] for k, v in total.items()}
            del x
        for n, kind, dtype in TUNE_SETUPS:
            TU.clear_tune_cache()
            tried.clear()
            plan = TU.tuned_setup(n, kind, dtype, iters=TUNE_ITERS)
            engine_n = n // 2 if kind == "real" else n
            cands = TU.candidate_policies(n, kind)
            times = dict(tried)
            routes = set()
            for pol in cands:
                eng = TU._policy_plan(engine_n, pt.COMPLEX, dtype, pol)
                route = TU._kernel_route(eng, 64, dev)
                routes.add(route)
                emit({"phase": "tune", "tuned_setup": n, "kind": kind, "dtype": dtype,
                      "policy": list(pol), "factors": list(eng.factors),
                      "local_split": eng.local_split is not None, "route": route or "stages",
                      "ms": times[pol] * 1e3 if pol in times else None})
            if len(routes) == 1 and None not in routes:
                check(not tried and not TU._MEM_CACHE,
                      f"tuned_setup({n}, {kind}, {dtype}) timed candidates of one kernel route")
                best = cands[0]
            else:
                check(sorted(times) == sorted(cands),
                      f"tuned_setup({n}, {kind}, {dtype}) timed {sorted(times)}")
                best = min(tried, key=lambda pt_: pt_[1])[0]
            check(plan == TU._policy_plan(n, kind, dtype, best),
                  f"tuned_setup({n}, {kind}, {dtype}) returned another plan than {best}")
    finally:
        TU._time_engine, TU._time_plan = time_engine, time_plan
        TU.clear_tune_cache()
        D._MEASURED_TABLE.clear()
        D._MEASURED_TABLE.update(saved)
    return total


# ---------------------------------------------------------------------------
# The differentiable path (phase_grad)
# ---------------------------------------------------------------------------

# (kind, time-major, N, B): the transforms whose gradients phase_grad takes,
# both directions each; B rows of a batch-major plan (the real (2048, 8192)
# is (B, H) = (2048, 4096))
GRAD_TRANSFORMS = (("complex", True, 2048, 8192), ("complex", True, 65536, 256),
                   ("complex", False, 4096, 4096), ("real", True, 2048, 8192),
                   ("real", True, 131072, 128), ("real", False, 8192, 2048))
GRAD_CONV_TAPS = (1024, 4096)          # FastConv on [CONV_ROWS, CONV_LEN]
GRAD_PUSH = 1 << 22                    # StreamingConv: one push of 2^22 samples
GRAD_OVERSAMPLED = (1024, 2, 8)        # OversampledChannelizer(M, V, P), one step
GRAD_DOT_TOL = 1e-5                    # |<g, Lx> - <L^T g, x>| / (|g| |Lx|)
TRAIN_STEPS = 3
PLAIN_FNS = ((pk, "chain_tmajor_plain"), (pk, "combine_tmajor_plain"),
             (pk, "chain_tmajor_packed_plain"), (pk, "rfft_chain_tmajor_fused_plain"),
             (pk, "rfft_bwd_chain_tmajor_fused_plain"), (pk, "real_split_tmajor_plain"),
             (fs, "cfft_fused2_plain"), (rk, "real_split_plain"), (ck, "zconv_tmajor_plain"),
             (ck, "zconv_stream_plain"), (pfb, "pfb_fir_plain"),
             (pfb, "pfb_fir_stream_tmajor_plain"))


@contextlib.contextmanager
def plain_autograd():
    """Every kernel wrapper swapped for its plain version and no autograd
    Function entered: torch autograd through the plain versions."""

    needed = _grad.needed
    _grad.needed = lambda *ts: False
    try:
        with plain_kernels():
            yield
    finally:
        _grad.needed = needed


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of every plain version (none may run on the card)."""

    calls = []
    saved = [(mod, name, getattr(mod, name)) for mod, name in PLAIN_FNS]
    for mod, name, fn in saved:
        setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (calls.append(_n), _f(*a, **k))[1])
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def as_real(y: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(y) if y.is_complex() else y


def packed_rfft(x: torch.Tensor, dim: int):
    """The packed real spectrum planes (bin0 = DC + i*Nyquist) of x along
    ``dim`` by complex128 ``torch.fft.rfft`` (differentiable)."""

    f = torch.fft.rfft(x.double(), dim=dim).movedim(dim, -1)
    h = f.shape[-1] - 1
    sr = torch.cat([f[..., :1].real, f[..., 1:h].real], -1)
    si = torch.cat([f[..., h:].real, f[..., 1:h].imag], -1)
    return sr.movedim(-1, dim), si.movedim(-1, dim)


def packed_irfft(sr: torch.Tensor, si: torch.Tensor, dim: int):
    """The unscaled real backward of packed planes by complex128
    ``torch.fft.irfft`` (differentiable)."""

    sr, si = sr.double().movedim(dim, -1), si.double().movedim(dim, -1)
    h = sr.shape[-1]
    z = torch.complex(torch.cat([sr, si[..., :1]], -1),
                      torch.cat([torch.zeros_like(si[..., :1]), si[..., 1:],
                                 torch.zeros_like(si[..., :1])], -1))
    return (torch.fft.irfft(z, n=2 * h, dim=-1) * (2 * h)).movedim(-1, dim)


def grad_transform_fns(kind: str, tm: bool, n: int, backward: bool):
    """(port call, complex128 torch.fft call) on planes of one transform case."""

    dim = 0 if tm else -1
    if kind == "complex":
        plan = pt.new_setup(n)
        call = pt.transform_ordered_split_tmajor if tm else pt.transform_ordered_split
        d = pt.BACKWARD if backward else pt.FORWARD

        def oracle(re, im):
            z = torch.complex(re.double(), im.double())
            y = torch.fft.ifft(z, dim=dim) * n if backward else torch.fft.fft(z, dim=dim)
            return y.real, y.imag

        return (lambda re, im: call(plan, (re, im), d)), oracle
    plan = pt.new_setup(n, pt.REAL)
    call = pt.transform_ordered_split_tmajor if tm else pt.transform_ordered_split
    if backward:
        return (lambda sr, si: (call(plan, (sr, si), pt.BACKWARD),),
                lambda sr, si: (packed_irfft(sr, si, dim),))
    return (lambda x: call(plan, x)), (lambda x: packed_rfft(x, dim))


def grad_case(phase: str, name: str, fn, xs, want_bwd, gen, total, oracle=None, flops=0.0,
              library=None, d_pass=None, inner=5, **info):
    """The gradient of ``fn``'s outputs (a tuple) for the inputs ``xs`` on
    random output gradients, held to torch autograd through the plain
    versions (KERNEL_TOL), the dot-product test (GRAD_DOT_TOL) and, with
    ``oracle`` (the same map in float64 / complex128), complex128 autograd
    (ORACLE_TOL); the backward must launch each of ``want_bwd`` and no plain
    version.  Emits forward and backward ms (CUDA events), device-busy ms
    and host enqueue us beside the forward's bound, and ``library``'s own
    forward and backward; adds the launches to ``total``; returns the row."""

    xs = [x.detach().requires_grad_(True) for x in xs]
    c0 = counts()
    with plain_calls() as plain_run:
        ys = tuple(as_real(y) for y in fn(*xs))
        c1 = counts()
        gs = [torch.randn(y.shape, generator=gen, device=DEV) for y in ys]
        grads = torch.autograd.grad(ys, xs, gs, retain_graph=True)
        torch.cuda.synchronize()
    c2 = counts()
    fwd, bwd = launched(c1, c0), launched(c2, c1)
    for k, v in launched(c2, c0).items():
        total[k] += v
    # torch autograd through the plain versions, on the same inputs
    with plain_autograd():
        xp = [x.detach().clone().requires_grad_(True) for x in xs]
        plain = torch.autograd.grad(tuple(as_real(y) for y in fn(*xp)), xp, gs)
    scale = max(float(p.abs().max()) for p in plain)
    e_plain = max(float((g - p).abs().max()) for g, p in zip(grads, plain)) / scale
    del xp, plain
    # the dot-product test, accumulated in float64
    lhs = sum(float((g.double() * y.detach().double()).sum()) for g, y in zip(gs, ys))
    rhs = sum(float((g.double() * x.detach().double()).sum()) for g, x in zip(grads, xs))
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in gs)
                     * sum(float(y.detach().double().square().sum()) for y in ys))
    e_dot = abs(lhs - rhs) / norm
    row = {"phase": phase, "case": name, **info, "in_shapes": [list(x.shape) for x in xs],
           "rel_err_vs_plain_autograd": e_plain, "dot_product_gap": e_dot,
           "fwd_launches": fwd, "bwd_launches": bwd, "plain_calls": len(plain_run)}
    if oracle is not None:
        xo = [x.detach().double().requires_grad_(True) for x in xs]
        ref = torch.autograd.grad(oracle(*xo), xo, [g.double() for g in gs])
        row["rel_err_vs_complex128"] = max(
            float((g - r).abs().max()) for g, r in zip(grads, ref)) / max(
            float(r.abs().max()) for r in ref)
        del xo, ref
    nbytes = 4.0 * (sum(x.numel() for x in xs) + sum(y.numel() for y in ys))
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    fwd_call = lambda: fn(*xs)
    bwd_call = lambda: torch.autograd.grad(ys, xs, gs, retain_graph=True)
    row["fwd_ms"] = time_ms(fwd_call, inner=inner)
    row["bwd_ms"] = time_ms(bwd_call, inner=inner)
    row["fwd_device_ms"], row["bwd_device_ms"] = device_ms(fwd_call), device_ms(bwd_call)
    row["fwd_enqueue_us"], row["bwd_enqueue_us"] = enqueue_us(fwd_call), enqueue_us(bwd_call)
    if d_pass is not None:
        row["d_pass_ms"] = time_ms(lambda: d_pass(gs), inner=inner)
    if library is not None:
        lib_name, lib_fn = library
        lx = [x.detach().requires_grad_(True) for x in xs]
        ly = lib_fn(*lx)
        lg = torch.randn(ly.shape, dtype=ly.dtype, generator=None, device=DEV)
        row["library"] = lib_name
        row["library_fwd_ms"] = time_ms(lambda: lib_fn(*lx), inner=inner)
        row["library_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(ly, lx, lg, retain_graph=True), inner=inner)
        del lx, ly, lg
    emit(row)
    check(not plain_run, f"{phase} {name}: plain versions ran on the card: {plain_run[:5]}")
    check(e_plain <= KERNEL_TOL, f"{phase} {name}: {e_plain} of the plain autograd gradient")
    check(e_dot <= GRAD_DOT_TOL, f"{phase} {name}: dot-product gap {e_dot}")
    check(row.get("rel_err_vs_complex128", 0.0) <= ORACLE_TOL,
          f"{phase} {name}: {row.get('rel_err_vs_complex128')} of complex128 torch.fft")
    check(all(bwd.get(w, 0) > 0 for w in want_bwd),
          f"{phase} {name}: backward launches {bwd}, expected {want_bwd}")
    check(all(torch.isfinite(g).all() for g in grads), f"{phase} {name}: gradient not finite")
    return row


def phase_grad(gen, smi: str):
    """Gradients through every kernel-backed path at full size: the
    transforms (B1, kern2, B9, B3, B4 + B2 + B5, B6 + B9) both ways,
    FastConv (B7's stream map; "tmajor"), a StreamingConv push (B7's column
    map), a channelizer step (B8 + kern2, gradients for the chunk and the
    history), an oversampled step, DDCChain (mixer + B7) and stft_split,
    each held to torch autograd through the plain versions on the card
    (2e-6 of max|plain gradient|), the dot-product test (1e-5) and, for the
    transforms and the STFT, complex128 ``torch.fft`` autograd (1e-5); the
    backward's launches (no plain version may run); forward and backward ms
    beside the bytes bound and ``torch.fft``'s own backward.  Then three
    steps of gradient descent on a [4, 2^22] signal toward a target
    magnitude spectrogram.  Returns the launch counts of the cases' first
    runs, from zero."""

    reset_counts()
    total = {w.__name__: 0 for w in WRAPPERS}
    dev = torch.device(DEV)

    def case(name, fn, xs, want_bwd, oracle=None, flops=0.0, library=None, d_pass=None,
             inner=5, **info):
        return grad_case("grad", name, fn, xs, want_bwd, gen, total, oracle, flops, library,
                         d_pass, inner, **info)

    # the transforms, both directions
    for kind, tm, n, b in GRAD_TRANSFORMS:
        real = kind == "real"
        shape = (lambda rows: (rows, b)) if tm else (lambda rows: (b, rows))
        plan = pt.new_setup(n, pt.REAL if real else pt.COMPLEX)
        h = n // 2
        eng = D.select_engine(plan, b, tm, dev)
        for backward in (False, True):
            fn, oracle = grad_transform_fns(kind, tm, n, backward)
            dim = 0 if tm else -1
            if real:
                xs = (planes(*shape(h), gen) if backward
                      else (torch.randn(shape(n), generator=gen, device=DEV),))
                lib = (("torch.fft.irfft", lambda sr, si: torch.fft.irfft(
                    torch.complex(sr, si), n=n, dim=dim)) if backward
                       else ("torch.fft.rfft", lambda x: torch.view_as_real(
                           torch.fft.rfft(x, dim=dim))))
                # the backward's D pass on spectrum planes: bins 1 .. H-1
                # halved before the real backward, or doubled after the forward
                spec = planes(*shape(h), gen)
                d_pass = (lambda gs, _s=spec, _tm=tm, _d=2.0 if backward else 0.5:
                          pt.fft._scale_bins(*_s, _d, _tm))
            else:
                xs = planes(*shape(n), gen)
                lib = ("torch.fft.ifft" if backward else "torch.fft.fft",
                       lambda re, im, _bw=backward: torch.view_as_real(
                           (torch.fft.ifft if _bw else torch.fft.fft)(torch.complex(re, im),
                                                                     dim=dim)))
                d_pass = None
            want = grad_kernels(kind, tm, eng, backward)
            case(f"{kind}_{'tmajor' if tm else 'bmajor'}", fn, xs, want, oracle,
                 fft_flops(h if real else n, b), lib, d_pass, n=n, b=b, engine=eng,
                 backward=backward)
            del xs
            torch.cuda.empty_cache()

    # the host's share with gradients: the small public calls of the host
    # lines (complex N = 1024, real N = 8192, B = 16) on inputs that require
    # grad, the forward alone and the forward with its backward
    for kind, n, calls in (("complex", 1024, 200), ("real", 8192, 200)):
        fn, _ = grad_transform_fns(kind, True, n, False)
        xs = ([torch.randn((n, 16), generator=gen, device=DEV).requires_grad_(True)
               for _ in range(2 if kind == "complex" else 1)])
        fn(*xs)
        us = []
        for backward in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                ys = fn(*xs)
                if backward:
                    torch.autograd.grad(ys, xs, [torch.ones_like(y) for y in ys])
            torch.cuda.synchronize()
            us.append((time.perf_counter() - t0) / calls * 1e6)
        emit({"phase": "host", "grad": True, "kind": kind, "n": n, "b": 16,
              "public_call_us": us[0], "call_and_backward_us": us[1]})
    # what a call without gradients pays for them: one _grad.needed check per
    # entry point it passes (one or two a transform)
    x = torch.randn((1024, 16), generator=gen, device=DEV)
    t0 = time.perf_counter()
    for _ in range(100000):
        _grad.needed(x, x)
    emit({"phase": "host", "grad": False, "needed_check_us": (time.perf_counter() - t0) * 10})

    # FastConv on the [16, 2^22] stream: B7's stream map at F = 1024 and
    # 4096 (nfft 2048 and 8192)
    x = torch.randn((CONV_ROWS, CONV_LEN), generator=gen, device=DEV)
    for taps in GRAD_CONV_TAPS:
        fc = C.FastConv(pt.design_lowpass(taps, 0.1), device=DEV)
        route = D.conv_route_mode(fc.nfft, None, dev, stream=True)
        want = ("zconv_stream",) if route == "fused" else ("cfft_chain_tmajor",
                                                          "cfft_combine_tmajor")
        frames = 2 * conv_columns(fc, CONV_ROWS, CONV_LEN)
        case("fastconv", lambda v, _fc=fc: (_fc.apply_batched(v, flush=True),), [x], want,
             flops=2 * fft_flops(fc.nfft, frames // 2), inner=2, taps=taps, nfft=fc.nfft,
             route=route)
        torch.cuda.empty_cache()
    # one StreamingConv push of 2^22 samples: its frames through B7's column map
    sc = C.StreamingConv(pt.design_lowpass(CONV_TAPS[1], 0.1), device=DEV)
    sc._framer.push(np.random.default_rng(SEED).standard_normal(GRAD_PUSH).astype(np.float32))
    fr = torch.from_numpy(sc._framer.frames()).to(DEV)
    case("streaming_conv_push", lambda f: (sc._filter(f),), [fr], ("zconv_tmajor",),
         flops=fft_flops(sc.setup.nfft, fr.shape[0]), inner=2, frames=fr.shape[0],
         nfft=sc.setup.nfft)
    del fr

    # a channelizer step, gradients for the chunk and the history (B8's
    # identity maps, then kern2 at M = 4096), and one oversampled step
    m, p, batch, frames = CHAN_CONFIGS[0]
    ch = CH.Channelizer(m, p, device=DEV)

    def chan_step(hr, hi, xr, xi):
        y, _ = ch.process_split(CH.ChannelizerState(hr, hi), xr, xi)
        return y

    kern2 = D.select_engine(ch.plan, batch * frames, True, dev) == "kern2"
    case("channelizer", chan_step, [*planes(batch, p * m, gen), *planes(batch, frames * m, gen)],
         ("pfb_fir", "cfft_chain_tmajor") + (("cfft_combine_tmajor",) if kern2 else ()),
         flops=fft_flops(m, batch * frames) + 4.0 * p * m * batch * frames, inner=2, m=m, p=p,
         batch=batch, frames=frames)
    om, v, op = GRAD_OVERSAMPLED
    ob, of = CHAN_CONFIGS[1][2], CHAN_CONFIGS[1][3]
    och = CH.OversampledChannelizer(om, v, op, device=DEV)

    def over_step(hr, hi, xr, xi):
        y, _ = och.process_split(CH.ChannelizerState(hr, hi), xr, xi)
        return y

    case("oversampled_channelizer", over_step,
         [*planes(ob, op * om, gen), *planes(ob, of * om, gen)], ("pfb_fir", "cfft_chain_tmajor"),
         flops=v * (fft_flops(om, ob * of) + 4.0 * op * om * ob * of), inner=2, m=om, v=v, p=op,
         batch=ob, frames=of)
    torch.cuda.empty_cache()

    # DDCChain on one chunk of 2^24 complex samples at 129 taps
    ddc = CH.DDCChain(DDC_RATE, pt.design_lowpass(DDC_TAPS[0], 0.5 / DDC_DECIM), DDC_DECIM,
                      device=DEV)
    mixer = ddc.init_state().mixer

    def ddc_step(xr, xi, tr, ti):
        y, st = ddc.process(CH.DDCState(mixer, torch.complex(tr, ti)),
                            torch.complex(xr, xi))
        return y, st.tail

    case("ddc_chain", ddc_step, [torch.randn(DDC_N, generator=gen, device=DEV) for _ in range(2)]
         + [torch.randn(DDC_TAPS[0] - 1, generator=gen, device=DEV) for _ in range(2)],
         ("zconv_stream",), flops=2 * fft_flops(ddc.conv.nfft, DDC_N // ddc.conv.nfft * 4),
         inner=2, taps=DDC_TAPS[0], n=DDC_N)
    torch.cuda.empty_cache()

    # stft_split on [4, 2^22] at 1024 / 512 (B9 and B6 both ways), against
    # complex128 torch.fft autograd and torch.stft's own backward
    sp = pt.spectral
    w = sp.hann(STFT_NFFT)
    wt = torch.from_numpy(w).to(DEV)
    xs = torch.randn(STFT_SHAPE, generator=gen, device=DEV)
    k = (STFT_SHAPE[1] - STFT_NFFT) // STFT_HOP + 1

    def stft_ref(x):
        s = stft_oracle(x, STFT_NFFT, STFT_HOP, w)
        return s.real, s.imag

    case("stft_split", lambda v: sp.stft_split(v, STFT_NFFT, STFT_HOP), [xs],
         ("cfft_fused2", "real_split"), stft_ref,
         flops=fft_flops(STFT_NFFT // 2, STFT_SHAPE[0] * k),
         library=("torch.stft", lambda v: torch.view_as_real(torch.stft(
             v, STFT_NFFT, STFT_HOP, window=wt, center=False, return_complex=True))),
         inner=2, n_fft=STFT_NFFT, hop=STFT_HOP)
    torch.cuda.empty_cache()

    # the trainer: plain gradient descent toward a target magnitude
    # spectrogram; the step is 1/4 of the inverse of the loss's curvature
    # bound (2/numel(S) * n_fft * the window's overlap sum, at most 1.5)
    target = sp.stft_split(torch.randn(STFT_SHAPE, generator=gen, device=DEV), STFT_NFFT,
                           STFT_HOP)
    mag_t = torch.sqrt(target[0] ** 2 + target[1] ** 2)
    lr = 0.25 * mag_t.numel() / (2.0 * STFT_NFFT * 1.5)
    xt = xs.clone().requires_grad_(True)
    c0 = counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS + 1):
        t = time.perf_counter()
        sr, si = sp.stft_split(xt, STFT_NFFT, STFT_HOP)
        loss = ((torch.sqrt(sr * sr + si * si + 1e-12) - mag_t) ** 2).mean()
        (g,) = torch.autograd.grad(loss, xt)
        with torch.no_grad():
            xt -= lr * g
        losses.append(float(loss.detach()))  # synchronizes
        step_ms.append((time.perf_counter() - t) * 1e3)
    steps = launched(counts(), c0)
    for k_, v_ in steps.items():
        total[k_] += v_
    emit({"phase": "grad", "case": "trainer", "shape": list(STFT_SHAPE), "n_fft": STFT_NFFT,
          "hop": STFT_HOP, "lr": lr, "losses": losses, "step_ms": step_ms,
          "launches": steps, "card": smi})
    check(all(b_ < a_ for a_, b_ in zip(losses, losses[1:])),
          f"trainer: the loss did not fall at every step: {losses}")
    check(all(steps.get(w_, 0) > 0 for w_ in ("cfft_fused2", "real_split")),
          f"trainer: launches {steps}")
    emit({"phase": "grad", "launches": total})
    return total


def phase_vmap(gen):
    """``torch.func.vmap`` over the public calls at the full widths: each
    vmapped call against the loop of unbatched calls (KERNEL_TOL of max),
    with every kernel launched as often as by one unbatched call (the
    mapped dimension folds into the kernel's batch), its ms beside the
    loop's and, where the call has a batched form, the batched call's.
    Returns the launch counts of the vmapped calls, from zero."""

    from torch.func import grad, vmap
    from torch.utils._pytree import tree_leaves, tree_map

    total = {w.__name__: 0 for w in WRAPPERS}
    v = VMAP_V

    def stack(*ts):
        return torch.stack(ts) if isinstance(ts[0], torch.Tensor) else torch.tensor(ts)

    def case(name, fn, args, in_dims, batched=None, kernels=True, **info):
        # kernels=False: a call that runs no kernel (the CIC's matmul)
        def row(i):
            return [a if d is None else tree_map(lambda t: t[i], a) for a, d in zip(args, in_dims)]

        size = next(tree_leaves(a)[0].shape[0] for a, d in zip(args, in_dims) if d is not None)
        vfn = vmap(fn, in_dims=in_dims)
        loop = lambda: [fn(*row(i)) for i in range(size)]
        c0 = counts()
        fn(*row(0))
        torch.cuda.synchronize()
        one = launched(counts(), c0)
        c0 = counts()
        got = vfn(*args)
        torch.cuda.synchronize()
        folded = launched(counts(), c0)
        for k, n in folded.items():
            total[k] += n
        want = tree_map(stack, *loop())
        err = 0.0
        for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
            check(g.shape == w.shape, f"vmap {name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
            if g.is_floating_point() or g.is_complex():
                err = max(err, rel_err(g, w))
            else:
                check(bool(torch.equal(g, w)), f"vmap {name}: integer state differs")
        del got, want
        out = {"phase": "vmap", "case": name, **info, "launches": folded,
               "unbatched_launches": one, "rel_err_vs_loop": err,
               "ms": time_ms(lambda: vfn(*args), inner=2), "loop_ms": time_ms(loop, inner=1),
               "enqueue_us": enqueue_us(lambda: vfn(*args), calls=10)}
        if batched is not None:
            out["batched_ms"] = time_ms(batched, inner=2)
            out["batched_enqueue_us"] = enqueue_us(batched, calls=10)
        emit(out)
        check(err <= KERNEL_TOL, f"vmap {name}: {err} of the loop of unbatched calls")
        check(folded == one and bool(one) == kernels,
              f"vmap {name}: launched {folded}, one unbatched call {one}")
        torch.cuda.empty_cache()
        return folded

    def cplx(shape):
        return torch.complex(*(torch.randn(shape, generator=gen, device=DEV) for _ in range(2)))

    # FastConv over [V, 4, 2^22]: B7's stream map at 1024 taps, kern2 around
    # the composed route's copies at 4096; the batched call takes [4V, L]
    rows = CONV_ROWS // v
    x = torch.randn((v, rows, VMAP_CONV_LEN), generator=gen, device=DEV)
    for taps in VMAP_CONV_TAPS:
        fc = C.FastConv(pt.design_lowpass(taps, 0.1))
        case("fastconv", fc.apply_batched, (x,), (0,),
             lambda _fc=fc: _fc.apply_batched(x.view(v * rows, -1)), taps=taps,
             route=D.conv_route_mode(fc.nfft, None, torch.device(DEV), stream=True),
             shape=list(x.shape))
    del x
    # StreamingConv's block step over V streams' frames (B7's column map);
    # the batched call filters all V*k frames at once
    sc = C.StreamingConv(pt.design_lowpass(VMAP_CONV_TAPS[0], 0.1))
    k = (VMAP_CONV_LEN - sc.setup.nfft) // sc.setup.num_out_per_block + 1
    fr = torch.randn((v, k, sc.setup.nfft), generator=gen, device=DEV)
    case("streaming_conv_frames", sc._filter, (fr,), (0,),
         lambda: sc._filter(fr.view(v * k, -1)), frames=k, nfft=sc.setup.nfft)
    del fr
    # the channelizers over CHAN_CONFIGS' streams, one state each; the
    # batched call takes the streams as a leading dimension
    m, p, streams, frames = CHAN_CONFIGS[0]
    ch = CH.Channelizer(m, p)
    st = CH.ChannelizerState(*planes(streams, p * m, gen))
    cx = cplx((streams, frames * m))
    case("channelizer", ch.process, (st, cx), (0, 0), lambda: ch.process(st, cx), m=m, p=p,
         streams=streams, frames=frames)
    om, ov, op = GRAD_OVERSAMPLED
    ostreams, oframes = CHAN_CONFIGS[1][2:]
    och = CH.OversampledChannelizer(om, ov, op)
    ost = CH.ChannelizerState(*planes(ostreams, op * om, gen))
    ox = cplx((ostreams, oframes * om))
    case("oversampled_channelizer", och.process, (ost, ox), (0, 0),
         lambda: och.process(ost, ox), m=om, v=ov, p=op, streams=ostreams, frames=oframes)
    del ost, ox, och
    # DDCChain at 129 taps and the CIC over V x 2^22, each stream with its
    # own NCO phase and history (no batched form: both take one stream)
    rng = np.random.default_rng(SEED)
    ddc = CH.DDCChain(DDC_RATE, pt.design_lowpass(DDC_TAPS[0], 0.5 / DDC_DECIM), DDC_DECIM)
    rate_fp = pt.dsp.mixer_init(DDC_RATE).rate_fp
    dst = CH.ddc_state_from_arrays(
        rng.integers(0, 1 << 32, v), np.full(v, rate_fp),
        (rng.standard_normal((v, DDC_TAPS[0] - 1))
         + 1j * rng.standard_normal((v, DDC_TAPS[0] - 1))).astype(np.complex64), DEV)
    dx = cplx((v, VMAP_DSP_N))
    case("ddc_chain", ddc.process, (dst, dx), (0, 0), taps=DDC_TAPS[0], n=VMAP_DSP_N)
    cic = pt.dsp.CicDDC(VMAP_CIC_FACTOR)
    cst = pt.dsp.cic.state_from_arrays(
        rng.integers(0, 1 << 32, v), *rng.standard_normal((2, v, 2 * VMAP_CIC_FACTOR)), DEV)
    case("cic", lambda s_, x_: cic.apply(s_, x_, MIX_RATE), (cst, dx), (0, 0), kernels=False,
         factor=VMAP_CIC_FACTOR, n=VMAP_DSP_N)
    del dx
    # per-sample gradients: FastConv at 1024 taps over [V, 4, 2^20] (B7's
    # stream map both ways) and the channelizer step over CHAN_CONFIGS[0]'s
    # streams (B8's stream map, then its identity maps in the backward)
    fc = C.FastConv(pt.design_lowpass(VMAP_CONV_TAPS[0], 0.1))
    x = torch.randn((v, rows, VMAP_GRAD_LEN), generator=gen, device=DEV)
    w = torch.randn((v, rows, VMAP_GRAD_LEN - fc.filter_len + 1), generator=gen, device=DEV)
    case("fastconv_grad", grad(lambda x_, w_: (fc.apply_batched(x_) * w_).sum()), (x, w),
         (0, 0), taps=VMAP_CONV_TAPS[0], shape=list(x.shape))
    del x, w

    def chan_loss(hr, hi, xr, xi, wr, wi):
        (yr, yi), _ = ch.process_split(CH.ChannelizerState(hr, hi), xr, xi)
        return (yr * wr).sum() + (yi * wi).sum()

    ws = planes(streams * frames, m, gen)
    got = case("channelizer_grad", grad(chan_loss, argnums=(2, 3)),
               (*st, cx.real.contiguous(), cx.imag.contiguous(),
                *(t.view(streams, frames, m) for t in ws)), (0,) * 6, m=m, p=p,
               streams=streams, frames=frames)
    check(got.get("pfb_fir", 0) > 0, f"vmap(grad) of the channelizer: launches {got}")
    emit({"phase": "vmap", "launches": total})
    return total


def grad_kernels(kind: str, tm: bool, engine: str, backward: bool):
    """The kernels the backward of one transform case must launch: the
    adjoint is the transform of the other direction on the same route."""

    if kind == "complex":
        if not tm:
            return ("cfft_fused2",) if engine == "fused2" else ("cfft_chain_tmajor",)
        return ("cfft_chain_tmajor",) + (("cfft_combine_tmajor",) if engine == "kern2" else ())
    if not tm:
        return ("cfft_fused2", "real_split")
    if engine == "chain":  # B3: the adjoint of one direction is the other's kernel
        return ("rfft_chain_tmajor_fused",) if backward else ("rfft_bwd_chain_tmajor_fused",)
    if backward:  # the adjoint of the real backward: the packed chain, combine, split
        return ("cfft_chain_tmajor_packed", "cfft_combine_tmajor", "real_split_tmajor")
    return ("real_split_tmajor", "cfft_chain_tmajor", "cfft_combine_tmajor")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    secs = {}

    def run(fn, *args):
        """``fn(*args)``, its seconds kept under its name."""

        t = time.perf_counter()
        out = fn(*args)
        secs[fn.__name__] = time.perf_counter() - t
        return out

    smi = run(phase_env)
    run(phase_build)
    errs = run(phase_kernels, gen)
    run(phase_oracle, gen)
    launches, per_shape = run(phase_main_path, gen)
    real_launches, real_shapes = run(phase_real_main_path, gen)
    conv_launches, conv_runs = run(phase_fastconv, gen)
    chan_launches, chan_runs = run(phase_channelizer, gen)
    bm_launches, bm_shapes = run(phase_bmajor_main, gen)
    bmr_launches, bmr_shapes = run(phase_bmajor_real_main, gen)
    ks2_launches = run(phase_ksplit2, gen)
    run(phase_f64, gen)
    dsp_launches = run(phase_dsp, gen)
    spectral_launches = run(phase_spectral, gen)
    anylen_launches = run(phase_anylen, gen)
    cap_launches = run(phase_capture, gen, smi)
    par_launches = run(phase_parallel, gen)
    rows = run(phase_timing, gen, per_shape)
    rows.update(run(phase_real_timing, gen, real_shapes))
    run(phase_real_fused_sweep, gen)
    rows.update(run(phase_fir_timing, gen, conv_runs, chan_runs))
    rows.update(run(phase_bmajor_timing, gen, bm_shapes, bmr_shapes))
    rows.update(run(phase_ksplit2_timing, gen))
    run(phase_anylen_timing, gen)
    grad_launches = run(phase_grad, gen, smi)
    vmap_launches = run(phase_vmap, gen)
    tune_launches = run(phase_tune, gen)
    for name in ("chain", "combine", "copy", "chain_packed", "real_fused", "real_split",
                 "conv_fused", "pfb_fir", "fused2", "real_split_bmajor", "ksplit2"):
        check(name in rows, f"no timing row for {name}")
    check(launches["cfft_chain_tmajor"] > 0 and launches["cfft_combine_tmajor"] > 0,
          f"complex main path did not launch every path kernel: {launches}")
    for name in ("cfft_chain_tmajor_packed", "rfft_chain_tmajor_fused",
                 "rfft_bwd_chain_tmajor_fused", "real_split_tmajor"):
        check(real_launches[name] > 0,
              f"real main path did not launch every path kernel: {real_launches}")
    for name in ("zconv_stream", "zconv_tmajor", "cfft_chain_tmajor", "cfft_combine_tmajor"):
        check(conv_launches[name] > 0,
              f"FastConv path did not launch every path kernel: {conv_launches}")
    for name in ("pfb_fir_stream_tmajor", "cfft_chain_tmajor", "cfft_combine_tmajor"):
        check(chan_launches[name] > 0,
              f"channelizer path did not launch every path kernel: {chan_launches}")
    for name in ("cfft_fused2", "cfft_chain_tmajor", "cfft_combine_tmajor"):
        check(bm_launches[name] > 0,
              f"batch-major path did not launch every path kernel: {bm_launches}")
    for name in ("cfft_fused2", "real_split", "cfft_chain_tmajor", "cfft_combine_tmajor"):
        check(bmr_launches[name] > 0,
              f"batch-major real path did not launch every path kernel: {bmr_launches}")
    check(ks2_launches["cfft_ksplit2_tmajor"] > 0, f"B10's path did not launch it: {ks2_launches}")
    for name in ("pfb_fir_stream_tmajor", "cfft_chain_tmajor", "cfft_combine_tmajor",
                 "zconv_tmajor"):
        check(cap_launches[name] > 0,
              f"capture path did not launch every path kernel: {cap_launches}")
    for name in ("cfft_chain_tmajor", "cfft_combine_tmajor", "cfft_fused2", "zconv_stream"):
        check(sum(c[name] for c in par_launches) > 0,
              f"distribution paths did not launch every path kernel: {par_launches}")
    for name in ("cfft_chain_tmajor", "cfft_combine_tmajor", "cfft_chain_tmajor_packed",
                 "rfft_chain_tmajor_fused", "rfft_bwd_chain_tmajor_fused", "real_split_tmajor",
                 "real_split", "zconv_stream", "zconv_tmajor", "pfb_fir", "cfft_fused2"):
        check(grad_launches[name] > 0,
              f"the gradient paths did not launch every path kernel: {grad_launches}")
    for name in ("zconv_stream", "zconv_tmajor", "pfb_fir_stream_tmajor", "pfb_fir"):
        check(vmap_launches[name] > 0,
              f"the vmapped paths did not launch every path kernel: {vmap_launches}")
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "phase_seconds": secs, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # launches: the count over the main-path runs, each from zero (the nine
    # paths, then the anylen paths, the capture path, the distribution
    # layer's four paths and their gradients, the gradient paths' forward
    # and backward, the vmapped calls and measure mode's public calls); the
    # float64 phases launch none
    paths = (launches, real_launches, conv_launches, chan_launches, bm_launches,
             bmr_launches, ks2_launches, dsp_launches, spectral_launches,
             *anylen_launches, cap_launches, *par_launches, grad_launches, vmap_launches,
             tune_launches)
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
        "conv_fused": ("pffft_tpu_torch/csrc/conv_fused.cu",
                       "pffft_tpu/ops/conv_kernel.py:180", ("zconv_tmajor", "zconv_stream")),
        "pfb_fir": ("pffft_tpu_torch/csrc/pfb_fir.cu", "pffft_tpu/ops/pfb_kernel.py:85",
                    ("pfb_fir", "pfb_fir_stream_tmajor")),
        "fused2": ("pffft_tpu_torch/csrc/fused2.cu", "pffft_tpu/ops/fused_stage.py:168",
                   ("cfft_fused2",)),
        "real_split_bmajor": ("pffft_tpu_torch/csrc/real_split_bmajor.cu",
                              "pffft_tpu/ops/real_kernel.py:144", ("real_split",)),
        "ksplit2": ("pffft_tpu_torch/csrc/ksplit2.cu", "pffft_tpu/ops/dispatch.py:278",
                    ("cfft_ksplit2_tmajor",)),
    }
    kernels = []
    for name, (src, rep, wrappers) in meta.items():
        row = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": sum(c[w] for c in paths for w in wrappers),
                        "max_abs_err": errs[name],
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": row["shape"],
                        **{k: row[k] for k in ("library", "tile", "card_blocks_per_sm",
                                               "stream_ms", "stream_bound_ms", "bwd_ms",
                                               "plain_bwd_ms",
                                               "library_bwd_ms", "ptxas") if k in row}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
