"""Engines of the port: plain stage engines, CUDA kernel wrappers, dispatch."""

from . import dispatch, fused_stage, pallas_fft, real, real_kernel, split, stages

__all__ = ["dispatch", "fused_stage", "pallas_fft", "real", "real_kernel", "split", "stages"]
