"""Engines of the port: plain stage engine, CUDA kernel wrappers, dispatch."""

from . import dispatch, pallas_fft, split

__all__ = ["dispatch", "pallas_fft", "split"]
