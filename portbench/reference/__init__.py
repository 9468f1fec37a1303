"""Plain references of the benchmark's configurations, in NumPy and PyTorch.

One module per configuration, named as the configuration.  A reference
imports neither JAX nor any package of this repository outside
``portbench/reference/``: it works everything out again from the stream
and the taps that the benchmark made from the seed.  Each module also holds
the configuration's control, the reference computed in TF32.
"""

from __future__ import annotations

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero, as the tensor cores' conversion rounds)."""

    i = t.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|, in float64; 1.0 where it is not finite
    or the shapes differ (nothing to compare is as wrong as it gets)."""

    if tuple(got.shape) != tuple(ref.shape):
        return 1.0
    err = float((got.to(ref.dtype) - ref).abs().max() / ref.abs().max())
    return err if err == err and err != float("inf") else 1.0
