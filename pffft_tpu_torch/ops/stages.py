"""Complex-dtype stage engine and the internal spectrum layout.

Counterpart of ``pffft_tpu/ops/stages.py``: thin complex-dtype wrappers
over the planar engine of ``ops/split.py``, and the map between the
internal and the canonical spectrum order.

Internal order: skipping the final stage's transpose-merge leaves the
spectrum with flat index l*r_last + t holding bin t*L + l (L the product
of all factors but the last).  Pointwise spectral products work in it, and
:func:`reorder_spectrum` (a reshape and transpose) maps it to canonical
order and back.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import split as _split


def cfft_stages(x: torch.Tensor, stages: Sequence, *, backward: bool,
                ordered: bool) -> torch.Tensor:
    """The staged complex FFT over the last axis of complex ``x`` [..., N].

    Unscaled in both directions (backward(forward(x)) == N * x)."""

    re, im = _split.to_split(x)
    rr, ri = _split.cfft_stages_split(re, im, stages, backward=backward, ordered=ordered)
    return _split.from_split((rr, ri), x.dtype)


def cfft_plan(x: torch.Tensor, plan, *, backward: bool, ordered: bool) -> torch.Tensor:
    """Plan-level complex wrapper (handles a reference plan's local split)."""

    re, im = _split.to_split(x)
    rr, ri = _split.cfft_plan_split(plan, re, im, backward=backward, ordered=ordered)
    return _split.from_split((rr, ri), x.dtype)


def internal_order_shape(factors: Tuple[int, ...]) -> Tuple[int, int]:
    """(L, r) view of the internal layout: internal.reshape(L, r).T.flatten()
    is canonical order.  L = product of all factors but the last, r = last."""

    if len(factors) < 2:
        return (1, int(np.prod(factors)))
    return (int(np.prod(factors[:-1])), factors[-1])


def reorder_spectrum(z: torch.Tensor, factors: Tuple[int, ...],
                     to_canonical: bool) -> torch.Tensor:
    """Map between internal and canonical spectrum order along the last axis
    (internal[l*r + t] == canonical[t*L + l]).  Returns a new contiguous
    tensor, or ``z`` itself where the two orders coincide."""

    l, r = internal_order_shape(factors)
    if l == 1 or r == 1:
        return z
    lead = z.shape[:-1]
    n = z.shape[-1]
    zz = z.reshape(*lead, l, r) if to_canonical else z.reshape(*lead, r, l)
    return zz.transpose(-1, -2).reshape(*lead, n)
