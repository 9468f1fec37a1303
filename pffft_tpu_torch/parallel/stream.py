"""Sharded streaming: overlap-save halo exchange (the CP analog).

Counterpart of ``pffft_tpu/parallel/stream.py``.  PFFASTCONV's streaming
contract is sequential: ``pffastconv_apply`` consumes a block, the caller
carries ``filterLen-1`` tail samples to the next call.  Sharding a stream
over ranks turns that carried tail into a **halo**: producing the valid
outputs of shard d requires the first ``filterLen-1`` samples of shard
d+1.  One send/recv fetches it, and every rank then runs the port's
batched overlap-save pipeline (``FastConv._conv_stream``: the fused
conv kernel's stream map at nfft <= 16384) on its own samples and the halo
— the structure PFFASTCONV uses across *calls*, re-expressed across
*ranks*.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import conv as _conv
from . import _comm

__all__ = ["halo_exchange_right", "sharded_fastconv_valid"]


def halo_exchange_right(x_local: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """The first ``halo`` samples (last axis) of the *next* rank's
    ``x_local`` in ``group`` (the default group when None); the last rank
    receives zeros (stream end padding).  At one rank no collective runs.
    Differentiable: the halo's gradient goes back to the rank it came from
    and lands on that rank's first ``halo`` samples."""

    if halo <= 0:
        return x_local[..., :0]
    head = x_local[..., :halo]
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return torch.zeros_like(head)
    # rank i sends its head to rank i-1 and receives rank i+1's
    return _comm.shift(head, rank - 1 if rank > 0 else None,
                       rank + 1 if rank < n - 1 else None, group)


def sharded_fastconv_valid(
    setup: _conv.FastConv,
    x,
    mesh: DeviceMesh,
    axis_name: Optional[str] = None,
):
    """Valid-mode fast convolution of a mesh-sharded stream.

    x: [..., L] with the last axis sharded contiguously over ``axis_name``
    (a DTensor, or the same global tensor on every rank; leading axes are
    batch/channel).  Returns a DTensor [..., L - filterLen + 1], matching
    ``np.convolve(x, h, 'valid')`` per row (or correlation with the
    CORRELATION flag) — the flush-mode output of PFFASTCONV's streaming
    loop, computed in one step across all shards.  Every rank computes its
    shard of the [..., L] result; the last filterLen - 1 samples are cut
    by slicing the DTensor, which gathers the result (DTensor replicates
    a slice of a sharded axis)."""

    if setup.cplx_filter or setup.single_fft:
        raise NotImplementedError(
            "sharded streaming supports real-filter modes (NONE / CPLX_INP_OUT)"
        )
    ax = _comm.MeshAxis(mesh, axis_name)
    n_shards = ax.size
    f = setup.filter_len
    halo = f - 1
    length = x.shape[-1]
    if length % n_shards:
        raise ValueError(f"stream length {length} must divide over {n_shards} shards")
    l_local = length // n_shards
    if l_local < halo:
        raise ValueError(
            f"per-shard length {l_local} shorter than the filter halo {halo}"
        )

    xl, place = ax.local(x, -1)
    complex_stream = setup.cplx_stream or xl.is_complex()
    f64 = setup.dtype == np.float64
    if complex_stream:
        xl = xl.to(torch.complex128 if f64 else torch.complex64)
    else:
        xl = xl.to(torch.float64 if f64 else torch.float32)
    ext = torch.cat([xl, halo_exchange_right(xl, halo, ax.group)], dim=-1)
    lead = ext.shape[:-1]
    y = setup._conv_stream(ext.reshape(-1, ext.shape[-1]), l_local)
    y = ax.dtensor(y.reshape(*lead, l_local), place)
    return y[..., : length - f + 1]
