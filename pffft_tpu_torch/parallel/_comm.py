"""The collectives of the distribution layer, on one mesh axis.

Every exchange works on contiguous blocks: the block for rank j is laid
out at index j of a leading axis, ``all_to_all_single`` swaps the blocks,
and one permute puts the received blocks where the next local phase
wants them.  At one shard nothing is sent: the exchange is the identity
and only the layout copies remain.

Every exchange is differentiable: each collective is an autograd Function
whose backward runs its adjoint on the gradient (an all-to-all of equal
blocks is its own adjoint; a shift to one rank and from another is
adjoint to the shift the other way), and a plain tensor's shard is a
slice whose backward gathers the shards' gradients, so a gradient reaches
an input given as the same global tensor on every rank whole, as it does
a DTensor's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ..ops import _grad
from . import mesh as _mesh


def global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def sendrecv(ops: Sequence[Tuple[str, torch.Tensor, int]], group) -> None:
    """Run point-to-point ops ("send" or "recv", tensor, rank in ``group``)
    as one batch and wait for all of them."""

    if not ops:
        return
    fns = {"send": dist.isend, "recv": dist.irecv}
    batch = [dist.P2POp(fns[kind], t, global_rank(group, r), group) for kind, t, r in ops]
    for req in dist.batch_isend_irecv(batch):
        req.wait()


def _shift(x: torch.Tensor, to: Optional[int], frm: Optional[int], group) -> torch.Tensor:
    out = torch.zeros_like(x) if frm is None else torch.empty_like(x)
    ops = [] if to is None else [("send", x, to)]
    if frm is not None:
        ops.append(("recv", out, frm))
    sendrecv(ops, group)
    return out


class _Shift(torch.autograd.Function):
    """x sent to rank ``to`` and the result received from rank ``frm`` (None:
    send nothing, or receive zeros).  Its adjoint sends the gradient the
    other way: to ``frm``, and receives from ``to``."""

    @staticmethod
    def forward(x, to, frm, group):
        return _shift(x, to, frm, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.to, ctx.frm, ctx.group = inputs

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.frm, ctx.to, ctx.group), None, None, None


def shift(x: torch.Tensor, to: Optional[int], frm: Optional[int], group) -> torch.Tensor:
    """This rank's ``x`` sent to rank ``to`` of ``group`` while the result is
    received from rank ``frm`` (None: nothing sent, or zeros received); every
    rank of the pattern calls it.  Differentiable."""

    x = x.contiguous()
    if _grad.needed(x):
        return _Shift.apply(x, to, frm, group)
    return _shift(x, to, frm, group)


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """all_to_all of equal blocks: block j to rank j.  Its own adjoint: the
    gradient of received block i goes back to rank i as its block j."""

    @staticmethod
    def forward(send, group):
        return _all_to_all(send, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


class _Scatter(torch.autograd.Function):
    """This rank's block ``x.narrow(axis, start, length)`` of a tensor that
    every rank holds whole.  The adjoint gathers every rank's block
    gradient, so each rank's input gradient is the whole one."""

    @staticmethod
    def forward(x, axis, start, length, size, group):
        return x.narrow(axis, start, length)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.axis, _, _, ctx.size, ctx.group = inputs
        ctx.extent = x.shape[ctx.axis]

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.axis, 0).contiguous()
        chunk = -(-ctx.extent // ctx.size)
        if g.shape[0] < chunk:  # a short last block: equal sizes on the wire
            g = torch.nn.functional.pad(g, (0, 0) * (g.ndim - 1) + (0, chunk - g.shape[0]))
        parts = [torch.empty_like(g) for _ in range(ctx.size)]
        dist.all_gather(parts, g, group=ctx.group)
        full = torch.cat(parts)[:ctx.extent].movedim(0, ctx.axis)
        return full, None, None, None, None, None


class MeshAxis:
    """One axis of a device mesh: its process group, size and this rank's
    coordinate, and the conversions between DTensors and local shards."""

    def __init__(self, mesh: DeviceMesh, axis_name: Optional[str]):
        self.mesh = mesh
        self.name = axis_name or mesh.mesh_dim_names[0]
        self.dim = mesh.mesh_dim_names.index(self.name)
        self.size = mesh.size(self.dim)
        self.rank = mesh.get_local_rank(self.dim)
        self.group = mesh.get_group(self.dim)
        if mesh.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(mesh.device_type)

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A host table on the mesh's device."""

        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def local(self, x, axis: int) -> Tuple[torch.Tensor, List[Placement]]:
        """This rank's shard of ``x`` with ``axis`` split over this mesh
        axis, and the placements of that layout.

        A DTensor is redistributed as needed (its other mesh axes keep
        their placements unless they split ``axis`` too); a tensor is
        taken as the same global tensor on every rank and this rank's
        block sliced out of it, in DTensor's chunks (a gradient gathers
        the blocks' gradients back).  A tensor on another device type than
        the mesh's raises."""

        if isinstance(x, DTensor):
            if x.device_mesh != self.mesh:
                raise ValueError("the DTensor lies on another mesh than the plan's")
            axis %= x.ndim
            place = [Replicate() if p == Shard(axis) else p for p in x.placements]
            place[self.dim] = Shard(axis)
            return x.redistribute(self.mesh, place).to_local(), place
        _mesh.check_device(x, self.mesh)
        place = list(_mesh.batch_sharding(self.mesh, x.ndim, axis, self.name))
        axis %= x.ndim
        extent = x.shape[axis]
        chunk = -(-extent // self.size)
        start = min(self.rank * chunk, extent)
        length = min(chunk, extent - start)
        if self.size > 1 and _grad.needed(x):
            return _Scatter.apply(x, axis, start, length, self.size, self.group), place
        return x.narrow(axis, start, length), place

    def dtensor(self, local: torch.Tensor, place: Sequence[Placement]) -> DTensor:
        return DTensor.from_local(local, self.mesh, list(place), run_check=False)

    def exchange(self, send: torch.Tensor) -> torch.Tensor:
        """all_to_all of a contiguous [D, ...] tensor: block j goes to rank
        j, and block i of the result came from rank i."""

        send = send.contiguous()
        if self.size == 1:
            return send
        if _grad.needed(send):
            return _AllToAll.apply(send, self.group)
        return _all_to_all(send, self.group)

    # The three exchange patterns of the four-step and the pencil, each on
    # a list of planes.  A "rows" tensor is [B, a/D, c] (this rank's block
    # of a, all of c); a "columns" tensor is [a, B, c/D] (all of a, this
    # rank's block of c), time-major planes [a, B*c/D].
    def rows_to_cols(self, planes, a: int, c: int):
        """[B, a/D, c] -> [a, B, c/D]: rank j gets block j of c."""

        d = self.size
        out = []
        for t in planes:
            b = t.shape[0]
            send = t.reshape(b, a // d, d, c // d).permute(2, 1, 0, 3).contiguous()
            out.append(self.exchange(send).view(a, b, c // d))
        return out

    def cols_to_rows(self, planes, a: int, c: int):
        """[a, B, c/D] -> [B, a/D, c]: rank j gets block j of a."""

        d = self.size
        out = []
        for t in planes:
            b = t.shape[1]
            recv = self.exchange(t.reshape(d, a // d, b, c // d))
            out.append(recv.permute(2, 1, 0, 3).reshape(b, a // d, c))
        return out

    def transpose_rows(self, planes, a: int, c: int):
        """[B, a/D, c] -> [B, c/D, a]: the global [a, c] transposed, rank j
        getting block j of c."""

        d = self.size
        out = []
        for t in planes:
            b = t.shape[0]
            send = t.reshape(b, a // d, d, c // d).permute(2, 0, 3, 1).contiguous()
            recv = self.exchange(send)
            out.append(recv.permute(1, 2, 0, 3).reshape(b, c // d, a))
        return out
