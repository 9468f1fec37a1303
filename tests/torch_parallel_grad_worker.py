"""The gradient cases of the port's distribution layer, run in every rank of
a gloo world on the CPU.

Imports only numpy, torch and the port (no jax, no pffft_tpu): the spawned
ranks import this module, and ``tests/test_torch_parallel_grad.py`` imports
it for the seeded inputs, the cases' loss weights and :func:`rank_main`,
which ``torch_parallel_worker.run_world`` spawns.

Every case is a differentiable map of one input through a parallel entry
point; its loss is sum(Re(y) * wr + Im(y) * wi) over the gathered output
(sum(y * w) for a real one), the same on every rank.  Each case runs on
three kinds of input: a plain leaf (the same global tensor on every rank),
a non-leaf computed from one, and a DTensor leaf sharded along the
transform's sharded axis.  The result of a case is the input's whole
gradient as numpy (a DTensor's gathered), or the string "None" when no
gradient arrived.
"""

from __future__ import annotations

import datetime
import traceback

import numpy as np
import torch
import torch.distributed as dist

from torch_parallel_worker import PG_TIMEOUT_S

KINDS = ("leaf", "nonleaf", "dtensor")
# the conv cases' filter lengths: the halo of a shard is its first F - 1 samples
CONV_TAPS = {"conv": 33, "conv_cplx": 49, "conv_chan": 21, "conv_f64": 40}


def _cplx(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def make_inputs() -> dict:
    """The seeded input of every case, shared with the JAX side."""

    r = np.random.default_rng(20261)
    inp = {
        "cfft": _cplx(r, (2, 1024)),
        "cfft_internal": _cplx(r, (2, 4096)),
        "icfft": _cplx(r, (2, 4096)),
        "icfft_internal": _cplx(r, (2, 4096)),
        "reorder_canonical": _cplx(r, (2, 4096)),
        "reorder_internal": _cplx(r, (2, 4096)),
        "rfft": r.standard_normal((2, 8192)).astype(np.float32),
        "irfft": _cplx(r, (2, 4096)),
        "cfft_f64": _cplx(r, (2, 4096), np.complex128),
        "rfft_f64": r.standard_normal(8192),
        "pencil": _cplx(r, (2, 64, 96)),
        "pencil_t": _cplx(r, (2, 64, 96)),
        "ipencil": _cplx(r, (2, 64, 96)),
        "ipencil_t": _cplx(r, (2, 96, 64)),
        "conv": r.standard_normal((2, 4096)).astype(np.float32),
        "conv_cplx": _cplx(r, 4096),
        "conv_chan": r.standard_normal((3, 2048)).astype(np.float32),
        "conv_f64": r.standard_normal((2, 4096)),
    }
    for case, f in CONV_TAPS.items():
        h = r.standard_normal(f)
        inp[f"{case}_h"] = h if case == "conv_f64" else h.astype(np.float32)
    return inp


CASES = tuple(k for k in make_inputs() if not k.endswith("_h"))
F64_CASES = {"cfft_f64", "rfft_f64", "conv_f64"}
# the input axis each case shards over the mesh (a DTensor input's placement)
SHARD_AXIS = {c: (-2 if c.startswith(("pencil", "ipencil")) else -1) for c in CASES}


def weights(case: str, shape, is_complex: bool, f64: bool):
    """The loss weights (wr, wi) of a case's output of ``shape`` (wi None
    for a real output), seeded by the case's name."""

    rng = np.random.default_rng([20262, *case.encode()])
    dt = np.float64 if f64 else np.float32
    wr = rng.standard_normal(shape).astype(dt)
    return wr, (rng.standard_normal(shape).astype(dt) if is_complex else None)


def _case_fns(pt, pp, mesh, inp):
    """{case: the map of one input (a tensor or DTensor) to the output}."""

    fs = pp.FourStepPlan(4096, mesh, n1=64)
    fr = pp.FourStepPlan(8192, mesh, kind=pt.REAL)
    fd = pp.FourStepPlan(4096, mesh, dtype="float64", n1=64)
    frd = pp.FourStepPlan(8192, mesh, kind=pt.REAL, dtype="float64")
    pen = pp.Pencil2D((64, 96), mesh)

    def conv(case, **kw):
        setup = pt.conv.FastConv(inp[f"{case}_h"], device="cpu", **kw)
        return lambda x: pp.sharded_fastconv_valid(setup, x, mesh)

    return {
        "cfft": lambda x: pp.FourStepPlan(1024, mesh).forward(x),
        "cfft_internal": lambda x: fs.forward(x, ordered=False),
        "icfft": lambda x: fs.backward(x),
        "icfft_internal": lambda x: fs.backward(x, ordered=False),
        "reorder_canonical": lambda x: fs.reorder(x, to_canonical=True),
        "reorder_internal": lambda x: fs.reorder(x, to_canonical=False),
        "rfft": fr.forward,
        "irfft": fr.backward,
        "cfft_f64": fd.forward,
        "rfft_f64": frd.forward,
        "pencil": pen.forward,
        "pencil_t": lambda x: pen.forward(x, transposed=True),
        "ipencil": pen.backward,
        "ipencil_t": lambda x: pen.backward(x, transposed=True),
        "conv": conv("conv"),
        "conv_cplx": conv("conv_cplx", flags=pt.ConvFlags.CPLX_INP_OUT),
        "conv_chan": conv("conv_chan"),
        "conv_f64": conv("conv_f64", dtype="float64"),
    }


def _loss(case: str, y: torch.Tensor) -> torch.Tensor:
    wr, wi = weights(case, tuple(y.shape), y.is_complex(),
                     y.dtype in (torch.float64, torch.complex128))
    if wi is None:
        return (y * torch.from_numpy(wr)).sum()
    return (y.real * torch.from_numpy(wr)).sum() + (y.imag * torch.from_numpy(wi)).sum()


def _grad_of(case: str, fn, value: torch.Tensor, kind: str, mesh, pp):
    """The whole gradient of the case's loss for one kind of input."""

    if kind == "dtensor":
        x = pp.shard_batch(value, mesh, axis=SHARD_AXIS[case]).requires_grad_(True)
        leaf = x
    else:
        leaf = value.clone().requires_grad_(True)
        x = leaf * 1 if kind == "nonleaf" else leaf
    y = fn(x)
    _loss(case, y.full_tensor() if hasattr(y, "full_tensor") else y).backward()
    g = leaf.grad
    if g is None:
        return "None"
    return (g.full_tensor() if hasattr(g, "full_tensor") else g).detach().numpy()


def run_cases(world: int) -> dict:
    """{case: {kind: gradient}} in this rank (identical on every rank)."""

    import pffft_tpu_torch as pt
    from pffft_tpu_torch import parallel as pp

    inp = make_inputs()
    mesh = pp.make_mesh(device_type="cpu")
    fns = _case_fns(pt, pp, mesh, inp)
    return {case: {kind: _grad_of(case, fns[case], torch.from_numpy(inp[case]), kind, mesh, pp)
                   for kind in KINDS} for case in CASES}


def rank_main(rank: int, world: int, init_file: str, results) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            out = run_cases(world)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, out if rank == 0 else None))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise
