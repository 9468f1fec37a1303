"""The cases of the port's distribution layer, run in every rank of a gloo
world on the CPU.

Imports only numpy, torch and the port (no jax, no pffft_tpu): the spawned
ranks import this module, and ``tests/test_torch_parallel.py`` imports it
for the seeded inputs and :func:`run_world`.  Each case returns a numpy
array (the gathered result) or, for an error case, ``(type name,
message)``.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# init_process_group's timeout (a collective that waits longer raises in
# the rank) and the deadline of a whole world (the parent terminates the
# ranks and fails after it)
PG_TIMEOUT_S = 60
WORLD_DEADLINE_S = 120


def _cplx(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def make_inputs() -> dict:
    """The seeded inputs of every case, shared with the JAX side."""

    r = np.random.default_rng(20260)
    inp = {}
    for n in (1024, 4096, 9216):
        inp[f"cfft_{n}"] = _cplx(r, n)
    inp["cfft_batched"] = _cplx(r, (3, 1024))
    inp["cfft_f64"] = _cplx(r, (2, 4096), np.complex128)
    inp["real_4096"] = r.standard_normal(4096).astype(np.float32)
    inp["real_8192"] = r.standard_normal((2, 8192)).astype(np.float32)
    inp["real_f64"] = r.standard_normal(8192)
    for flen in (17, 64, 333):
        inp[f"conv_x_{flen}"] = r.standard_normal(8 * 1024).astype(np.float32)
        inp[f"conv_h_{flen}"] = r.standard_normal(flen).astype(np.float32)
    inp["conv_local_x"] = r.standard_normal(4096).astype(np.float32)
    inp["conv_local_h"] = r.standard_normal(33).astype(np.float32)
    inp["conv_cplx_x"] = _cplx(r, 4096)
    inp["conv_cplx_h"] = r.standard_normal(49).astype(np.float32)
    inp["conv_chan_x"] = r.standard_normal((3, 2048)).astype(np.float32)
    inp["conv_chan_h"] = r.standard_normal(21).astype(np.float32)
    inp["conv_f64_x"] = r.standard_normal((2, 4096))
    inp["conv_f64_h"] = r.standard_normal(40)
    inp["dp_x"] = r.standard_normal((16, 1024)).astype(np.float32)
    for shape in ((64, 96), (32, 32)):
        inp[f"pencil_{shape[0]}x{shape[1]}"] = _cplx(r, (2,) + shape)
    inp["pencil_rt"] = _cplx(r, (48, 64))
    inp["pencil_t"] = _cplx(r, (64, 96))
    inp["pencil_nd"] = _cplx(r, (32, 48))
    inp["pencil_f64"] = _cplx(r, (2, 32, 64), np.complex128)
    return inp


# explicit N1 for the internal-order cases: divisible by 2 and 4 shards,
# so both packages split alike at any world size
N1 = {4096: 64, 9216: 96}


def _full(y):
    return y.full_tensor().numpy()


def _error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))
    return ("no error", "")


def run_cases(world: int) -> dict:
    """Every case in this rank (the process group is up); the results
    (identical on every rank)."""

    import pffft_tpu_torch as pt
    from pffft_tpu_torch import parallel as pp
    from torch.distributed.tensor import DTensor

    inp = make_inputs()
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    mesh = pp.make_mesh(device_type="cpu")
    out = {}

    for n in (1024, 4096, 9216):
        fp = pp.FourStepPlan(n, mesh, n1=N1.get(n))
        out[f"cfft_{n}"] = _full(fp.forward(pp.shard_batch(t[f"cfft_{n}"], mesh, axis=0)))
    out["cfft_batched"] = _full(pp.FourStepPlan(1024, mesh).forward(t["cfft_batched"]))
    fp = pp.FourStepPlan(4096, mesh, n1=64)
    internal = fp.forward(t["cfft_4096"], ordered=False)
    ordered = fp.forward(t["cfft_4096"], ordered=True)
    out["internal"] = _full(internal)
    out["reorder_to_canonical"] = _full(fp.reorder(internal, to_canonical=True))
    out["reorder_to_internal"] = _full(fp.reorder(ordered, to_canonical=False))
    out["roundtrip_internal"] = _full(fp.backward(internal, ordered=False))
    out["roundtrip_complex"] = _full(fp.backward(fp.forward(
        pp.shard_batch(t["cfft_4096"], mesh, axis=0))))
    fp = pp.FourStepPlan(4096, mesh, kind=pt.REAL)
    out["roundtrip_real"] = _full(fp.backward(fp.forward(t["real_4096"])))
    fp = pp.FourStepPlan(8192, mesh, kind=pt.REAL)
    out["rfft_8192"] = _full(fp.forward(t["real_8192"]))
    out["irfft_8192"] = _full(fp.backward(fp.forward(t["real_8192"])))
    fp = pp.FourStepPlan(4096, mesh, dtype="float64", n1=64)
    out["cfft_f64"] = _full(fp.forward(t["cfft_f64"]))
    out["cfft_f64_internal"] = _full(fp.forward(t["cfft_f64"], ordered=False))
    out["icfft_f64"] = _full(fp.backward(fp.forward(t["cfft_f64"])))
    fp = pp.FourStepPlan(8192, mesh, kind=pt.REAL, dtype="float64")
    out["rfft_f64"] = _full(fp.forward(t["real_f64"]))
    out["irfft_f64"] = _full(fp.backward(fp.forward(t["real_f64"])))

    for flen in (17, 64, 333):
        setup = pt.conv.FastConv(inp[f"conv_h_{flen}"], device="cpu")
        out[f"conv_{flen}"] = _full(pp.sharded_fastconv_valid(
            setup, pp.shard_batch(t[f"conv_x_{flen}"], mesh, axis=0), mesh))
    setup = pt.conv.FastConv(inp["conv_local_h"], device="cpu")
    out["conv_sharded"] = _full(pp.sharded_fastconv_valid(setup, t["conv_local_x"], mesh))
    out["conv_local"] = setup.apply_batched(t["conv_local_x"][None, :])[0].numpy()
    setup = pt.conv.FastConv(inp["conv_cplx_h"], flags=pt.ConvFlags.CPLX_INP_OUT, device="cpu")
    out["conv_complex"] = _full(pp.sharded_fastconv_valid(setup, t["conv_cplx_x"], mesh))
    setup = pt.conv.FastConv(inp["conv_chan_h"], device="cpu")
    out["conv_channels"] = _full(pp.sharded_fastconv_valid(
        setup, pp.shard_batch(t["conv_chan_x"], mesh, axis=1), mesh))
    setup = pt.conv.FastConv(inp["conv_f64_h"], dtype="float64", device="cpu")
    out["conv_f64"] = _full(pp.sharded_fastconv_valid(setup, t["conv_f64_x"], mesh))

    # plain DP: the batch axis sharded, every rank transforms its rows
    plan = pt.new_setup(1024, pt.REAL)
    xd = pp.shard_batch(t["dp_x"], mesh, axis=0)
    local = pt.transform_ordered(plan, xd.to_local(), pt.FORWARD)
    out["dp"] = _full(DTensor.from_local(local, mesh, xd.placements))

    for shape in ((64, 96), (32, 32)):
        key = f"pencil_{shape[0]}x{shape[1]}"
        out[key] = _full(pp.Pencil2D(shape, mesh).forward(t[key]))
    p = pp.Pencil2D((48, 64), mesh)
    out["pencil_rt"] = _full(p.backward(p.forward(t["pencil_rt"])))
    p = pp.Pencil2D((64, 96), mesh)
    st = p.forward(t["pencil_t"], transposed=True)
    out["pencil_t_fwd"] = _full(st)
    out["pencil_t_rt"] = _full(p.backward(st, transposed=True))
    out["pencil_nd"] = _full(pp.Pencil2D((32, 48), mesh).forward(t["pencil_nd"]))
    p = pp.Pencil2D((32, 64), mesh, dtype="float64")
    out["pencil_f64"] = _full(p.forward(t["pencil_f64"]))
    out["pencil_f64_t_rt"] = _full(p.backward(p.forward(t["pencil_f64"], transposed=True),
                                              transposed=True))

    if world == 4:  # a 2-D mesh: the batch over "data", the transform over "seq"
        from torch.distributed.tensor import Shard, distribute_tensor

        mesh2 = pp.make_mesh(axis_names=("data", "seq"), shape=(2, 2), device_type="cpu")
        fp = pp.FourStepPlan(4096, mesh2, axis_name="seq", n1=64)
        xd = distribute_tensor(t["cfft_f64"].to(torch.complex64), mesh2, [Shard(0), Shard(1)])
        y = fp.forward(xd)
        out["mesh2d_fourstep"] = _full(y)
        out["mesh2d_fourstep_rt"] = _full(fp.backward(y))
        setup = pt.conv.FastConv(inp["conv_f64_h"].astype(np.float32), device="cpu")
        out["mesh2d_conv"] = _full(pp.sharded_fastconv_valid(
            setup, distribute_tensor(t["conv_f64_x"].float(), mesh2, [Shard(0), Shard(1)]),
            mesh2, axis_name="seq"))

    out["err_pencil_divisible"] = _error(lambda: pp.Pencil2D((2 * world + 1, 64), mesh))
    out["err_pencil_trailing"] = _error(
        lambda: pp.Pencil2D((32, 32), mesh).forward(torch.zeros((16, 32), dtype=torch.complex64)))
    h = inp["conv_h_17"]
    out["err_conv_cplx_filter"] = _error(lambda: pp.sharded_fastconv_valid(
        pt.conv.FastConv(h, flags=pt.ConvFlags.CPLX_FILTER, device="cpu"), t["conv_x_17"], mesh))
    out["err_conv_single_fft"] = _error(lambda: pp.sharded_fastconv_valid(
        pt.conv.FastConv(h, flags=pt.ConvFlags.CPLX_INP_OUT | pt.ConvFlags.CPLX_SINGLE_FFT,
                         device="cpu"), t["conv_cplx_x"], mesh))
    out["err_conv_divide"] = _error(lambda: pp.sharded_fastconv_valid(
        pt.conv.FastConv(h, device="cpu"), torch.zeros(8 * 1024 + 1), mesh))
    out["err_conv_halo"] = _error(lambda: pp.sharded_fastconv_valid(
        pt.conv.FastConv(np.ones(8 * 1024 // world + 2, np.float32), device="cpu"),
        t["conv_x_17"], mesh))
    out["err_fourstep_n1"] = _error(lambda: pp.FourStepPlan(4096, mesh, n1=96))
    out["err_device"] = _error(lambda: pp.FourStepPlan(1024, mesh).forward(
        torch.zeros(1024, dtype=torch.complex64, device="meta")))
    return out


def _rank_main(rank: int, world: int, init_file: str, results) -> None:
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


def hang_main(rank: int, world: int, init_file: str, results) -> None:
    """A rank whose process group never forms: it waits for a rank that
    does not exist (the deadline's test)."""

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world + 1,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


def run_world(world: int, target=_rank_main, deadline_s: float = WORLD_DEADLINE_S) -> dict:
    """Spawn ``world`` gloo ranks running ``target``, run every case and
    return rank 0's results.  Raises RuntimeError with the first rank's
    traceback if a rank fails, and after terminating every rank if the
    world has not finished within ``deadline_s``."""

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "pg")
        procs = [ctx.Process(target=target, args=(r, world, init_file, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + deadline_s
        got, failure = None, None
        try:
            for _ in range(world):
                left = deadline - time.monotonic()
                try:
                    status, rank, payload = results.get(timeout=max(left, 0.1))
                except queue.Empty:
                    failure = f"world of {world} ranks not done within {deadline_s} s"
                    break
                if status == "error":
                    failure = f"rank {rank} of {world} failed:\n{payload}"
                    break
                if rank == 0:
                    got = payload
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 0.1))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
        if failure is None and any(p.exitcode != 0 for p in procs):
            failure = f"rank exit codes {[p.exitcode for p in procs]}"
    if failure is not None:
        raise RuntimeError(failure)
    return got
