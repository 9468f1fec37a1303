"""The port's distribution layer (``pffft_tpu_torch.parallel``) against
``pffft_tpu.parallel``.

The JAX side runs on a 4-device mesh of the conftest's virtual CPU
devices; the port runs in gloo worlds of 1, 2 and 4 ranks, each spawned
once per module (``torch_parallel_worker.run_world``: every case in every
rank, rank 0's gathered results back as numpy).  The spawned ranks import
only torch and the port.  Every world has a hard deadline: the process
group's timeout is 60 s and the whole world 120 s, after which its ranks
are terminated and the test fails; a hung collective never waits for the
suite's clock.  Tolerance: 1e-5 of max|ref| in float32, 1e-12 in float64;
internal-order cases pass the same explicit N1 to both packages.
"""

import datetime
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import pffft_tpu as pf
import pffft_tpu_torch as pt
from pffft_tpu import parallel as pfp
from pffft_tpu_torch import parallel as pp

import torch_parallel_worker as W

WORLDS = (1, 2, 4)
F32_TOL, F64_TOL = 1e-5, 1e-12


@pytest.fixture(scope="module")
def port():
    """{world: the port's results}, each world spawned once."""

    return {world: W.run_world(world) for world in WORLDS}


def _err(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))
    return ("no error", "")


@pytest.fixture(scope="module")
def ref(eight_devices):
    """The JAX package's results on the same inputs, on 4 devices."""

    mesh = pfp.make_mesh(4)
    inp = W.make_inputs()
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    out = {}
    for n in (1024, 4096, 9216):
        fp = pfp.FourStepPlan(n, mesh, n1=W.N1.get(n))
        out[f"cfft_{n}"] = fp.forward(pfp.shard_batch(j[f"cfft_{n}"], mesh, axis=0))
    out["cfft_batched"] = pfp.FourStepPlan(1024, mesh).forward(j["cfft_batched"])
    fp = pfp.FourStepPlan(4096, mesh, n1=64)
    internal = fp.forward(j["cfft_4096"], ordered=False)
    ordered = fp.forward(j["cfft_4096"], ordered=True)
    out["internal"] = internal
    out["reorder_to_canonical"] = fp.reorder(internal, to_canonical=True)
    out["reorder_to_internal"] = fp.reorder(ordered, to_canonical=False)
    out["roundtrip_internal"] = fp.backward(internal, ordered=False)
    out["roundtrip_complex"] = fp.backward(fp.forward(
        pfp.shard_batch(j["cfft_4096"], mesh, axis=0)))
    fp = pfp.FourStepPlan(4096, mesh, kind=pf.REAL)
    out["roundtrip_real"] = fp.backward(fp.forward(j["real_4096"]))
    fp = pfp.FourStepPlan(8192, mesh, kind=pf.REAL)
    out["rfft_8192"] = fp.forward(j["real_8192"])
    out["irfft_8192"] = fp.backward(fp.forward(j["real_8192"]))
    fp = pfp.FourStepPlan(4096, mesh, dtype="float64", n1=64)
    out["cfft_f64"] = fp.forward(j["cfft_f64"])
    out["cfft_f64_internal"] = fp.forward(j["cfft_f64"], ordered=False)
    out["icfft_f64"] = fp.backward(fp.forward(j["cfft_f64"]))
    fp = pfp.FourStepPlan(8192, mesh, kind=pf.REAL, dtype="float64")
    out["rfft_f64"] = fp.forward(j["real_f64"])
    out["irfft_f64"] = fp.backward(fp.forward(j["real_f64"]))

    for flen in (17, 64, 333):
        setup = pf.conv.FastConv(inp[f"conv_h_{flen}"])
        out[f"conv_{flen}"] = pfp.sharded_fastconv_valid(
            setup, pfp.shard_batch(j[f"conv_x_{flen}"], mesh, axis=0), mesh)
    setup = pf.conv.FastConv(inp["conv_local_h"])
    out["conv_sharded"] = pfp.sharded_fastconv_valid(setup, j["conv_local_x"], mesh)
    out["conv_local"] = setup.apply_batched(j["conv_local_x"][None, :])[0]
    setup = pf.conv.FastConv(inp["conv_cplx_h"], flags=pf.conv.ConvFlags.CPLX_INP_OUT)
    out["conv_complex"] = pfp.sharded_fastconv_valid(setup, j["conv_cplx_x"], mesh)
    setup = pf.conv.FastConv(inp["conv_chan_h"])
    out["conv_channels"] = pfp.sharded_fastconv_valid(
        setup, pfp.shard_batch(j["conv_chan_x"], mesh, axis=1), mesh)
    setup = pf.conv.FastConv(inp["conv_f64_h"], dtype="float64")
    out["conv_f64"] = pfp.sharded_fastconv_valid(setup, j["conv_f64_x"], mesh)

    plan = pf.new_setup(1024, pf.REAL)
    out["dp"] = pf.transform_ordered(plan, pfp.shard_batch(j["dp_x"], mesh, axis=0),
                                     pf.FORWARD)

    for shape in ((64, 96), (32, 32)):
        key = f"pencil_{shape[0]}x{shape[1]}"
        out[key] = pfp.Pencil2D(shape, mesh).forward(j[key])
    p = pfp.Pencil2D((48, 64), mesh)
    out["pencil_rt"] = p.backward(p.forward(j["pencil_rt"]))
    p = pfp.Pencil2D((64, 96), mesh)
    st = p.forward(j["pencil_t"], transposed=True)
    out["pencil_t_fwd"] = st
    out["pencil_t_rt"] = p.backward(st, transposed=True)
    out["pencil_nd"] = pfp.Pencil2D((32, 48), mesh).forward(j["pencil_nd"])
    p = pfp.Pencil2D((32, 64), mesh, dtype="float64")
    out["pencil_f64"] = p.forward(j["pencil_f64"])
    out["pencil_f64_t_rt"] = p.backward(p.forward(j["pencil_f64"], transposed=True),
                                        transposed=True)
    mesh2 = pfp.make_mesh(4, axis_names=("data", "seq"), shape=(2, 2))
    fp = pfp.FourStepPlan(4096, mesh2, axis_name="seq", n1=64)
    x2 = jax.device_put(j["cfft_f64"].astype(jnp.complex64),
                        jax.sharding.NamedSharding(mesh2, jax.sharding.PartitionSpec("data", "seq")))
    out["mesh2d_fourstep"] = fp.forward(x2)
    out["mesh2d_fourstep_rt"] = fp.backward(fp.forward(x2))
    setup = pf.conv.FastConv(inp["conv_f64_h"].astype(np.float32))
    out["mesh2d_conv"] = pfp.sharded_fastconv_valid(
        setup, j["conv_f64_x"].astype(jnp.float32), mesh2, axis_name="seq")
    out = {k: np.asarray(v) for k, v in out.items()}

    h = inp["conv_h_17"]
    out["err_pencil_divisible"] = _err(lambda: pfp.Pencil2D((9, 64), mesh))
    out["err_pencil_trailing"] = _err(
        lambda: pfp.Pencil2D((32, 32), mesh).forward(jnp.zeros((16, 32), jnp.complex64)))
    out["err_conv_cplx_filter"] = _err(lambda: pfp.sharded_fastconv_valid(
        pf.conv.FastConv(h, flags=pf.conv.ConvFlags.CPLX_FILTER), j["conv_x_17"], mesh))
    out["err_conv_single_fft"] = _err(lambda: pfp.sharded_fastconv_valid(
        pf.conv.FastConv(h, flags=pf.conv.ConvFlags.CPLX_INP_OUT
                         | pf.conv.ConvFlags.CPLX_SINGLE_FFT), j["conv_cplx_x"], mesh))
    out["err_conv_divide"] = _err(lambda: pfp.sharded_fastconv_valid(
        pf.conv.FastConv(h), jnp.zeros(8 * 1024 + 1), mesh))
    out["err_conv_halo"] = _err(lambda: pfp.sharded_fastconv_valid(
        pf.conv.FastConv(np.ones(8 * 1024 // 4 + 2, np.float32)), j["conv_x_17"], mesh))
    out["err_fourstep_n1"] = _err(lambda: pfp.FourStepPlan(4096, mesh, n1=96))
    return out


F64_CASES = {"cfft_f64", "cfft_f64_internal", "icfft_f64", "rfft_f64", "irfft_f64",
             "conv_f64", "pencil_f64", "pencil_f64_t_rt"}
VALUE_CASES = (
    "cfft_1024", "cfft_4096", "cfft_9216", "cfft_batched", "internal",
    "reorder_to_canonical", "reorder_to_internal", "roundtrip_internal",
    "roundtrip_complex", "roundtrip_real", "rfft_8192", "irfft_8192",
    "conv_17", "conv_64", "conv_333", "conv_sharded", "conv_local", "conv_complex",
    "conv_channels", "dp", "pencil_64x96", "pencil_32x32", "pencil_rt", "pencil_t_fwd",
    "pencil_t_rt", "pencil_nd", *sorted(F64_CASES),
)
# (expected error type, a fragment of its message)
ERROR_CASES = {
    "err_pencil_divisible": ("ValueError", "divisible"),
    "err_pencil_trailing": ("ValueError", "trailing axes"),
    "err_conv_cplx_filter": ("NotImplementedError", "real-filter modes"),
    "err_conv_single_fft": ("NotImplementedError", "real-filter modes"),
    "err_conv_divide": ("ValueError", "must divide over"),
    "err_conv_halo": ("ValueError", "shorter than the filter halo"),
    "err_fourstep_n1": ("ValueError", "does not divide"),
    "err_device": ("ValueError", "meta tensor given to a cpu mesh"),
}
# every length divides over one shard
NEEDS_SHARDS = {"err_pencil_divisible", "err_conv_divide"}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", VALUE_CASES)
def test_port_matches_reference(port, ref, world, case):
    got, want = port[world][case], ref[case]
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    tol = F64_TOL if case in F64_CASES else F32_TOL
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), case


@pytest.mark.parametrize("case", ["mesh2d_fourstep", "mesh2d_fourstep_rt", "mesh2d_conv"])
def test_two_axis_mesh_matches_reference(port, ref, case):
    """A (2, 2) mesh of 4 ranks: the batch over "data", the transform or
    the stream over "seq"."""

    got, want = port[4][case], ref[case]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max(), case


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fastconv_equals_local_pipeline(port, world):
    got, local = port[world]["conv_sharded"], port[world]["conv_local"]
    np.testing.assert_allclose(got, local, rtol=0, atol=F32_TOL * np.abs(local).max())


@pytest.mark.parametrize("case, world", [(c, w) for c in sorted(ERROR_CASES) for w in WORLDS
                                         if w > 1 or c not in NEEDS_SHARDS])
def test_errors(port, ref, world, case):
    kind, fragment = ERROR_CASES[case]
    got_kind, msg = port[world][case]
    assert got_kind == kind and fragment in msg, (got_kind, msg)
    if case in ref:
        assert ref[case][0] == kind, ref[case]


def test_a_world_that_hangs_is_terminated_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="not done within"):
        W.run_world(2, target=W.hang_main, deadline_s=3)
    assert time.monotonic() - t0 < W.PG_TIMEOUT_S


@pytest.fixture
def cpu_world_of_one(tmp_path):
    """A gloo world of one rank in this process, destroyed after the test."""

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=W.PG_TIMEOUT_S))
    try:
        yield pp.make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_local_phases_get_contiguous_planes(cpu_world_of_one, monkeypatch):
    """The kernels take contiguous planes only (their plain versions on the
    CPU take any layout): every plane the layer hands the dispatcher is
    contiguous, whatever the layout of the input."""

    from pffft_tpu_torch.ops import dispatch as D

    mesh, real_dispatch, seen = cpu_world_of_one, D.cfft_dispatch, []

    def checked(plan, re, im, **kw):
        seen.append(re.is_contiguous() and im.is_contiguous())
        return real_dispatch(plan, re, im, **kw)

    monkeypatch.setattr(D, "cfft_dispatch", checked)
    inp = W.make_inputs()
    z = torch.from_numpy(inp["cfft_batched"])
    fp = pp.FourStepPlan(1024, mesh)
    for ordered in (True, False):
        s = fp.forward(z, ordered=ordered)
        fp.backward(s, ordered=ordered)
        fp.backward(z, ordered=ordered)  # strided planes of a complex input
    fr = pp.FourStepPlan(8192, mesh, kind=pt.REAL)
    fr.backward(fr.forward(torch.from_numpy(inp["real_8192"])))
    p = pp.Pencil2D((64, 96), mesh)
    for transposed in (False, True):
        p.backward(p.forward(torch.from_numpy(inp["pencil_t"]), transposed=transposed),
                   transposed=transposed)
    assert len(seen) == 24 and all(seen)


def test_make_mesh_without_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        pp.make_mesh(device_type="cpu")


def test_split_and_twiddle_equal_reference():
    from pffft_tpu.parallel import fourstep as rfs
    from pffft_tpu_torch.parallel import fourstep as tfs

    for n in (1024, 4096, 9216, 1 << 20, 3 * 5 * 1024):
        for d in (1, 2, 4, 8):
            try:
                want = rfs._split_n(n, None, d)
            except ValueError:
                with pytest.raises(ValueError):
                    tfs._split_n(n, None, d)
                continue
            assert tfs._split_n(n, None, d) == want
    for n1, n2 in ((32, 32), (64, 144), (4096, 16)):
        for cd in (np.complex64, np.complex128):
            np.testing.assert_array_equal(tfs._twiddle_np(n1, n2, cd), rfs._twiddle_np(n1, n2, cd))


def test_package_exports_parallel_and_tune():
    assert set(pf.__all__) <= set(pt.__all__)
    assert pt.parallel is pp and callable(pt.tuned_setup)
    assert set(pfp.__all__) == set(pp.__all__)
