"""Gradients through the port's distribution layer against ``jax.grad`` of
``pffft_tpu.parallel``.

The JAX side differentiates each case's loss on a 4-device mesh of the
conftest's virtual CPU devices; the port runs in gloo worlds of 1, 2 and 4
ranks, each spawned once per module through
``torch_parallel_worker.run_world`` with ``torch_parallel_grad_worker``'s
ranks (jax-free; the same 60 s process-group timeout and 120 s deadline
per world).  Each case's gradient is taken for a plain leaf, a non-leaf
and a DTensor leaf.  For a complex input, ``jax.grad`` gives the conjugate
of torch's gradient (d/dRe - i d/dIm against d/dRe + i d/dIm), so the
reference is conjugated.  Tolerance: 1e-5 of max|ref| in float32, 1e-12
in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pffft_tpu as pf
from pffft_tpu import parallel as pfp

import torch_parallel_grad_worker as G
import torch_parallel_worker as W

WORLDS = (1, 2, 4)
F32_TOL, F64_TOL = 1e-5, 1e-12


@pytest.fixture(scope="module")
def port():
    """{world: {case: {kind: gradient}}}, each world spawned once."""

    return {world: W.run_world(world, target=G.rank_main) for world in WORLDS}


def _ref_fns(mesh, inp):
    fs = pfp.FourStepPlan(4096, mesh, n1=64)
    fr = pfp.FourStepPlan(8192, mesh, kind=pf.REAL)
    fd = pfp.FourStepPlan(4096, mesh, dtype="float64", n1=64)
    frd = pfp.FourStepPlan(8192, mesh, kind=pf.REAL, dtype="float64")
    pen = pfp.Pencil2D((64, 96), mesh)

    def conv(case, **kw):
        setup = pf.conv.FastConv(inp[f"{case}_h"], **kw)
        return lambda x: pfp.sharded_fastconv_valid(setup, x, mesh)

    return {
        "cfft": lambda x: pfp.FourStepPlan(1024, mesh).forward(x),
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
        "conv_cplx": conv("conv_cplx", flags=pf.conv.ConvFlags.CPLX_INP_OUT),
        "conv_chan": conv("conv_chan"),
        "conv_f64": conv("conv_f64", dtype="float64"),
    }


@pytest.fixture(scope="module")
def ref(eight_devices):
    """{case: conj(jax.grad)} of every case's loss, on 4 devices."""

    mesh = pfp.make_mesh(4)
    inp = G.make_inputs()
    fns = _ref_fns(mesh, inp)
    out = {}
    for case in G.CASES:
        fn, x = fns[case], jnp.asarray(inp[case])
        y = jax.eval_shape(fn, x)
        f64 = case in G.F64_CASES
        wr, wi = G.weights(case, y.shape, jnp.iscomplexobj(y), f64)

        def loss(v, fn=fn, wr=wr, wi=wi):
            z = fn(v)
            if wi is None:
                return jnp.sum(z * wr)
            return jnp.sum(jnp.real(z) * wr) + jnp.sum(jnp.imag(z) * wi)

        out[case] = np.conj(np.asarray(jax.grad(loss)(x)))
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", G.KINDS)
@pytest.mark.parametrize("case", G.CASES)
def test_gradient_matches_jax_grad(port, ref, world, kind, case):
    got, want = port[world][case][kind], ref[case]
    assert not isinstance(got, str), f"{case}: no gradient reached the {kind} input"
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype,
                                                                 want.shape, want.dtype)
    tol = F64_TOL if case in G.F64_CASES else F32_TOL
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), case


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", sorted(G.CONV_TAPS))
def test_sharded_fastconv_gradient_at_each_shards_halo(port, ref, world, case):
    """The first F - 1 samples of every shard after the first feed the
    previous shard's outputs through the halo: their gradient comes back
    through the halo exchange's adjoint."""

    want = ref[case]
    length, halo = want.shape[-1], G.CONV_TAPS[case] - 1
    cols = np.concatenate([np.arange(s, s + halo)
                           for s in range(length // world, length, length // world)])
    tol = F64_TOL if case in G.F64_CASES else F32_TOL
    for kind in G.KINDS:
        got = port[world][case][kind]
        assert not isinstance(got, str), kind
        err = np.abs(got[..., cols] - want[..., cols]).max()
        assert err <= tol * np.abs(want).max(), (kind, err)
