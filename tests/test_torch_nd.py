"""The port's N-D transforms, pffft_tpu_torch.nd, against pffft_tpu.nd on
the same seeded numpy inputs: smooth axes (the batch-major engines),
non-smooth and prime axes (the chirp-Z path), mixed, batched, both
dtypes, the real forms and the errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
import pffft_tpu_torch as pt

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-5       # f32, relative to max|ref|
TOL64 = 1e-12    # f64, the reference's own tolerance (tests/test_nd.py)


def _rand_c(shape, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("shape", [(32, 64), (17, 30), (64, 101)])
def test_fft2_and_ifft2_match_reference(shape):
    x = _rand_c(shape, sum(shape))
    got = pt.fft2(x, device=CPU)
    assert got.dtype == torch.complex64 and got.is_contiguous()
    assert _rel(got, pf.fft2(x)) <= TOL
    assert _rel(pt.ifft2(x, device=CPU), pf.ifft2(x)) <= TOL
    assert _rel(got, np.fft.fft2(x.astype(np.complex128))) <= TOL


def test_fftn_3d_batched_mixed_axes():
    x = _rand_c((2, 9, 17, 30), 7)
    got = pt.fftn(x, (9, 17, 30), device=CPU)
    assert got.shape == (2, 9, 17, 30)
    assert _rel(got, pf.fftn(x, (9, 17, 30))) <= TOL
    assert _rel(pt.ifftn(x, (9, 17, 30), device=CPU), pf.ifftn(x, (9, 17, 30))) <= TOL


def test_fftn_f64():
    x = _rand_c((13, 21), 13, np.complex128)
    got = pt.fftn(x, dtype="float64", device=CPU)
    assert got.dtype == torch.complex128
    assert _rel(got, pf.fftn(x, dtype="float64")) <= TOL64
    assert _rel(got, np.fft.fftn(x)) <= TOL64


def test_roundtrip_unscaled():
    x = torch.from_numpy(_rand_c((24, 50), 24))
    back = pt.ifft2(pt.fft2(x)) / x.numel()
    assert (back - x).abs().max() < 3e-6 * max(1.0, float(x.abs().max()))


def test_fftn_split_planar():
    nd, rnd = pt.fftn_setup((16, 48)), pf.fftn_setup((16, 48))
    x = _rand_c((3, 16, 48), 3)
    for direction, rdir in ((pt.FORWARD, pf.FORWARD), (pt.BACKWARD, pf.BACKWARD)):
        want = pf.fftn_split(rnd, (jnp.asarray(x.real), jnp.asarray(x.imag)), rdir)
        gr, gi = pt.fftn_split(nd, (x.real, x.imag), direction, device=CPU)
        assert gr.dtype == torch.float32 and gr.is_contiguous() and gi.is_contiguous()
        scale = np.abs(np.asarray(want[0]) + 1j * np.asarray(want[1])).max()
        for g, w in zip((gr, gi), want):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= TOL * scale
    assert nd.size == rnd.size == 16 * 48


@pytest.mark.parametrize("shape", [(12, 25), (8, 9, 10), (6, 4096)])
def test_rfftn_matches_reference(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got = pt.rfftn(x, device=CPU)
    want = np.asarray(pf.rfftn(x))
    assert tuple(got.shape) == want.shape and got.dtype == torch.complex64
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("shape", [(12, 25), (6, 15, 8)])
def test_irfftn_matches_reference(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    s = np.fft.rfftn(x).astype(np.complex64)
    got = pt.irfftn(s, shape, device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _rel(got, pf.irfftn(jnp.asarray(s), shape)) <= TOL
    y = pt.irfftn(pt.rfftn(x, device=CPU), shape) / int(np.prod(shape))
    assert (y - torch.from_numpy(x)).abs().max() < 5e-6


def test_rfftn_one_axis_is_rfft_any():
    x = np.random.default_rng(1).standard_normal(97).astype(np.float32)
    assert _rel(pt.rfftn(x, device=CPU), pf.rfftn(x)) <= TOL


def test_plan_sharing_equal_extents():
    nd = pt.fftn_setup((48, 48))
    assert nd.plans[0] is nd.plans[1]
    mixed = pt.fftn_setup((17, 30))
    assert isinstance(mixed.plans[0], pt.BluesteinPlan) and isinstance(mixed.plans[1], pt.Plan)


def test_error_paths_match_reference():
    for shape in ((), (8, 1)):
        with pytest.raises(ValueError) as te:
            pt.fftn_setup(shape)
        with pytest.raises(ValueError) as rf:
            pf.fftn_setup(shape)
        assert str(te.value) == str(rf.value)
    z = np.zeros((8, 10), np.float32)
    with pytest.raises(ValueError, match="trailing axes") as te:
        pt.fftn_split(pt.fftn_setup((8, 12)), (z, z), device=CPU)
    with pytest.raises(ValueError) as rf:
        pf.fftn_split(pf.fftn_setup((8, 12)), (jnp.asarray(z), jnp.asarray(z)))
    assert str(te.value) == str(rf.value)
    s = np.zeros((4, 5), np.complex64)
    with pytest.raises(ValueError, match="does not") as te:
        pt.irfftn(s, (4, 12), device=CPU)
    with pytest.raises(ValueError) as rf:
        pf.irfftn(jnp.asarray(s), (4, 12))
    assert str(te.value) == str(rf.value)


def test_2d_impulse_is_flat():
    x = np.zeros((16, 20), np.complex64)
    x[3, 7] = 1.0
    g = pt.fft2(x, device=CPU)
    assert (g.abs() - 1.0).abs().max() < 1e-5
    assert _rel(g, pf.fft2(x)) <= TOL


def test_tensor_input_stays_and_is_not_modified():
    x = torch.from_numpy(_rand_c((2, 8, 12), 2))
    keep = x.clone()
    got = pt.fftn(x, (8, 12))
    assert got.device.type == "cpu" and torch.equal(x, keep)
    assert _rel(got, pf.fftn(keep.numpy(), (8, 12))) <= TOL
