"""The port's batch-major real steps against pffft_tpu's.

* the plain version of the batch-major split kernel (B6,
  ``ops/real_kernel.real_split_plain``) against the Pallas kernel it
  replaces, ``real_split_pallas``, in interpret mode off the TPU, as
  ``tests/test_real_kernel.py`` runs it;
* the flat split forms against the classic even/odd ones, and each
  batch-major real step of ``ops/split.py`` against its JAX counterpart;
* the complex-dtype steps of ``ops/real.py``;
* the batch-major real route of the dispatcher.

The CUDA kernel is held against its plain version in
``test_torch_cuda.py``.  All inputs are seeded numpy arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu.ops import real as rreal
from pffft_tpu.ops import real_kernel as rrk
from pffft_tpu.ops import split as rsplit
import pffft_tpu_torch as pt
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import real as treal
from pffft_tpu_torch.ops import real_kernel as rk
from pffft_tpu_torch.ops import split as tsplit

# One intra-op thread: the suite runs in several worker processes that share
# the cores, and an oversubscribed OpenMP pool slows each torch call by
# tens of times.
torch.set_num_threads(1)

# plain B6 vs the interpret-mode Pallas kernel: absolute, 2e-6 * max(1,
# scale), the reference test's own bound (flat FMA form here, the even/odd
# form there)
KERNEL_TOL = 2e-6
# the flat forms against the classic ones: the reference test's bound
FLAT_TOL = 2e-5
# the same elementwise f32 expressions on both sides
STEP_TOL = 2e-6
CPU = "cpu"


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _tw(plan):
    return tsplit.real_split_twiddle(plan, torch.device(CPU))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _err(got, ref):
    return max(float(np.abs(np.asarray(g) - np.asarray(r)).max())
               for g, r in zip(got, ref, strict=True))


@pytest.mark.parametrize("n,b", [(1 << 15, 4), (1 << 16, 6), (3 * (1 << 14), 2)])
@pytest.mark.parametrize("backward", [False, True])
def test_plain_split_kernel_matches_pallas_interpret(n, b, backward):
    rplan, plan = pf.new_setup(n, pf.REAL), pt.new_setup(n, pt.REAL)
    zr, zi = _planes((b, n // 2), n)
    ref = rrk.real_split_pallas(jnp.asarray(zr), jnp.asarray(zi), rplan.real_twiddle,
                                backward=backward)
    got = rk.real_split_plain(*_t(zr, zi), _tw(plan), backward=backward)
    scale = float(np.abs(np.asarray(ref[0])).max())
    assert _err([g.numpy() for g in got], ref) <= KERNEL_TOL * max(1.0, scale)
    # the wrapper takes the plain version for CPU tensors
    wrapped = rk.real_split(*_t(zr, zi), _tw(plan), backward=backward)
    assert _err([w.numpy() for w in wrapped], [g.numpy() for g in got]) == 0.0


@pytest.mark.parametrize("n", [32, 1 << 12])
def test_flat_split_forms_match_classic(n):
    plan = pt.new_setup(n, pt.REAL)
    zr, zi = _t(*_planes((3, n // 2), n))
    for cls, flat in ((tsplit.real_forward_split_planar, tsplit.real_forward_split_planar_flat),
                      (tsplit.real_backward_split_planar,
                       tsplit.real_backward_split_planar_flat)):
        r1, i1 = cls(zr, zi, _tw(plan))
        r2, i2 = flat(zr, zi, _tw(plan))
        e = max(float((r1 - r2).abs().max()), float((i1 - i2).abs().max()))
        assert e < FLAT_TOL * max(1.0, float(r1.abs().max()))


@pytest.mark.parametrize("n", [32, 192, 1920, 8192])
def test_real_steps_match_reference(n):
    rplan, plan = pf.new_setup(n, pf.REAL), pt.new_setup(n, pt.REAL)
    h = n // 2
    zr, zi = _planes((2, 3, h), n)
    tw = rplan.real_twiddle
    for tfn, rfn in ((tsplit.real_forward_split_planar, rsplit.real_forward_split_planar),
                     (tsplit.real_backward_split_planar, rsplit.real_backward_split_planar),
                     (tsplit.real_forward_split_planar_flat,
                      rsplit.real_forward_split_planar_flat),
                     (tsplit.real_backward_split_planar_flat,
                      rsplit.real_backward_split_planar_flat)):
        got = tfn(*_t(zr, zi), _tw(plan))
        ref = rfn(jnp.asarray(zr), jnp.asarray(zi), tw)
        scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
        assert _err([g.numpy() for g in got], ref) <= STEP_TOL * scale, tfn.__name__
    fr, fi = tsplit._reverse_conj_split(*_t(zr, zi))
    rr, ri = rsplit._reverse_conj_split(jnp.asarray(zr), jnp.asarray(zi))
    assert _err([fr.numpy(), fi.numpy()], [rr, ri]) == 0.0
    # the pack and the interleave are data movement: exact
    x = np.random.default_rng(n).standard_normal((2, 3, n)).astype(np.float32)
    pr, pi = tsplit.pack_real_input_split(torch.from_numpy(x))
    assert pr.is_contiguous() and pi.is_contiguous()
    assert _err([pr.numpy(), pi.numpy()], rsplit.pack_real_input_split(jnp.asarray(x))) == 0.0
    inter = tsplit.interleave_to_real_split(*_t(zr, zi))
    np.testing.assert_array_equal(
        inter.numpy(), np.asarray(rsplit.interleave_to_real_split(jnp.asarray(zr),
                                                                  jnp.asarray(zi))))
    v = tsplit._set_bin0(torch.from_numpy(zr), torch.from_numpy(zi[..., 0]))
    np.testing.assert_array_equal(
        v.numpy(), np.asarray(rsplit._set_bin0(jnp.asarray(zr), jnp.asarray(zi[..., 0]))))


@pytest.mark.parametrize("n", [32, 1920])
def test_complex_dtype_steps_match_reference(n):
    rplan = pf.new_setup(n, pf.REAL)
    h = n // 2
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    zr, zi = _planes((3, h), n + 1)
    z = (zr + 1j * zi).astype(np.complex64)
    tw = rplan.real_twiddle
    np.testing.assert_array_equal(
        treal.pack_real_input(torch.from_numpy(x)).numpy(),
        np.asarray(rreal.pack_real_input(jnp.asarray(x), np.complex64)))
    for tfn, rfn in ((treal.real_forward_split, rreal.real_forward_split),
                     (treal.real_backward_split, rreal.real_backward_split)):
        got = tfn(torch.from_numpy(z), tw).numpy()
        ref = np.asarray(rfn(jnp.asarray(z), tw))
        assert got.dtype == np.complex64
        assert np.abs(got - ref).max() <= STEP_TOL * np.abs(ref).max(), tfn.__name__
    np.testing.assert_array_equal(
        treal.interleave_to_real(torch.from_numpy(z)).numpy(),
        np.asarray(rreal.interleave_to_real(jnp.asarray(z), np.float32)))


def test_bmajor_real_split_route():
    plan = pt.new_setup(64, pt.REAL)
    zr, zi = _t(*_planes((2, 3, 32), 1))
    for backward in (False, True):
        got = D.real_split_bmajor_route(plan, backward)(zr, zi)
        want = rk.real_split_plain(zr.reshape(6, 32), zi.reshape(6, 32), _tw(plan),
                                   backward=backward)
        assert got[0].shape == (2, 3, 32)
        assert torch.equal(got[0].reshape(6, 32), want[0])
        assert torch.equal(got[1].reshape(6, 32), want[1])
    assert D.real_split_bmajor_route(pt.new_setup(64, pt.REAL, dtype="float64"), False) is None
    assert D.real_split_bmajor_route(pt.new_setup(64), False) is None


def test_split_kernel_wrapper_checks_its_twiddles():
    plan = pt.new_setup(64, pt.REAL)
    zr, zi = _t(*_planes((2, 32), 1))
    with pytest.raises(ValueError, match="split twiddles"):
        rk.real_split(zr, zi, _tw(pt.new_setup(128, pt.REAL)))
    with pytest.raises(ValueError, match="planes must be"):
        rk.real_split(zr, zi[:1], _tw(plan))
