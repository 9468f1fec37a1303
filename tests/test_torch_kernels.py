"""The port's chain and copy kernels: plain versions against the Pallas
kernels they replace, and the wrappers' contracts on the CPU.  The CUDA
kernels themselves are held against these plain versions in
``test_torch_cuda.py``.

The Pallas kernels run as the reference's own tests run them on the CPU,
``interpret=True``.  Both sides get the same numpy inputs and the same plan
tables (the port's plan is built from the reference's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pffft_tpu import plan as rp
from pffft_tpu.ops import pallas_fft as rpk
from pffft_tpu_torch import plan as tp
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import pallas_fft as pk

# One intra-op thread: the suite runs in several worker processes that share
# the cores, and an oversubscribed OpenMP pool slows each torch call by
# tens of times.
torch.set_num_threads(1)

# plain chain vs the interpret-mode Pallas chain, relative to max|ref|: the
# same butterflies and twiddles in f32; XLA may fuse or reorder a few sums
TOL = 2e-6


def _thin_plans(n):
    ref = rp.new_setup(n, rp.COMPLEX, factors=rpk.thin_factors(n, radix16=True),
                       strict=False)
    d: dict = {}
    rp._plan_to_arrays(ref, "p_", d)
    return ref, tp.plan_from_reference(d)


def _planes(n, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, b)).astype(np.float32),
            rng.standard_normal((n, b)).astype(np.float32))


@pytest.mark.parametrize("n", [64, 96, 160, 240, 1024, 1920])
@pytest.mark.parametrize("b", [128, 100])
def test_plain_chain_matches_pallas_interpret(n, b):
    ref_plan, port_plan = _thin_plans(n)
    assert port_plan.factors == ref_plan.factors
    assert pk.supported(port_plan) and rpk.supported(ref_plan)
    re, im = _planes(n, b, n + b)
    for backward in (False, True):
        er, ei = rpk.cfft_pallas_tmajor(ref_plan, jnp.asarray(re), jnp.asarray(im),
                                        backward=backward, tb=128, interpret=True)
        er, ei = np.asarray(er), np.asarray(ei)
        gr, gi = pk.chain_tmajor_plain(port_plan, torch.from_numpy(re),
                                       torch.from_numpy(im), backward=backward)
        scale = max(np.abs(er).max(), np.abs(ei).max())
        assert np.abs(gr.numpy() - er).max() <= TOL * scale, backward
        assert np.abs(gi.numpy() - ei).max() <= TOL * scale, backward


def test_thin_factors_and_support_match_reference():
    for n in range(2, 5000):
        assert pk.thin_factors(n) == rpk.thin_factors(n), n
        assert pk.thin_factors(n, radix16=False) == rpk.thin_factors(n, radix16=False), n
    for n in (16, 96, 2400, 4096):
        ref = rp.new_setup(n, rp.COMPLEX, max_factor=5)
        assert pk.supported(tp.new_setup(n)) == rpk.supported(ref)
    assert not pk.supported(tp.new_setup(1024, factors=(64, 16)))


def test_butterflies_are_dfts():
    """Every radix the kernels use, both signs, against the DFT matrix."""

    rng = np.random.default_rng(5)
    for r in pk.COMBINE_RADICES:
        x = rng.standard_normal((r, 3)) + 1j * rng.standard_normal((r, 3))
        slabs = [(torch.from_numpy(x[i].real), torch.from_numpy(x[i].imag))
                 for i in range(r)]
        for sign in (-1.0, 1.0):
            y = pk._butterfly(r, slabs, sign)
            got = np.stack([a.numpy() + 1j * b.numpy() for a, b in y])
            w = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
            np.testing.assert_allclose(got, w @ x, atol=1e-12)


def test_butterfly_constants_match_reference():
    for name in ("_SQRT3_2", "_C51", "_S51", "_C52", "_S52"):
        assert getattr(pk, name) == getattr(rpk, name), name


def test_chain_wrapper_on_cpu_runs_the_plain_version():
    plan = D._thin_plan(96)
    re, im = (torch.from_numpy(a) for a in _planes(96, 12, 1))
    keep = re.clone(), im.clone()
    before = pk.cfft_chain_tmajor.launches
    gr, gi = pk.cfft_chain_tmajor(plan, re, im, backward=True)
    pr, pi = pk.chain_tmajor_plain(plan, re, im, backward=True)
    assert torch.equal(gr, pr) and torch.equal(gi, pi)
    assert pk.cfft_chain_tmajor.launches == before  # nothing was launched
    assert torch.equal(re, keep[0]) and torch.equal(im, keep[1])
    with pytest.raises(ValueError, match="engine length"):
        pk.cfft_chain_tmajor(D._thin_plan(64), re, im)
    with pytest.raises(ValueError, match="does not run"):
        pk.cfft_chain_tmajor(tp.new_setup(1024, factors=(64, 16)), re, im)
    with pytest.raises(ValueError, match="two equal"):
        pk.cfft_chain_tmajor(plan, re, im[:, :5])


def test_stream_copy_on_cpu():
    re, im = (torch.from_numpy(a) for a in _planes(32, 8, 2))
    before = pk.stream_copy.launches
    cr, ci = pk.stream_copy(re, im)
    assert torch.equal(cr, re) and torch.equal(ci, im)
    assert cr.data_ptr() != re.data_ptr() and ci.data_ptr() != im.data_ptr()
    assert pk.stream_copy.launches == before


def test_chain_coverage_from_sm90_shared_memory():
    """On the CPU the coverage is planned with the H100's 227 KB of shared
    memory per block, so the tests walk the card's routes."""

    assert pk.smem_per_block() == 232448
    assert pk.chain_max_n() == 2048
    assert pk.chain_tile(2048, (16, 16, 8)) == 8
    assert pk.chain_tile(1024, (16, 16, 4)) == 16
    assert pk.chain_tile(64, (16, 4)) == 32
    assert pk.chain_tile(4096, (16, 16, 16)) is None
    # radix 3 and 5 hold 30 of a thread's 32 values: 2400 * 8 > 512 * 30
    assert pk.chain_tile(1920, (16, 8, 5, 3)) == 8
    assert pk.chain_tile(2400, (16, 2, 5, 5, 3)) is None
