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


# ---------------------------------------------------------------------------
# B1's launch shape on the register-resident core (chain_core_tile)
# ---------------------------------------------------------------------------

# every 2/3/5-smooth length up to 4800: the chain covers those up to 2048
_SMOOTH = [n for n in range(2, 4801)
           if pk.thin_factors(n) is not None and n % 2 == 0]


def test_core_tile_covers_exactly_the_chains_plans():
    covered = []
    for n in _SMOOTH:
        plan = D._thin_plan(n)
        if plan is None:
            continue
        radices = [st.r for st in plan.stages if st.r != 1]
        tile = pk.chain_core_tile(plan)
        assert (tile is not None) == (pk.chain_tile(n, radices) is not None), n
        if tile is not None:
            covered.append(n)
    assert max(covered) == 2048 and 2400 not in covered and 1920 in covered


@pytest.mark.parametrize("elems", [None, 16, 32])
def test_core_tile_shape_holds_the_tile(elems):
    for n in _SMOOTH:
        plan = D._thin_plan(n)
        tile = pk.chain_core_tile(plan, elems=elems) if plan is not None else None
        if tile is None:
            continue
        assert tile.elems == (elems or 32)
        assert tile.threads * tile.elems >= n * tile.tb          # every value has a thread
        assert tile.threads % 32 == 0 and tile.threads <= pk.CORE_MAX_THREADS
        assert tile.tb in (32, 16, 8, 4)
        assert tile.smem == (pk.core_pad(n - 1, tile.shift) + 1) * tile.tb * 8
        assert tile.smem <= 232448                                 # sm_90's opt-in shared memory
        assert tile.blocks_per_sm == pk.core_blocks_per_sm(tile.threads, tile.smem)
        assert tile.blocks_per_sm >= 1


def test_core_tile_defaults_and_sweep_shapes():
    p2048, p1024 = D._thin_plan(2048), D._thin_plan(1024)
    t = pk.chain_core_tile(p2048)
    assert (t.tb, t.threads, t.elems, t.shift, t.blocks_per_sm) == (8, 512, 32, 3, 1)
    t = pk.chain_core_tile(p1024)
    assert (t.tb, t.threads, t.elems, t.blocks_per_sm) == (16, 512, 32, 1)
    # the sweep: tb = 4 at 32 values is two 256-thread blocks per SM
    t = pk.chain_core_tile(p2048, tb=4)
    assert (t.tb, t.threads, t.blocks_per_sm) == (4, 256, 2)
    assert pk.chain_core_tile(p2048, tb=16) is None              # 1024 threads
    assert pk.chain_core_tile(p2048, tb=8, elems=16) is None     # 1024 threads
    assert pk.chain_core_tile(D._thin_plan(4096)) is None        # kern2's length


def test_core_launch_shape_of_a_refused_tile_is_planned_not_rejected():
    """An explicit tb past what a block holds is planned as asked, so that
    the kernel refuses it and the wrapper raises (no fallback)."""

    cpu = torch.device("cpu")
    t = pk._core_launch(D._thin_plan(2048), cpu, "chain kernel", 64, None)
    assert t.threads > pk.CORE_MAX_THREADS
    t = pk._core_launch(D._thin_plan(2400), cpu, "chain kernel", 4, None)
    assert (t.tb, t.threads) == (4, 320)                        # past the chain's coverage
    with pytest.raises(ValueError, match="tile limits"):
        pk._core_launch(D._thin_plan(2400), cpu, "chain kernel", None, None)


def test_coverage_answers_as_before():
    """The core plans inside the chain's coverage: the routes stay."""

    for n, b in ((1024, 16384), (2048, 8192), (4096, 4096), (65536, 256)):
        plan = tp.new_setup(n)
        want = "chain" if n <= 2048 else "kern2"
        assert D.select_engine(plan, b, True) == want
    assert D._kern2_conf(4096) == (2048, 2) and D._kern2_conf(65536) == (2048, 32)
    for nfft, route in ((128, "fused"), (2048, "fused"), (4096, "tmajor")):
        assert D.conv_route_mode(nfft) == route

