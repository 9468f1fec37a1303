"""The port's batch-major complex kernels and engines against pffft_tpu's.

* the plain version of the fused two-stage kernel (B9,
  ``ops/fused_stage.cfft_fused2_plain``) against the Pallas kernel it
  replaces, run with ``interpret=True`` as ``tests/test_fused_stage.py``
  runs it, ordered and internal, both directions;
* the batch-major convenience ``pallas_fft.cfft_pallas`` against the
  reference's;
* the dispatcher's batch-major engines: coverage at the H100's
  capability (9, 0), forced and measured engines, and each engine against
  the reference.

The CUDA kernel is held against its plain version in
``test_torch_cuda.py``.  All inputs are seeded numpy arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu import plan as rp
from pffft_tpu.ops import fused_stage as rfs
from pffft_tpu.ops import pallas_fft as rpk
import pffft_tpu_torch as pt
from pffft_tpu_torch import plan as tp
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import fused_stage as fs
from pffft_tpu_torch.ops import pallas_fft as pk

# One intra-op thread: the suite runs in several worker processes that share
# the cores, and an oversubscribed OpenMP pool slows each torch call by
# tens of times.
torch.set_num_threads(1)

# plain B9 vs the interpret-mode Pallas kernel, relative to max|ref|: the
# reference test's own tolerance (dense fp32 DFT matmuls there, the radix
# chain here)
FUSED2_TOL = 2e-5
# plain chain vs the interpret-mode Pallas chain: the same butterflies
CHAIN_TOL = 2e-6
# the public transform, relative to max|ref|
TOL = 1e-5
CPU = "cpu"


def _port_plan(ref_plan):
    d: dict = {}
    rp._plan_to_arrays(ref_plan, "p_", d)
    return tp.plan_from_reference(d)


def _rows(b, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)).astype(np.float32),
            rng.standard_normal((b, n)).astype(np.float32))


def _assert_close(got, ref, tol):
    got = [np.asarray(g) for g in got]
    ref = [np.asarray(r) for r in ref]
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref, strict=True):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= tol * scale


@pytest.mark.parametrize("n,mf", [(1024, 32), (2048, 64), (4096, 64), (1536, 48)])
@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("backward", [False, True])
def test_plain_fused2_matches_pallas_interpret(n, mf, ordered, backward):
    ref_plan = pf.new_setup(n, pf.COMPLEX, max_factor=mf)
    plan = _port_plan(ref_plan)
    assert rfs.supported(ref_plan) and fs.supported(plan)
    re, im = _rows(8, n, n)
    ref = rfs.cfft_fused2(ref_plan, jnp.asarray(re), jnp.asarray(im), backward=backward,
                          ordered=ordered, tb=8, interpret=True)
    got = fs.cfft_fused2_plain(plan, torch.from_numpy(re), torch.from_numpy(im),
                               backward=backward, ordered=ordered)
    _assert_close([g.numpy() for g in got], ref, FUSED2_TOL)
    # the wrapper takes the plain version for CPU tensors, at any batch
    wrapped = fs.cfft_fused2(plan, torch.from_numpy(re[:5]), torch.from_numpy(im[:5]),
                             backward=backward, ordered=ordered)
    _assert_close([w.numpy() for w in wrapped], [g[:5].numpy() for g in got], 0.0)


def test_fused2_wrapper_rejects_what_the_kernel_does_not_take():
    # the internal order is the plan's two factors': a five-stage plan has none
    with pytest.raises(ValueError, match="two-stage"):
        fs.cfft_fused2(pt.new_setup(1024), torch.zeros(2, 1024), torch.zeros(2, 1024),
                       ordered=False)
    plan = pt.new_setup(1024, max_factor=32)
    with pytest.raises(ValueError, match="engine length"):
        fs.cfft_fused2(plan, torch.zeros(2, 512), torch.zeros(2, 512))
    with pytest.raises(ValueError, match="planes must be"):
        fs.cfft_fused2(plan, torch.zeros(2, 1024), torch.zeros(3, 1024))
    assert not fs.supported(pt.new_setup(1 << 15, max_factor=32))  # three stages


def test_fused2_tile_from_sm90_shared_memory():
    """B9's planner: ceil(N / elems) threads a row (16 values a thread up to
    N = 4096, 32 above), short rows packed up to 256 threads, one padded
    row buffer each in shared memory; None past 16384."""

    t = fs.fused2_tile(4096)
    assert (t.rows, t.threads, t.elems, t.shift) == (1, 256, 16, 4)
    assert t.pitch == 4096 + 255 and t.smem == 8 * t.pitch
    assert fs.fused2_tile(16) == fs.Fused2Tile(64, 64, 16, 16, 4, 8192, 8)
    assert fs.fused2_tile(1024)[:3] == (4, 256, 16)
    assert fs.fused2_tile(2400)[:3] == (1, 160, 16)
    assert fs.fused2_tile(8192)[:3] == (1, 256, 32)
    assert fs.fused2_tile(16384)[:3] == (1, 512, 32)
    assert fs.fused2_tile(15360)[:3] == (1, 480, 32)
    assert fs.fused2_tile(32768) is None
    assert fs.fused2_tile(1 << 20) is None
    assert fs.fused2_tile(7 * 1024) is None  # not 2/3/5-smooth: no thin plan


@pytest.mark.parametrize("n", [16, 96, 1024, 1536, 2048, 2400, 4096, 6144, 8192, 15360, 16384])
def test_fused2_planner_covers_every_stage(n):
    """Every stage's butterflies fit one pass of the block (threads * elems
    >= rows * N), within the launch bound and the card's shared memory; two
    or more blocks per SM by the planner's own arithmetic up to N = 8192."""

    t = fs.fused2_tile(n)
    assert t.threads % 32 == 0 and t.threads <= pk.CORE_MAX_THREADS
    assert t.threads * t.elems >= t.rows * n
    assert t.pitch >= pk.core_pad(n - 1, t.shift) + 1
    assert t.smem == t.rows * t.pitch * 8 <= pk.smem_per_block()
    assert 1 <= t.rows <= fs.MAX_TB
    assert t.blocks_per_sm == pk.core_blocks_per_sm(t.threads, t.smem)
    if n <= 8192:
        assert t.blocks_per_sm >= 2, t
    else:
        assert t.blocks_per_sm >= 1, t


@pytest.mark.parametrize("n", [96, 1024])
def test_cfft_pallas_matches_reference(n):
    ref_plan = rp.new_setup(n, rp.COMPLEX, factors=rpk.thin_factors(n, radix16=True),
                            strict=False)
    plan = _port_plan(ref_plan)
    re, im = _rows(128, n, n)
    for backward in (False, True):
        ref = rpk.cfft_pallas(ref_plan, jnp.asarray(re), jnp.asarray(im),
                              backward=backward, tb=128, interpret=True)
        got = pk.cfft_pallas(plan, torch.from_numpy(re), torch.from_numpy(im),
                             backward=backward)
        assert got[0].is_contiguous()
        _assert_close([g.numpy() for g in got], ref, CHAIN_TOL)


# ---------------------------------------------------------------------------
# Batch-major engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,engine", [
    (16, "fused2"), (96, "fused2"), (1024, "fused2"), (2400, "fused2"),
    (15360, "fused2"), (16384, "fused2"),
    (32768, "tmajor"), (65536, "tmajor"),
    (131072, "stages"),  # no time-major kernel route either (no combine radix 64)
])
def test_bmajor_engine_follows_coverage(n, engine):
    plan = pt.new_setup(n)
    assert D.select_engine(plan, 256, time_major=False) == engine
    assert D.select_engine(plan, 7, time_major=False, device=torch.device(CPU)) == engine
    # a real plan's batch-major transform runs its length-N/2 engine
    assert D.select_engine(pt.new_setup(2 * n, pt.REAL), 256, time_major=False) == engine


@pytest.mark.parametrize("plan", [
    pt.new_setup(1024), pt.new_setup(1024, max_factor=32), pt.new_setup(16),
    pt.new_setup(96), pt.new_setup(2048, pt.REAL),  # a real plan: its length N/2
], ids=["1024-five-stage", "1024-two-stage", "16", "96", "real-2048"])
def test_fused2_ordered_call_takes_any_plan(plan):
    """The kernel's arithmetic is the thin chain whatever the plan, so an
    ordered call takes any plan of its engine length."""

    n = plan.engine_n
    re, im = _rows(7, n, n)
    for backward in (False, True):
        got = fs.cfft_fused2(plan, torch.from_numpy(re), torch.from_numpy(im),
                             backward=backward)
        z = torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(torch.complex128)
        ref = torch.fft.ifft(z, dim=-1) * n if backward else torch.fft.fft(z, dim=-1)
        _assert_close([g.numpy() for g in got], [ref.real.numpy(), ref.imag.numpy()], TOL)


def test_fused2_covers_f32_plans_its_tile_holds():
    own = pt.new_setup(1024, max_factor=32)
    assert D._kernel_stores_internal(own)
    assert not D._kernel_stores_internal(pt.new_setup(1024))
    assert not D._kernel_stores_internal(pt.new_setup(2048, pt.REAL))
    assert D._fused2_covers(pt.new_setup(1024)) and D._fused2_covers(pt.new_setup(16384))
    assert not D._fused2_covers(pt.new_setup(32768))
    assert not D._fused2_covers(pt.new_setup(1024, dtype="float64"))
    assert "fused2" not in D.available_engines(pt.new_setup(1024, dtype="float64"), 8, False)


def test_forced_engine_raises_where_unavailable():
    plan = pt.new_setup(32768)
    D.set_engine("fused2")
    try:
        with pytest.raises(ValueError, match="unavailable"):
            D.select_engine(plan, 8, time_major=False)
        with pytest.raises(ValueError, match="unavailable"):
            D.select_engine(pt.new_setup(1024), 8, time_major=True)
        assert D.select_engine(pt.new_setup(1024), 8, time_major=False) == "fused2"
    finally:
        D.set_engine(None)
    for engine in ("chain", "kern2"):
        D.set_engine(engine)
        try:
            with pytest.raises(ValueError, match="unavailable"):
                pt.transform_ordered_split(pt.new_setup(1024), (np.zeros((2, 1024)),) * 2,
                                           device=CPU)
        finally:
            D.set_engine(None)
    D.set_engine("tmajor")
    try:
        with pytest.raises(ValueError, match="unavailable"):
            D.select_engine(pt.new_setup(131072), 8, time_major=False)
    finally:
        D.set_engine(None)


def test_measured_bmajor_table():
    plan = pt.new_setup(1024)
    with pytest.raises(ValueError, match="does not serve batch-major"):
        D.record_engine((9, 0), 1024, "chain", time_major=False)
    with pytest.raises(ValueError, match="does not serve time-major"):
        D.record_engine((9, 0), 1024, "fused2", time_major=True)
    D.record_engine((9, 0), 1024, "tmajor", time_major=False)
    try:
        assert D.select_engine(plan, 8, time_major=False) == "tmajor"
        assert D.select_engine(plan, 8, time_major=True) == "chain"
        # the real table is its own: a real plan of engine length 1024 keeps fused2
        assert D.select_engine(pt.new_setup(2048, pt.REAL), 8, time_major=False) == "fused2"
    finally:
        D._MEASURED_TABLE.clear()
    assert D.select_engine(plan, 8, time_major=False) == "fused2"


@pytest.mark.parametrize("engine", D.BMAJOR_ENGINES)
@pytest.mark.parametrize("factors", [(32, 32), (4, 4, 4, 4, 4)])
def test_every_bmajor_engine_matches_reference(engine, factors):
    n = 1024
    plan, rplan = pt.new_setup(n, factors=factors), pf.new_setup(n, factors=factors)
    re, im = _rows(6, n, 4)
    D.set_engine(engine)
    try:
        for rdir, tdir in ((pf.FORWARD, pt.FORWARD), (pf.BACKWARD, pt.BACKWARD)):
            for tfn, rfn in ((pt.transform_ordered_split, pf.transform_ordered_split),
                             (pt.transform_split, pf.transform_split)):
                got = tfn(plan, (re, im), tdir, device=CPU)
                ref = rfn(rplan, (jnp.asarray(re), jnp.asarray(im)), rdir)
                _assert_close([g.numpy() for g in got], ref, TOL)
    finally:
        D.set_engine(None)
