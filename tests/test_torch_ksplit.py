"""B10, the in-kernel ksplit, and the "ksplit" engine of the port's
dispatcher, against pffft_tpu.ops.dispatch on the same numpy inputs.

B10's wrapper (``dispatch.cfft_ksplit2_tmajor``) runs its plain version on
CPU tensors, and is held against the reference's Pallas kernel in
interpret mode, as the reference's own tests run it.  The CUDA kernel is
held against its plain version in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu.ops import dispatch as rdp
import pffft_tpu_torch as pt
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import pallas_fft as pk

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
SM90 = (9, 0)
# relative to max|ref|.  B10: the port's radix-16/8 chain against the
# reference's chain for m, both then the same twiddled radix-r combine in f32.
KSPLIT2_TOL = 2e-6
# the ksplit engine against the reference's: the same chain and einsum
# combine in f32, and 1e-5 of max against numpy, as the reference's test
KSPLIT_TOL = 1e-5


def _planes(n, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, b)).astype(np.float32),
            rng.standard_normal((n, b)).astype(np.float32))


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _pair(gr, gi):
    return gr.numpy().astype(np.float64) + 1j * gi.numpy()


@pytest.mark.parametrize("n,conf", [(1024, (512, 2)), (1024, (128, 8)), (640, (128, 5)),
                                    (384, (128, 3)), (2048, (128, 16)), (4096, (128, 32)),
                                    (4096, (2048, 2))])
def test_ksplit2_matches_reference_interpret(n, conf):
    b = 128
    re, im = _planes(n, b, n + conf[1])
    ref_plan, plan = pf.new_setup(n, strict=False), pt.new_setup(n, strict=False)
    mplan, last = D._build_ksplit(n, *conf)
    for backward in (False, True):
        er, ei = rdp.cfft_ksplit2_tmajor(ref_plan, jnp.asarray(re), jnp.asarray(im),
                                         backward=backward, conf=conf, interpret=True)
        want = np.asarray(er).astype(np.float64) + 1j * np.asarray(ei)
        tr, ti = torch.from_numpy(re), torch.from_numpy(im)
        plain = _pair(*D.ksplit2_tmajor_plain(mplan, last, tr, ti, backward=backward))
        wrapped = _pair(*D.cfft_ksplit2_tmajor(plan, tr, ti, backward=backward, conf=conf))
        assert _rel(plain, want) <= KSPLIT2_TOL, backward
        assert np.array_equal(wrapped, plain), backward


def test_ksplit2_wrapper_on_the_cpu():
    n, b = 4096, 100  # the default conf (2048, 2); a ragged batch
    plan = pt.new_setup(n)
    re, im = (torch.from_numpy(a) for a in _planes(n, b, 7))
    before = D.cfft_ksplit2_tmajor.launches
    yr, yi = D.cfft_ksplit2_tmajor(plan, re, im)
    assert D.cfft_ksplit2_tmajor.launches == before  # the CPU launches nothing
    ref = np.fft.fft(re.numpy().astype(np.float64) + 1j * im.numpy(), axis=0)
    assert _rel(_pair(yr, yi), ref) <= 1e-6
    br, bi = D.cfft_ksplit2_tmajor(plan, yr, yi, backward=True)
    assert torch.allclose(br / n, re, atol=1e-5) and torch.allclose(bi / n, im, atol=1e-5)


def test_ksplit2_tile_and_bad_confs():
    # the planner's (tb, cluster, slabs per block, threads): tb = 8 and one
    # slab a block at m = 2048 up to r = 16, two slabs of 4 columns at r = 32
    for n, conf, want in ((4096, (2048, 2), (8, 2, 1, 512)), (8192, (2048, 4), (8, 4, 1, 512)),
                          (16384, (2048, 8), (8, 8, 1, 512)),
                          (32768, (2048, 16), (8, 16, 1, 512)),
                          (65536, (2048, 32), (4, 16, 2, 512)),
                          (65536, (4096, 16), (4, 16, 1, 512)),
                          (640, (128, 5), (8, 1, 5, 160)), (384, (128, 3), (8, 1, 3, 96)),
                          (4096, (128, 32), (8, 2, 16, 512)), (1024, (512, 2), (8, 1, 2, 256))):
        mplan, _ = D._build_ksplit(n, *conf)
        assert D.ksplit2_tile(mplan, conf[1])[:4] == want, (n, conf)
    mplan, _ = D._build_ksplit(8192, 2048, 4)
    assert D.ksplit2_tile(mplan, 4, tb=4)[:3] == (4, 2, 2)  # the smallest cluster that fits
    assert D.ksplit2_tile(mplan, 4, tb=4, cluster=4)[:3] == (4, 4, 1)
    assert D.ksplit2_tile(mplan, 4, tb=16) is None
    assert D.ksplit2_tile(mplan, 4, cluster=3) is None  # 3 does not divide r
    z = torch.zeros((4096, 4))
    plan = pt.new_setup(4096)
    with pytest.raises(ValueError) as te:
        D.cfft_ksplit2_tmajor(plan, z, z, conf=(1024, 2))
    with pytest.raises(ValueError) as rf:
        rdp.cfft_ksplit2_tmajor(pf.new_setup(4096), jnp.zeros((4096, 128)),
                                jnp.zeros((4096, 128)), conf=(1024, 2), interpret=True)
    assert str(te.value) == str(rf.value) == "ksplit2 conf 1024*2 != 4096"
    with pytest.raises(ValueError, match="radix 64"):
        D.cfft_ksplit2_tmajor(plan, z, z, conf=(64, 64))
    big = torch.zeros((65536, 1))
    with pytest.raises(ValueError, match="no cluster of at most 16 blocks"):
        D.cfft_ksplit2_tmajor(pt.new_setup(65536), big, big, conf=(32768, 2))
    with pytest.raises(ValueError, match="tb=64"):
        D.cfft_ksplit2_tmajor(plan, z, z, tb=64)
    with pytest.raises(ValueError, match="data length"):
        D.cfft_ksplit2_tmajor(plan, z[:2048], z[:2048])


@pytest.mark.parametrize("n,conf", [(4096, None), (8192, None), (16384, None), (32768, None),
                                    (65536, None), (65536, (4096, 16)), (640, (128, 5)),
                                    (384, (128, 3)), (1920, (128, 15)), (3072, (1024, 3))])
def test_ksplit2_planner(n, conf):
    """B10's planner for the time-major band (default split (2048, N/2048))
    and radix-3/5 lengths: the cluster divides r and has at most 16 blocks,
    a block's slabs fit its threads and the card's shared memory, and
    tb >= 8 (32-byte row segments) up to N = 32768."""

    m, r = conf or (2048, n // 2048)
    built = D._build_ksplit(n, m, r)
    if r not in pk.COMBINE_RADICES:
        assert D.ksplit2_tile(built[0], r) is not None  # planned, but the wrapper refuses r
        with pytest.raises(ValueError, match="radix"):
            D.cfft_ksplit2_tmajor(pt.new_setup(n), torch.zeros((n, 1)), torch.zeros((n, 1)),
                                  conf=conf)
        return
    mplan, last = built
    assert mplan.engine_n * last.r == n
    t = D.ksplit2_tile(mplan, r)
    assert r % t.cluster == 0 and t.cluster <= D.KSPLIT2_MAX_CLUSTER
    assert t.slabs * t.cluster == r
    assert t.threads % 32 == 0 and t.threads <= pk.CORE_MAX_THREADS
    assert t.threads * 32 >= t.slabs * m * t.tb
    assert t.smem == t.slabs * (pk.core_pad(m - 1, t.shift) + 1) * t.tb * 8 <= 232448
    assert t.blocks_per_sm >= 1
    if n <= 32768:
        assert t.tb >= 8, t


def test_ksplit2_tb_and_cluster_keywords_on_the_cpu():
    """The tb and cluster keywords pick the launch shape; on the CPU the
    plain version runs whatever they are, once they are valid."""

    n, b = 4096, 24
    plan = pt.new_setup(n)
    re, im = (torch.from_numpy(a) for a in _planes(n, b, 11))
    want = D.cfft_ksplit2_tmajor(plan, re, im)
    for tb, cluster in ((4, None), (2, 2), (1, 1), (8, 2)):
        got = D.cfft_ksplit2_tmajor(plan, re, im, tb=tb, cluster=cluster)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (tb, cluster)
    with pytest.raises(ValueError, match="cluster=4"):
        D.cfft_ksplit2_tmajor(plan, re, im, cluster=4)  # 4 does not divide r = 2


def test_core_tables_are_the_chain_tables_transposed():
    mplan, last = D._build_ksplit(4096, 2048, 2)
    stages = tuple(mplan.stages)
    core, cdesc, ccount = pk._core_tables(stages, torch.device(CPU))
    chain, hdesc, hcount = pk._chain_tables(stages, torch.device(CPU))
    assert ccount == hcount and list(cdesc) == list(hdesc)
    core = core.numpy().view(np.complex64)
    chain = chain.numpy().view(np.complex64)
    for s in range(ccount):
        r, l, _, off = cdesc[4 * s: 4 * s + 4]
        assert np.array_equal(core[off: off + l * r].reshape(r, l),
                              chain[off: off + l * r].reshape(l, r).T)
    twc = pk._core_tables((last,), torch.device(CPU))[0].numpy().view(np.complex64)
    assert np.array_equal(twc.reshape(2, 2048), last.twiddle.astype(np.complex64).T)


@pytest.mark.parametrize("n,b", [(2048, 128), (4096, 64)])
def test_ksplit_engine_matches_reference(n, b):
    re, im = _planes(n, b, n)
    assert D._ksplit_conf(n) == rdp._ksplit_conf(n)
    ref_plan, plan = pf.new_setup(n), pt.new_setup(n)
    tr, ti = torch.from_numpy(re), torch.from_numpy(im)
    oracle = np.fft.fft(re.astype(np.float64) + 1j * im, axis=0)
    for backward in (False, True):
        er, ei = rdp.cfft_ksplit_tmajor(ref_plan, jnp.asarray(re), jnp.asarray(im),
                                        backward=backward, interpret=True)
        want = np.asarray(er).astype(np.float64) + 1j * np.asarray(ei)
        got = _pair(*D.cfft_ksplit_tmajor(plan, tr, ti, backward=backward))
        assert _rel(got, want) <= KSPLIT_TOL, backward
        if not backward:
            assert _rel(got, oracle) <= KSPLIT_TOL


def test_ksplit_conf_override(monkeypatch):
    monkeypatch.setattr(D, "_KSPLIT_CONF", {})
    assert D._ksplit_conf(4096) == (1024, 4)
    D.set_ksplit_conf(SM90, 4096, 512, 8)
    assert D._ksplit_conf(4096) == (512, 8)
    assert D._ksplit_conf(4096, torch.device(CPU)) == (512, 8)
    re, im = _planes(4096, 32, 5)
    er, ei = rdp.cfft_ksplit_tmajor(pf.new_setup(4096), jnp.asarray(re), jnp.asarray(im),
                                    conf=(512, 8), interpret=True)
    want = np.asarray(er).astype(np.float64) + 1j * np.asarray(ei)
    got = _pair(*D.cfft_ksplit_tmajor(pt.new_setup(4096), torch.from_numpy(re),
                                      torch.from_numpy(im)))
    assert _rel(got, want) <= KSPLIT_TOL
    with pytest.raises(ValueError, match="ksplit conf 512\\*4 != 4096"):
        D.set_ksplit_conf(SM90, 4096, 512, 4)
    assert D._ksplit_conf(1024) is None  # the chain covers it: no split below 2048


def test_ksplit_engine_availability():
    # listed where the split's m fits the chain's tile; any batch (the TPU's
    # lane gate does not carry over); never for f64 or batch-major planes
    assert "ksplit" in D.available_engines(pt.new_setup(2048), 100)
    assert "ksplit" in D.available_engines(pt.new_setup(65536), 3)
    assert "ksplit" not in D.available_engines(pt.new_setup(1024), 128)
    assert "ksplit" not in D.available_engines(pt.new_setup(2048, dtype="float64"), 128)
    assert "ksplit" not in D.available_engines(pt.new_setup(2048), 128, time_major=False)
    assert "ksplit" in D.available_engines(pt.new_setup(4096, pt.REAL), 128)
    # never a default: coverage keeps chain / kern2
    for n in (2048, 4096, 65536):
        assert D.select_engine(pt.new_setup(n), 128) in ("chain", "kern2")


@pytest.fixture
def ksplit_recorded(monkeypatch):
    """'ksplit' recorded at N = 2048 time-major in both packages' tables,
    complex and real-at-H (restored after)."""

    backend = jax.default_backend()
    monkeypatch.setitem(rdp._MEASURED_TABLE, (backend, 2048, True), "ksplit")
    # a fresh version before and after: the reference's jit caches key on it
    rdp._TABLE_VERSION += 1
    monkeypatch.setattr(D, "_MEASURED_TABLE", {})
    monkeypatch.setattr(D, "_MEASURED_TABLE_REAL", {})
    D.record_engine(SM90, 2048, "ksplit")
    D.record_engine_real(SM90, 2048, "ksplit")
    yield
    rdp._TABLE_VERSION += 1


def test_recorded_ksplit_serves_the_complex_call(ksplit_recorded):
    n, b = 2048, 128
    plan = pt.new_setup(n)
    assert D.select_engine(plan, b) == "ksplit"
    assert D.select_engine(plan, b, time_major=False) == "fused2"  # a time-major entry
    re, im = _planes(n, b, 77)
    rplan = pf.new_setup(n)
    for rdir, tdir in ((pf.FORWARD, pt.FORWARD), (pf.BACKWARD, pt.BACKWARD)):
        er, ei = pf.fft.transform_ordered_split_tmajor(rplan, (jnp.asarray(re),
                                                               jnp.asarray(im)), rdir)
        want = np.asarray(er).astype(np.float64) + 1j * np.asarray(ei)
        got = _pair(*pt.transform_ordered_split_tmajor(plan, (re, im), tdir, device=CPU))
        assert _rel(got, want) <= KSPLIT_TOL, tdir


def test_recorded_ksplit_serves_the_real_call(ksplit_recorded):
    n, b = 4096, 128
    plan = pt.new_setup(n, pt.REAL)
    assert D.select_engine(plan, b) == "ksplit"
    assert D.fused_real_fwd_route(plan, b) is None and D.packed_fwd_route(plan, b) is None
    x = np.random.default_rng(3).standard_normal((n, b)).astype(np.float32)
    rplan = pf.new_setup(n, pf.REAL)
    er, ei = pf.fft.transform_ordered_split_tmajor(rplan, jnp.asarray(x), pf.FORWARD)
    want = np.asarray(er).astype(np.float64) + 1j * np.asarray(ei)
    sr, si = pt.transform_ordered_split_tmajor(plan, x, device=CPU)
    assert _rel(_pair(sr, si), want) <= KSPLIT_TOL
    back = pt.transform_ordered_split_tmajor(plan, (sr, si), pt.BACKWARD)
    rback = pf.fft.transform_ordered_split_tmajor(rplan, (er, ei), pf.BACKWARD)
    assert _rel(back.numpy(), np.asarray(rback)) <= KSPLIT_TOL
    assert np.abs(back.numpy() / n - x).max() < 1e-4


def test_set_engine_ksplit():
    D.set_engine("ksplit")
    try:
        assert D.select_engine(pt.new_setup(4096), 8) == "ksplit"
        with pytest.raises(ValueError, match="unavailable"):
            D.select_engine(pt.new_setup(1024), 8)
    finally:
        D.set_engine(None)
    with pytest.raises(ValueError, match="does not serve batch-major"):
        D.record_engine(SM90, 4096, "ksplit", time_major=False)


def test_set_kern2_conf_is_read_by_kern2(monkeypatch):
    monkeypatch.setattr(D, "_KERN2_CONF", {})
    n, b = 4096, 16
    assert D._kern2_conf(n) == (2048, 2)
    D.set_kern2_conf(SM90, n, 1024, 4)
    assert D._kern2_conf(n) == (1024, 4)
    assert D._kern2_conf(n, torch.device(CPU)) == (1024, 4)
    re, im = (torch.from_numpy(a) for a in _planes(n, b, 9))
    got = D.cfft_kern2_tmajor(pt.new_setup(n), re, im)
    want = pk.combine_tmajor_plain(
        D._build_ksplit(n, 1024, 4)[1],
        *(a.reshape(n, b) for a in pk.chain_tmajor_plain(
            D._thin_plan(1024), re.reshape(1024, 4 * b), im.reshape(1024, 4 * b))))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="kern2 conf 1024\\*2 != 4096"):
        D.set_kern2_conf(SM90, n, 1024, 2)
