"""B10, the in-kernel ksplit, against pffft_tpu.ops.dispatch on the same
numpy inputs.

B10's wrapper (``dispatch.cfft_ksplit2_tmajor``) runs its plain version on
CPU tensors, and is held against the reference's Pallas kernel in
interpret mode, as the reference's own tests run it.  The CUDA kernel is
held against its plain version in ``test_torch_cuda.py``."""

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
# relative to max|ref|.  B10: the port's radix-16/8 chain against the
# reference's chain for m, both then the same twiddled radix-r combine in f32.
KSPLIT2_TOL = 2e-6


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
