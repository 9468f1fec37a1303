"""The port's two-pass engine (kern2): the combine kernel's plain version
against the Pallas combine kernel, the whole engine against
pffft_tpu.ops.dispatch.cfft_kern2_tmajor.  The CUDA combine kernel is held
against its plain version in ``test_torch_cuda.py``.

The Pallas kernels run with ``interpret=True``, as the reference's own
tests run them on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu import plan as rp
from pffft_tpu.ops import dispatch as rdp
from pffft_tpu.ops import pallas_fft as rpk
from pffft_tpu_torch import plan as tp
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import pallas_fft as pk

# One intra-op thread: the suite runs in several worker processes that share
# the cores, and an oversubscribed OpenMP pool slows each torch call by
# tens of times.
torch.set_num_threads(1)

# relative to max|ref|.  The combine: the same twiddle and butterfly in f32
# on both sides.  kern2: pass A runs the radix-16/8 chain in the port and
# the reference's radix-4/2 chain for m=128, so the roundings differ.
COMBINE_TOL = 2e-6
KERN2_TOL = 2e-6

M = 128
# The reference's tables are bit-exact only where its native long-double
# planner loaded; its float64 fallback differs from the port's long-double
# tables at exact zeros (cos(pi/2) = 6.1e-17 against -2.5e-20), by at most
# 1.84e-16 here.  Unit-modulus entries: an absolute bound.
TABLE_TOL = 1e-15


def _assert_table_equal(port, ref):
    if rp._native_planner() is not None:
        assert np.array_equal(port.view(np.int32), ref.view(np.int32))
    else:
        assert np.abs(port.astype(np.complex128) - ref).max() <= TABLE_TOL


def _planes(n, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, b)).astype(np.float32),
            rng.standard_normal((n, b)).astype(np.float32))


def _last_stages(m, r):
    ref = rdp._build_ksplit(m * r, m, r)[1]
    port = D._build_ksplit(m * r, m, r)[1]
    assert (port.l, port.r, port.m) == (ref.l, ref.r, ref.m) == (m, r, 1)
    # W_N^{c*k} does not depend on how m was factored: the same table
    _assert_table_equal(port.twiddle, ref.twiddle)
    return ref, port


@pytest.mark.parametrize("r", pk.COMBINE_RADICES)
def test_plain_combine_matches_pallas_interpret(r):
    ref_last, port_last = _last_stages(M, r)
    re, im = _planes(M * r, 128, r)
    for backward in (False, True):
        er, ei = rpk.cfft_combine_tmajor(ref_last, jnp.asarray(re), jnp.asarray(im),
                                         backward=backward, interpret=True)
        er, ei = np.asarray(er), np.asarray(ei)
        gr, gi = pk.combine_tmajor_plain(port_last, torch.from_numpy(re),
                                         torch.from_numpy(im), backward=backward)
        scale = max(np.abs(er).max(), np.abs(ei).max())
        assert np.abs(gr.numpy() - er).max() <= COMBINE_TOL * scale, backward
        assert np.abs(gi.numpy() - ei).max() <= COMBINE_TOL * scale, backward


@pytest.mark.parametrize("n,conf", [(1024, (128, 8)), (2048, (128, 16)),
                                    (640, (128, 5))])
def test_kern2_matches_reference(n, conf):
    b = 128
    ref_plan = pf.new_setup(n, pf.COMPLEX)
    port_plan = tp.new_setup(n)
    re, im = _planes(n, b, n)
    er, ei = rdp.cfft_kern2_tmajor(ref_plan, jnp.asarray(re), jnp.asarray(im),
                                   conf=conf, interpret=True, tb_a=128)
    er, ei = np.asarray(er), np.asarray(ei)
    gr, gi = D.cfft_kern2_tmajor(port_plan, torch.from_numpy(re),
                                 torch.from_numpy(im), conf=conf)
    scale = max(np.abs(er).max(), np.abs(ei).max())
    assert np.abs(gr.numpy() - er).max() <= KERN2_TOL * scale
    assert np.abs(gi.numpy() - ei).max() <= KERN2_TOL * scale
    # and back: the unscaled round trip
    br, bi = D.cfft_kern2_tmajor(port_plan, gr, gi, backward=True, conf=conf)
    assert np.abs(br.numpy() / n - re).max() < 1e-5
    assert np.abs(bi.numpy() / n - im).max() < 1e-5


def test_kern2_conf_takes_the_largest_covered_m():
    assert D._kern2_conf(4096) == (2048, 2)
    assert D._kern2_conf(65536) == (2048, 32)
    assert D._kern2_conf(2400) == (1200, 2)
    assert D._kern2_conf(131072) is None  # r = 64 has no combine kernel
    with pytest.raises(ValueError, match="no kern2 configuration"):
        D.cfft_kern2_tmajor(tp.new_setup(131072), torch.zeros(131072, 1),
                            torch.zeros(131072, 1))


def test_combine_wrapper_on_cpu_runs_the_plain_version():
    _, last = _last_stages(M, 4)
    re, im = (torch.from_numpy(a) for a in _planes(M * 4, 6, 9))
    before = pk.cfft_combine_tmajor.launches
    gr, gi = pk.cfft_combine_tmajor(last, re, im)
    pr, pi = pk.combine_tmajor_plain(last, re, im)
    assert torch.equal(gr, pr) and torch.equal(gi, pi)
    assert pk.cfft_combine_tmajor.launches == before
    with pytest.raises(ValueError, match="data length"):
        pk.cfft_combine_tmajor(last, re[:-1], im[:-1])
