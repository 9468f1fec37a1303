"""The port's stage engine (pffft_tpu_torch.ops.split) against
pffft_tpu.ops.split.cfft_stages_split_tmajor on the same plans and inputs.

Both packages run the same plan tables (the port's plan is built from the
reference's with ``plan_from_reference``) and the same "4mul" contraction
in f32, so they differ only in the order of the einsum sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pffft_tpu import plan as rp
from pffft_tpu.ops import split as rsplit
from pffft_tpu_torch import plan as tp
from pffft_tpu_torch.ops import split as tsplit

# One intra-op thread: the suite runs in several worker processes that share
# the cores, and an oversubscribed OpenMP pool slows each torch call by
# tens of times.
torch.set_num_threads(1)

# relative to max|ref|: f32 sums of at most 64 terms, taken in another order
TOL = 2e-6

PLANS = [
    (16, None),
    (96, None),
    (160, None),
    (1024, None),
    (2400, None),
    (1024, (64, 16)),  # fat dense stages: 64- and 16-term contractions
]


def _plans(n, factors):
    ref = rp.new_setup(n, rp.COMPLEX, max_factor=5, factors=factors, strict=False)
    d: dict = {}
    rp._plan_to_arrays(ref, "p_", d)
    return ref, tp.plan_from_reference(d)


def _planes(n, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, b)).astype(np.float32),
            rng.standard_normal((n, b)).astype(np.float32))


def _both(ref_plan, port_plan, re, im, backward, ordered):
    er, ei = rsplit.cfft_stages_split_tmajor(
        jnp.asarray(re), jnp.asarray(im), ref_plan.stages,
        backward=backward, ordered=ordered)
    gr, gi = tsplit.cfft_stages_split_tmajor(
        torch.from_numpy(re), torch.from_numpy(im), port_plan.stages,
        backward=backward, ordered=ordered)
    return (np.asarray(er), np.asarray(ei)), (gr.numpy(), gi.numpy())


@pytest.mark.parametrize("n,factors", PLANS)
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("ordered", [True, False])
def test_stage_engine_matches_reference(n, factors, backward, ordered):
    ref_plan, port_plan = _plans(n, factors)
    assert port_plan.factors == ref_plan.factors
    re, im = _planes(n, 24, n + 7 * backward)
    (er, ei), (gr, gi) = _both(ref_plan, port_plan, re, im, backward, ordered)
    scale = max(np.abs(er).max(), np.abs(ei).max())
    assert np.abs(gr - er).max() <= TOL * scale
    assert np.abs(gi - ei).max() <= TOL * scale


def test_stage_engine_matches_numpy():
    _, plan = _plans(2400, None)
    re, im = _planes(2400, 8, 3)
    gr, gi = tsplit.cfft_stages_split_tmajor(
        torch.from_numpy(re), torch.from_numpy(im), plan.stages,
        backward=False, ordered=True)
    ref = np.fft.fft(re.astype(np.float64) + 1j * im, axis=0)
    assert np.abs(gr.numpy() + 1j * gi.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_split_twiddle_tables_match_reference():
    """The split form of a table with l*r >= 2^21 entries: the same
    (hi, lo) factor tables as the reference, bit for bit."""

    l, r = 1 << 14, 128
    tw = rp._stage_twiddle(l, r, -1, np.complex64)
    for backward in (False, True):
        a = rsplit._tw_consts_from_table(tw, l * r, backward)
        b = tsplit._tw_consts_from_table(tw, l * r, backward)
        assert a[0] == b[0] == "split" and a[1] == b[1]
        for x, y in zip(a[2:], b[2:], strict=True):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.fixture
def small_split_threshold(monkeypatch):
    """Both engines take the split-table form from 2^10 entries on."""

    for mod in (rsplit, tsplit):
        monkeypatch.setattr(mod, "_TW_SPLIT_MIN", 1 << 10)
        mod._stage_consts.cache_clear()
    tsplit._device_consts.cache_clear()
    yield
    for mod in (rsplit, tsplit):
        mod._stage_consts.cache_clear()
    tsplit._device_consts.cache_clear()


@pytest.mark.parametrize("backward", [False, True])
def test_split_twiddle_form_matches_reference(small_split_threshold, backward):
    # last stage l=256, r=8: 2048 entries, l a multiple of 128
    ref_plan, port_plan = _plans(2048, (16, 16, 8))
    assert tsplit._stage_consts(port_plan.stages[-1], backward)[2][0] == "split"
    re, im = _planes(2048, 8, 11)
    (er, ei), (gr, gi) = _both(ref_plan, port_plan, re, im, backward, True)
    scale = max(np.abs(er).max(), np.abs(ei).max())
    assert np.abs(gr - er).max() <= TOL * scale
    assert np.abs(gi - ei).max() <= TOL * scale


def test_full_fp32_restores_matmul_settings():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    with tsplit._full_fp32():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    assert torch.get_float32_matmul_precision() == prec
