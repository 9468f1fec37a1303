"""The port's planner against pffft_tpu.plan: size contract, factors,
twiddle tables (bit for bit) and serialization."""

import io

import numpy as np
import pytest

from pffft_tpu import plan as rp
from pffft_tpu_torch import plan as tp

SIZES = [16, 96, 160, 1024, 2400, 4096, 8192, 65536]
# The port mirrors the reference's native long-double planner.  Without it
# the reference falls back to float64 trig, which differs only where an
# exact zero is expected (cos(pi/2) = 6.1e-17 against the port's -2.5e-20),
# by at most 5.67e-16 over these sizes.  Unit-modulus tables: an absolute
# bound.
TABLE_TOL = 1e-15


def _assert_table_equal(port, ref):
    """Bit-identical where the reference's native planner loaded, else
    within TABLE_TOL."""

    assert port.dtype == ref.dtype == np.complex64 and port.shape == ref.shape
    if rp._native_planner() is not None:
        assert np.array_equal(port.view(np.int32), ref.view(np.int32))
    else:
        assert np.abs(port.astype(np.complex128) - ref).max() <= TABLE_TOL


def _arrays(plan_mod, plan) -> dict:
    d: dict = {}
    plan_mod._plan_to_arrays(plan, "p_", d)
    return d


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_size_contract_matches(kind):
    rk, tk = rp._coerce_kind(kind), tp._coerce_kind(kind)
    assert tp.min_fft_size(tk) == rp.min_fft_size(rk)
    for n in range(0, 5001):
        assert tp.is_valid_size(n, tk) == rp.is_valid_size(n, rk), n
        for higher in (True, False):
            assert tp.nearest_transform_size(n, tk, higher) == \
                rp.nearest_transform_size(n, rk, higher), (n, higher)
        assert tp.next_power_of_two(n) == rp.next_power_of_two(n)
        assert tp.is_power_of_two(n) == rp.is_power_of_two(n)
        if n and not tp.is_valid_size(n, tk):
            with pytest.raises(ValueError) as te:
                tp.new_setup(n, tk)
            with pytest.raises(ValueError) as re_:
                rp.new_setup(n, rk)
            assert str(te.value) == str(re_.value)


def test_c_style_enums_accepted():
    assert tp._coerce_kind(0) == tp.REAL and tp._coerce_kind(1) == tp.COMPLEX
    assert tp._coerce_direction(0) == tp.FORWARD
    assert tp._coerce_direction(1) == tp.BACKWARD
    assert tp._coerce_direction("inverse") == tp.BACKWARD


@pytest.mark.parametrize("n", SIZES)
def test_factors_match(n):
    assert tp.new_setup(n).factors == rp.new_setup(n).factors
    assert tp.decompose_smooth(n) == rp.decompose_smooth(n)
    # max_factor >= 5: below the largest prime neither planner terminates
    for mf in (5, 8, 16, 64):
        assert tp.plan_factors(n, mf) == rp.plan_factors(n, mf)


@pytest.mark.parametrize("n", SIZES)
def test_stage_tables_bit_identical(n):
    a, b = rp.new_setup(n), tp.new_setup(n)
    for sa, sb in zip(a.stages, b.stages, strict=True):
        assert (sa.r, sa.l, sa.m) == (sb.r, sb.l, sb.m)
        _assert_table_equal(sb.dft, sa.dft)
        _assert_table_equal(sb.twiddle, sa.twiddle)


@pytest.mark.parametrize("n", SIZES)
def test_tables_differ_only_at_exact_zeros(n):
    """Where the port's tables and the reference's differ at all (its
    float64 fallback), the component that differs is an exact zero of the
    trig on both sides (cos(pi/2) and its kin): below 1e-15 in magnitude."""

    a, b = rp.new_setup(n), tp.new_setup(n)
    pairs = [(sa.dft, sb.dft) for sa, sb in zip(a.stages, b.stages, strict=True)]
    pairs += [(sa.twiddle, sb.twiddle) for sa, sb in zip(a.stages, b.stages, strict=True)]
    if n % 32 == 0:  # a valid real size
        pairs.append((rp.new_setup(n, rp.REAL).real_twiddle,
                      tp.new_setup(n, tp.REAL).real_twiddle))
    for ref, port in pairs:
        for part in (np.real, np.imag):
            r, q = part(ref), part(port)
            d = r != q
            assert np.all(np.abs(r[d]) < 1e-15) and np.all(np.abs(q[d]) < 1e-15)


@pytest.mark.parametrize("n", [64, 1024, 2400])
def test_real_split_twiddle_bit_identical(n):
    _assert_table_equal(tp.new_setup(n, tp.REAL).real_twiddle,
                        rp.new_setup(n, rp.REAL).real_twiddle)


@pytest.mark.parametrize("n", [96, 2400, 65536])
def test_plan_from_reference_round_trips(n):
    ref = rp.new_setup(n, factors=(None if n != 96 else (16, 2, 3)),
                       max_factor=5, strict=False)
    buf = io.BytesIO()
    rp.save_plan(ref, buf)
    buf.seek(0)
    with np.load(buf, allow_pickle=False) as d:
        saved = dict(d)
    port = tp.plan_from_reference(saved)
    assert port.factors == ref.factors and port.n == ref.n
    again = _arrays(tp, port)
    assert again.keys() == saved.keys()
    for k, v in saved.items():
        assert again[k].dtype == v.dtype
        assert np.array_equal(again[k].view(np.uint8), v.view(np.uint8)) \
            if v.dtype != np.dtype("<U7") else again[k] == v


def test_save_load_round_trip(tmp_path):
    plan = tp.new_setup(2400)
    path = tmp_path / "plan.npz"
    tp.save_plan(plan, path)
    back = tp.load_plan(path)
    assert back == plan
    for sa, sb in zip(plan.stages, back.stages, strict=True):
        assert np.array_equal(sa.twiddle, sb.twiddle)
        assert np.array_equal(sa.dft, sb.dft)
    # the reference reads the port's file
    ref = rp.load_plan(path)
    assert ref.factors == plan.factors
