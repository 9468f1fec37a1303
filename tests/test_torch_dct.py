"""The port's DCT/DST, pffft_tpu_torch.dct, against pffft_tpu.dct on the
same seeded numpy inputs (all six transforms and the FFTPACK names), at
the reference tests' sizes: smooth inner lengths (the batch-major
dispatcher) and non-smooth ones (the chirp-Z path), float32 and float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pffft_tpu import dct as rd
from pffft_tpu import oracle
import pffft_tpu_torch as pt
from pffft_tpu_torch import dct as td

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-5       # f32, relative to max|ref|
TOL64 = 1e-12    # f64

# the reference tests' sizes (tests/test_dct.py): smooth inner lengths, then
# non-smooth ones through the chirp-Z path
DCT1_N = [9, 25, 65, 121, 30, 98]
DST1_N = [7, 24, 63, 127, 34, 101]
Q_N = [8, 16, 60, 128, 480, 15, 45, 135, 375, 7, 97, 101]
NAMES = ["dct1", "dst1", "dct2", "dct3", "dst2", "dst3"]


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name,n", [("dct1", n) for n in DCT1_N] + [("dst1", n) for n in DST1_N])
def test_type1_matches_reference(name, n):
    x = _x((3, n), n)
    got = getattr(td, name)(x, device=CPU)
    assert got.dtype == torch.float32 and got.shape == (3, n)
    assert _rel(got, getattr(rd, name)(jnp.asarray(x))) <= TOL
    assert _rel(got, getattr(oracle, name)(x)) <= 1e-4


@pytest.mark.parametrize("n", Q_N)
@pytest.mark.parametrize("name", ["dct2", "dct3", "dst2", "dst3"])
def test_quarterwave_matches_reference(n, name):
    x = _x((2, n), n)
    got = getattr(td, name)(x, device=CPU)
    assert got.dtype == torch.float32 and got.shape == (2, n)
    assert _rel(got, getattr(rd, name)(jnp.asarray(x))) <= TOL
    assert _rel(got, getattr(oracle, name)(x)) <= 2e-4


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n", [33, 64, 97])
def test_float64_matches_reference(name, n):
    x = _x((2, n), n, np.float64)
    got = getattr(td, name)(x, device=CPU)
    assert got.dtype == torch.float64
    assert _rel(got, getattr(rd, name)(jnp.asarray(x))) <= TOL64


def test_fftpack_names_and_factor_four():
    assert td.cost is td.dct1 and td.sint is td.dst1
    assert td.cosqf is td.dct3 and td.sinqf is td.dst3
    x = _x(64, 11)
    for name in ("cosqb", "sinqb"):
        assert _rel(getattr(td, name)(x, device=CPU), getattr(rd, name)(jnp.asarray(x))) <= TOL
    xt = torch.from_numpy(x)
    assert (td.cosqb(td.cosqf(xt)) / (4 * 64) - xt).abs().max() < 1e-4
    assert (td.sinqb(td.sinqf(xt)) / (4 * 64) - xt).abs().max() < 1e-4
    for name in NAMES + ["cost", "sint", "cosqb", "cosqf", "sinqb", "sinqf"]:
        assert getattr(pt, name) is getattr(td, name)


@pytest.mark.parametrize("n", [96, 45])
def test_inverse_pairs(n):
    x = torch.from_numpy(_x(n, 1))
    assert (td.dct3(td.dct2(x)) / (2 * n) - x).abs().max() < 1e-4
    assert (td.dst3(td.dst2(x)) / (2 * n) - x).abs().max() < 1e-4


def test_involutions():
    x = torch.from_numpy(_x(65, 2))  # 2(N-1) = 128
    assert (td.dct1(td.dct1(x)) / (2 * 64) - x).abs().max() < 1e-4
    y = torch.from_numpy(_x(63, 3))  # 2(N+1) = 128
    assert (td.dst1(td.dst1(y)) / (2 * 64) - y).abs().max() < 1e-4


def test_tensor_input_stays_and_is_not_modified():
    x = torch.from_numpy(_x((4, 60), 4))
    keep = x.clone()
    got = td.dct2(x)
    assert got.device.type == "cpu" and torch.equal(x, keep)
    assert _rel(got, rd.dct2(jnp.asarray(keep.numpy()))) <= TOL
