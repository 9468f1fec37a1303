"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the wrappers' launch counts and failures, and the public transform
against a complex128 oracle.

Every test here needs a CUDA device and nvcc; without them each skips.
The file imports neither jax nor pffft_tpu, so on a machine with a card it
runs without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import pffft_tpu_torch as pt
from pffft_tpu_torch.ops import _build
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import pallas_fft as pk

# CUDA kernel vs its plain version, relative to max|plain|: nvcc contracts
# a*b+c into FMAs, which round once where the plain version rounds twice
KERNEL_TOL = 2e-6
# public transform vs the complex128 oracle, relative to max|oracle|
ORACLE_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels run only on the card)")
    return torch.device("cuda")


def _planes(n, b, seed, dev):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((n, b)).astype(np.float32)).to(dev)
                 for _ in range(2))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [96, 160, 640, 1024, 2048, 2400])
@pytest.mark.parametrize("b", [1024, 1000, 1001])  # aligned, ragged, odd (scalar loads)
def test_chain_kernel_matches_plain(cuda_device, n, b):
    plan = D._thin_plan(n)
    # N=2400 is past the chain's coverage; the kernel still runs it at 4 columns
    tb = pk.chain_tile(n, [st.r for st in plan.stages], cuda_device) or 4
    re, im = _planes(n, b, n, cuda_device)
    for backward in (False, True):
        before = pk.cfft_chain_tmajor.launches
        kr, ki = pk.cfft_chain_tmajor(plan, re, im, backward=backward, tb=tb)
        pr, pi = pk.chain_tmajor_plain(plan, re, im, backward=backward)
        torch.cuda.synchronize()
        assert pk.cfft_chain_tmajor.launches == before + 1
        assert max(_rel(kr, pr), _rel(ki, pi)) <= KERNEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("r", pk.COMBINE_RADICES)
def test_combine_kernel_matches_plain(cuda_device, r):
    m = 2048
    last = D._build_ksplit(m * r, m, r)[1]
    for b in (256, 250):
        re, im = _planes(m * r, b, r, cuda_device)
        for backward in (False, True):
            before = pk.cfft_combine_tmajor.launches
            kr, ki = pk.cfft_combine_tmajor(last, re, im, backward=backward)
            pr, pi = pk.combine_tmajor_plain(last, re, im, backward=backward)
            torch.cuda.synchronize()
            assert pk.cfft_combine_tmajor.launches == before + 1
            assert max(_rel(kr, pr), _rel(ki, pi)) <= KERNEL_TOL, (b, backward)


@pytest.mark.cuda
def test_stream_copy_kernel_is_exact(cuda_device):
    re, im = _planes(1024, 1000, 3, cuda_device)
    for cut in (0, 1):  # 16-byte aligned, then a misaligned view
        a, b = re.view(-1)[cut:], im.view(-1)[cut:]
        cr, ci = pk.stream_copy(a.reshape(1, -1), b.reshape(1, -1))
        torch.cuda.synchronize()
        assert torch.equal(cr.view(-1), a) and torch.equal(ci.view(-1), b)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    plan = D._thin_plan(64)
    re, im = _planes(64, 32, 4, cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        pk.cfft_chain_tmajor(plan, re.double(), im.double())
    with pytest.raises(ValueError, match="contiguous float32"):
        pk.stream_copy(re.t(), im.t())
    with pytest.raises(ValueError, match="different devices"):
        pk.stream_copy(re, im.cpu())


@pytest.mark.cuda
def test_refused_launch_raises(cuda_device):
    """A tile too large for one block is refused before launch and raises;
    the counter does not move."""

    plan = D._thin_plan(2048)
    re, im = _planes(2048, 64, 5, cuda_device)
    before = pk.cfft_chain_tmajor.launches
    with pytest.raises(RuntimeError, match="chain kernel"):
        pk.cfft_chain_tmajor(plan, re, im, tb=64)
    assert pk.cfft_chain_tmajor.launches == before


@pytest.mark.cuda
def test_failed_build_raises_with_nvcc_output(cuda_device, tmp_path, monkeypatch):
    (tmp_path / "broken.cu").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc failed on broken.cu"):
        _build.build(["broken"])


@pytest.mark.cuda
@pytest.mark.parametrize("n,engine", [(96, "chain"), (2048, "chain"), (2400, "kern2"),
                                      (65536, "kern2")])
def test_transform_on_the_card_matches_oracle(cuda_device, n, engine):
    plan = pt.new_setup(n)
    assert D.select_engine(plan, 40, device=cuda_device) == engine
    re, im = _planes(n, 40, n, cuda_device)
    keep = re.clone(), im.clone()
    before = (pk.cfft_chain_tmajor.launches, pk.cfft_combine_tmajor.launches)
    yr, yi = pt.transform_ordered_split_tmajor(plan, (re, im))
    br, bi = pt.transform_ordered_split_tmajor(plan, (yr, yi), pt.BACKWARD)
    torch.cuda.synchronize()
    after = (pk.cfft_chain_tmajor.launches, pk.cfft_combine_tmajor.launches)
    assert after == (before[0] + 2, before[1] + (2 if engine == "kern2" else 0))
    assert yr.device.type == "cuda"
    ref = torch.fft.fft(torch.complex(re.double(), im.double()), dim=0)
    assert _rel(torch.complex(yr.double(), yi.double()), ref) <= ORACLE_TOL
    assert max(_rel(br / n, re), _rel(bi / n, im)) <= ORACLE_TOL
    assert torch.equal(re, keep[0]) and torch.equal(im, keep[1])
