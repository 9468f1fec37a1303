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


# ---------------------------------------------------------------------------
# The real transform's kernels
# ---------------------------------------------------------------------------


def _real_tw(h, dev):
    from pffft_tpu_torch.ops import split as tsplit

    return tsplit.real_split_twiddle(pt.new_setup(2 * h, pt.REAL), dev)


def _hold(kernel_out, plain_out):
    torch.cuda.synchronize()
    for k, p in zip(kernel_out, plain_out, strict=True):
        assert k.shape == p.shape
        assert _rel(k, p) <= KERNEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("h,slabs", [(96, 1), (960, 1), (2048, 1), (2048, 2), (2048, 32)])
@pytest.mark.parametrize("b", [256, 250, 251])  # aligned, ragged, odd (scalar loads)
def test_packed_chain_kernel_matches_plain(cuda_device, h, slabs, b):
    plan = D._thin_plan(h)
    y = _planes(h, slabs * 2 * b, h + b, cuda_device)[0]
    before = pk.cfft_chain_tmajor_packed.launches
    got = pk.cfft_chain_tmajor_packed(plan, y, slabs=slabs)
    _hold(got, pk.chain_tmajor_packed_plain(plan, y, slabs=slabs))
    assert pk.cfft_chain_tmajor_packed.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("h", [96, 960, 1024, 2048])
@pytest.mark.parametrize("b", [1024, 1000, 1001])
def test_fused_real_kernel_matches_plain(cuda_device, h, b):
    plan = D._thin_plan(h)
    tw = _real_tw(h, cuda_device)
    y = _planes(h, 2 * b, h, cuda_device)[0]
    sr, si = _planes(h, b, h + 1, cuda_device)
    counts = (pk.rfft_chain_tmajor_fused.launches, pk.rfft_bwd_chain_tmajor_fused.launches)
    _hold(pk.rfft_chain_tmajor_fused(plan, y, tw),
          pk.rfft_chain_tmajor_fused_plain(plan, y, tw))
    _hold(pk.rfft_bwd_chain_tmajor_fused(plan, sr, si, tw),
          pk.rfft_bwd_chain_tmajor_fused_plain(plan, sr, si, tw))
    assert (pk.rfft_chain_tmajor_fused.launches,
            pk.rfft_bwd_chain_tmajor_fused.launches) == (counts[0] + 1, counts[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [96, 960, 2400, 4096, 65536])
@pytest.mark.parametrize("b", [256, 250, 251])
def test_split_kernel_matches_plain(cuda_device, h, b):
    tw = _real_tw(h, cuda_device)
    zr, zi = _planes(h, b, h + b, cuda_device)
    for backward in (False, True):
        before = pk.real_split_tmajor.launches
        _hold(pk.real_split_tmajor(zr, zi, tw, backward=backward),
              pk.real_split_tmajor_plain(zr, zi, tw, backward=backward))
        assert pk.real_split_tmajor.launches == before + 1


@pytest.mark.cuda
def test_refused_real_launches_raise(cuda_device, monkeypatch):
    """Tiles too large for one block are refused before launch and raise;
    the counters do not move."""

    plan = D._thin_plan(2048)
    tw = _real_tw(2048, cuda_device)
    sr, si = _planes(2048, 64, 6, cuda_device)
    y = _planes(2048, 128, 7, cuda_device)[0]
    wrappers = (pk.cfft_chain_tmajor_packed, pk.rfft_chain_tmajor_fused,
                pk.rfft_bwd_chain_tmajor_fused)
    before = [w.launches for w in wrappers]
    monkeypatch.setattr(pk, "chain_tile", lambda *a, **k: 64)  # a tile plan gone wrong
    with pytest.raises(RuntimeError, match="packed chain kernel"):
        pk.cfft_chain_tmajor_packed(plan, y)
    with pytest.raises(RuntimeError, match="fused real forward kernel"):
        pk.rfft_chain_tmajor_fused(plan, y, tw)
    with pytest.raises(RuntimeError, match="fused real backward kernel"):
        pk.rfft_bwd_chain_tmajor_fused(plan, sr, si, tw)
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError, match="contiguous float32"):
        pk.real_split_tmajor(sr.t(), si.t(), _real_tw(64, cuda_device))


# real N -> launches per direction (fused real, or packed chain + combine +
# split forward and split + chain + combine backward)
REAL_ROUTES = [(192, "chain"), (4096, "chain"), (8192, "kern2"), (131072, "kern2")]
_REAL_WRAPPERS = (pk.cfft_chain_tmajor, pk.cfft_combine_tmajor, pk.cfft_chain_tmajor_packed,
                  pk.rfft_chain_tmajor_fused, pk.rfft_bwd_chain_tmajor_fused,
                  pk.real_split_tmajor)


@pytest.mark.cuda
@pytest.mark.parametrize("n,engine", REAL_ROUTES)
@pytest.mark.parametrize("b", [40, 37])
def test_real_transform_on_the_card_matches_oracle(cuda_device, n, engine, b):
    plan = pt.new_setup(n, pt.REAL)
    assert D.select_engine(plan, b, device=cuda_device) == engine
    x = _planes(n, b, n, cuda_device)[0]
    keep = x.clone()
    counts = lambda: [w.launches for w in _REAL_WRAPPERS]
    c0 = counts()
    yr, yi = pt.transform_ordered_split_tmajor(plan, x)
    c1 = counts()
    back = pt.transform_ordered_split_tmajor(plan, (yr, yi), pt.BACKWARD)
    torch.cuda.synchronize()
    c2 = counts()
    fwd = [a - b_ for a, b_ in zip(c1, c0)]
    bwd = [a - b_ for a, b_ in zip(c2, c1)]
    if engine == "chain":
        assert (fwd, bwd) == ([0, 0, 0, 1, 0, 0], [0, 0, 0, 0, 1, 0])
    else:
        assert (fwd, bwd) == ([0, 1, 1, 0, 0, 1], [1, 1, 0, 0, 0, 1])
    ref = torch.fft.rfft(x.double(), dim=0)
    packed = ref[: n // 2].clone()
    packed[0] = torch.complex(ref[0].real, ref[n // 2].real)
    assert _rel(torch.complex(yr.double(), yi.double()), packed) <= ORACLE_TOL
    assert back.shape == (n, b) and _rel(back / n, x) <= ORACLE_TOL
    assert torch.equal(x, keep)
