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
from pffft_tpu_torch.ops import fused_stage as fs
from pffft_tpu_torch.ops import pallas_fft as pk
from pffft_tpu_torch.ops import real_kernel as rk

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
    tb = None if pk.chain_core_tile(plan, cuda_device) else 4
    re, im = _planes(n, b, n, cuda_device)
    for backward in (False, True):
        before = pk.cfft_chain_tmajor.launches
        kr, ki = pk.cfft_chain_tmajor(plan, re, im, backward=backward, tb=tb)
        pr, pi = pk.chain_tmajor_plain(plan, re, im, backward=backward)
        torch.cuda.synchronize()
        assert pk.cfft_chain_tmajor.launches == before + 1
        assert max(_rel(kr, pr), _rel(ki, pi)) <= KERNEL_TOL


# every launch shape B1's planner allows at N = 1024 and 2048 (its sweep)
CHAIN_SHAPES = [(1024, 16, 32), (1024, 8, 32), (1024, 8, 16), (1024, 4, 32), (1024, 4, 16),
                (2048, 8, 32), (2048, 4, 32), (2048, 4, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,tb,elems", CHAIN_SHAPES)
def test_chain_kernel_every_launch_shape(cuda_device, n, tb, elems):
    """B1 at every launch shape its planner allows (the sweep), with a
    ragged batch; the card holds at least the planner's blocks per SM."""

    plan = D._thin_plan(n)
    tile = pk.chain_core_tile(plan, cuda_device, tb=tb, elems=elems)
    assert tile is not None
    assert pk.chain_core_occupancy(n, tile, cuda_device) >= tile.blocks_per_sm
    for b in (512, 509):
        re, im = _planes(n, b, n + b, cuda_device)
        for backward in (False, True):
            kr, ki = pk.cfft_chain_tmajor(plan, re, im, backward=backward, tb=tb, elems=elems)
            pr, pi = pk.chain_tmajor_plain(plan, re, im, backward=backward)
            torch.cuda.synchronize()
            assert max(_rel(kr, pr), _rel(ki, pi)) <= KERNEL_TOL, (b, backward)


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


# B4 on the register-resident core at B1's launch shapes: (m, slabs, B, tb,
# values a thread); B % tb != 0 puts a block's columns across two slabs
PACKED_SHAPES = [(2048, 2, 2048, None, None), (2048, 2, 1001, None, None),
                 (2048, 4, 12, None, None), (2048, 2, 250, 4, 16), (2048, 32, 37, 4, 32),
                 (1024, 2, 100, 16, 32), (1024, 1, 1001, 8, 16), (96, 1, 7, None, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,slabs,b,tb,elems", PACKED_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])  # a buffer 4 bytes past an aligned start
def test_packed_chain_kernel_straddling_odd_and_unaligned(cuda_device, m, slabs, b, tb, elems,
                                                          offset):
    plan = D._thin_plan(m)
    assert pk.chain_core_tile(plan, cuda_device, tb=tb, elems=elems) is not None
    flat = _planes(1, m * slabs * 2 * b + offset, m + b, cuda_device)[0].view(-1)
    y = flat[offset:].view(m, slabs * 2 * b)
    before = pk.cfft_chain_tmajor_packed.launches
    got = pk.cfft_chain_tmajor_packed(plan, y, slabs=slabs, tb=tb, elems=elems)
    _hold(got, pk.chain_tmajor_packed_plain(plan, y, slabs=slabs))
    assert pk.cfft_chain_tmajor_packed.launches == before + 1
    # the same stages as B1 on the unpacked planes
    v = y.view(m, slabs, 2, b)
    re, im = (v[:, :, j].reshape(m, slabs * b).contiguous() for j in (0, 1))
    _hold(got, pk.cfft_chain_tmajor(plan, re, im, tb=tb, elems=elems))


# B3's launch-shape overrides: batch columns x values a thread (those a
# block holds at each H)
FUSED_REAL_SHAPES = [(tb, el) for tb in (4, 8, 16, 32) for el in (16, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("h", [16, 96, 960, 1024, 1920, 2048])
@pytest.mark.parametrize("b", [1024, 1000, 1001, 7])
def test_fused_real_kernel_matches_plain(cuda_device, h, b):
    """B3 in both directions (the backward writes the real signal), at the
    planner's launch shape and every override a block holds, and on buffers
    4 bytes past an aligned start."""

    plan = D._thin_plan(h)
    tw = _real_tw(h, cuda_device)
    flat = _planes(1, 2 * h * b + 1, h, cuda_device)[0].view(-1)
    sflat = _planes(2, h * b + 1, h + 1, cuda_device)
    shapes = [(None, None)] + [(tb, el) for tb, el in FUSED_REAL_SHAPES
                               if pk.chain_core_tile(plan, cuda_device, tb=tb, elems=el)]
    for off in (0, 1):
        y = flat[off:off + 2 * h * b].view(h, 2 * b)
        sr, si = (p.view(-1)[off:off + h * b].view(h, b) for p in sflat)
        for tb, el in shapes if off == 0 else shapes[:1]:
            counts = (pk.rfft_chain_tmajor_fused.launches,
                      pk.rfft_bwd_chain_tmajor_fused.launches)
            _hold(pk.rfft_chain_tmajor_fused(plan, y, tw, tb=tb, elems=el),
                  pk.rfft_chain_tmajor_fused_plain(plan, y, tw))
            _hold([pk.rfft_bwd_chain_tmajor_fused(plan, sr, si, tw, tb=tb, elems=el)],
                  [pk.rfft_bwd_chain_tmajor_fused_plain(plan, sr, si, tw)])
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
def test_refused_real_launches_raise(cuda_device):
    """Tiles too large for one block are refused before launch and raise;
    the counters do not move."""

    plan = D._thin_plan(2048)
    tw = _real_tw(2048, cuda_device)
    sr, si = _planes(2048, 64, 6, cuda_device)
    y = _planes(2048, 128, 7, cuda_device)[0]
    wrappers = (pk.cfft_chain_tmajor_packed, pk.rfft_chain_tmajor_fused,
                pk.rfft_bwd_chain_tmajor_fused)
    before = [w.launches for w in wrappers]
    # more than one block holds
    with pytest.raises(RuntimeError, match="packed chain kernel"):
        pk.cfft_chain_tmajor_packed(plan, y, tb=64)
    with pytest.raises(RuntimeError, match="fused real forward kernel"):
        pk.rfft_chain_tmajor_fused(plan, y, tw, tb=64)
    with pytest.raises(RuntimeError, match="fused real backward kernel"):
        pk.rfft_bwd_chain_tmajor_fused(plan, sr, si, tw, tb=64)
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


# ---------------------------------------------------------------------------
# FIR filtering: the fused conv kernel, the polyphase FIR kernel, FastConv
# and the channelizer
# ---------------------------------------------------------------------------

from pffft_tpu_torch import channelizer as tch  # noqa: E402
from pffft_tpu_torch import conv as tc  # noqa: E402
from pffft_tpu_torch.ops import conv_kernel as ck  # noqa: E402
from pffft_tpu_torch.ops import pfb_kernel as pfb  # noqa: E402
from pffft_tpu_torch.utils import profiling as prof  # noqa: E402


def _spectrum(n, seed, dev, cplx):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(n // 3 + 1)
    if cplx:
        h = h + 1j * rng.standard_normal(h.size)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in ck.filter_spectrum(D._thin_plan(n), h))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128, 480, 2048])
@pytest.mark.parametrize("b", [1024, 1000, 1001])  # aligned, ragged, odd (scalar loads)
def test_conv_kernel_matches_plain(cuda_device, n, b):
    plan = D._thin_plan(n)
    re, im = _planes(n, b, n + b, cuda_device)
    for cplx in (False, True):
        hfr, hfi = _spectrum(n, n, cuda_device, cplx)
        before = ck.zconv_tmajor.launches
        got = ck.zconv_tmajor(plan, re, im, hfr, hfi)
        _hold(got, ck.zconv_tmajor_plain(plan, re, im, hfr, hfi))
        assert ck.zconv_tmajor.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,u", [(64, 33), (128, 65), (480, 200), (2048, 1025), (4096, 2049),
                                 (8192, 4097), (16384, 8193)])
@pytest.mark.parametrize("cplx", [False, True])
def test_stream_conv_kernel_matches_plain(cuda_device, n, u, cplx):
    """B7's stream map against its plain version: rows that start
    unaligned (odd L), a ragged tail, R = 1 and 3, real and complex, at
    every row length of its planner up to nfft 16384."""

    rng = np.random.default_rng(n + u + cplx)
    plan = D._thin_plan(n)
    hfr, hfi = _spectrum(n, n + 1, cuda_device, cplx)
    for rows, length in ((1, 9 * u + n + 3), (3, 20 * u + 7)):
        x = rng.standard_normal((rows, length))
        if cplx:
            x = x + 1j * rng.standard_normal(x.shape)
        xt = torch.from_numpy(x.astype(np.complex64 if cplx else np.float32)).to(cuda_device)
        for total in (length - (n - u), length - (n - u) - 5):
            before = ck.zconv_stream.launches
            got = ck.zconv_stream(plan, xt, hfr, hfi, u, total)
            _hold((got,), (ck.zconv_stream_plain(plan, xt, hfr, hfi, u, total),))
            assert ck.zconv_stream.launches == before + 1


def _ring_view(rows, length, offset, seed, dev, cplx=False):
    """rows x length at column ``offset`` of a wider seeded buffer (a ring
    buffer's rows), every sample outside the view NaN: a read past a row's
    end, or of the wrong row, shows in the result."""

    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((rows, offset + length + 4099))
    if cplx:
        buf = buf + 1j * rng.standard_normal(buf.shape)
    buf[:, :offset] = buf[:, offset + length:] = np.nan
    t = torch.from_numpy(buf.astype(np.complex64 if cplx else np.float32)).to(dev)
    return t[:, offset:offset + length]


@pytest.mark.cuda
@pytest.mark.parametrize("n,u", [(2048, 1025), (8192, 4097), (16384, 8193)])
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("offset", [1, 4097])
def test_stream_conv_kernel_reads_strided_rows(cuda_device, n, u, cplx, offset):
    """B7's stream map on rows that are slices of wider rows, read where
    they lie through the row stride: bit for bit the call on the same rows
    made contiguous, in one launch, at odd column offsets, R = 1 and 3."""

    plan = D._thin_plan(n)
    hfr, hfi = _spectrum(n, n + 1, cuda_device, cplx)
    for rows, length in ((1, 9 * u + n + 3), (3, 20 * u + 7)):
        x = _ring_view(rows, length, offset, n + rows + offset, cuda_device, cplx)
        total = length - (n - u) - 5
        want = ck.zconv_stream(plan, x.contiguous(), hfr, hfi, u, total)
        before = (ck.zconv_stream.launches, prof.counters.get(prof.STRIDED_READS, 0))
        got = ck.zconv_stream(plan, x, hfr, hfi, u, total)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert (ck.zconv_stream.launches, prof.counters.get(prof.STRIDED_READS, 0)) == (
            before[0] + 1, before[1] + (rows > 1))
    with pytest.raises(ValueError, match="unit inner stride"):
        ck.zconv_stream(plan, x[:, ::2], hfr, hfi, u, 100)


@pytest.mark.cuda
@pytest.mark.parametrize("n,u", [(2048, 1025), (4096, 2049), (8192, 4097), (16384, 8193)])
@pytest.mark.parametrize("cplx", [False, True])
def test_stream_map_counts_its_radix32_launches(cuda_device, n, u, cplx):
    """B7's stream map on its own plan (``stream_plan``: 32*16*16 at nfft
    8192, the thin plan elsewhere) over strided rows, against its plain
    version on that plan; ``kernels.stream_map.r32_launches`` counts the
    launch where the plan opens with radix 32, and no other."""

    plan = ck.stream_plan(n)
    hfr, hfi = _spectrum(n, n + 2, cuda_device, cplx)
    x = _ring_view(3, 20 * u + 7, 4097, n + 26, cuda_device, cplx)
    total = x.shape[1] - (n - u) - 5
    before = (ck.zconv_stream.launches, prof.counters.get(ck.R32_LAUNCHES, 0))
    got = ck.zconv_stream(plan, x, hfr, hfi, u, total)
    _hold((got,), (ck.zconv_stream_plain(plan, x, hfr, hfi, u, total),))
    r32 = plan.factors[0] == 32
    assert r32 == (n == 8192)
    assert (ck.zconv_stream.launches, prof.counters.get(ck.R32_LAUNCHES, 0)) == (
        before[0] + 1, before[1] + r32)


@pytest.mark.cuda
def test_core_kernels_refuse_a_radix32_descriptor(cuda_device):
    """Only the stream map's radix-32 instance takes a plan that opens
    with radix 32: B1, B9 and the column map refuse its descriptor
    (cudaErrorInvalidValue), and the stream map refuses it at another
    number of values a thread than its instance's (a shape error)."""

    n, dev = 8192, cuda_device
    tw, desc, count = pk._core_tables(ck.stream_plan(n).stages, dev)
    re, im = _planes(n, 4, 3, dev)
    out = torch.empty_like(re)
    ptrs = (re.data_ptr(), im.data_ptr(), out.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    lib, fn = pk._kernel("pf_chain_tmajor")
    assert fn(*ptrs, tw.data_ptr(), desc, count, n, 4, 1, 512, 32, 4, 0, 0, stream) == 1
    t = fs.fused2_tile(n, dev)
    lib, fn = pk._kernel("pf_fused2")
    assert fn(*ptrs, tw.data_ptr(), desc, count, n, 4, t.rows, t.threads, t.elems, t.pitch,
              t.shift, n, 1, 1, 0, 0, stream) == 1
    hf = torch.zeros(n, device=dev)
    lib, fn = pk._kernel("pf_conv_fused_tmajor")
    assert fn(*ptrs, hf.data_ptr(), hf.data_ptr(), tw.data_ptr(), desc, count, n, 4, 1, 512,
              32, 4, 0, stream) == 1
    x = torch.zeros((1, 3 * n), device=dev)
    t = ck.stream_tile(n, dev)
    lib, fn = pk._kernel("pf_conv_stream")
    args = (x.data_ptr(), out.data_ptr(), hf.data_ptr(), hf.data_ptr(), tw.data_ptr(), desc,
            count, n, 1, 3 * n, 3 * n, 100, 4097, 1, 1, t.rows, t.threads)
    assert fn(*args, 32, t.pitch, t.shift, 0, stream) == 9
    assert fn(*args, t.elems, t.pitch, t.shift, 0, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 1000, 4096])
@pytest.mark.parametrize("p", [1, 4, 8, 40])  # 40 takes the kernel's plain loop
def test_pfb_kernel_matches_plain(cuda_device, m, p):
    rng = np.random.default_rng(m + p)
    k = 70
    w = torch.from_numpy(rng.standard_normal((p, m)).astype(np.float32)).to(cuda_device)
    rows = torch.from_numpy(
        rng.standard_normal((3, k + p + 1, m)).astype(np.float32)).to(cuda_device)
    hist, x = _stream_planes((3,), p * m, k * m, m + p, cuda_device)
    counts = (pfb.pfb_fir.launches, pfb.pfb_fir_stream_tmajor.launches)
    _hold((pfb.pfb_fir(rows, w, k),), (pfb.pfb_fir_plain(rows, w, k),))
    _hold(pfb.pfb_fir_stream_tmajor(hist, x, w, k),
          pfb.pfb_fir_stream_tmajor_plain(hist, x, w, k))
    assert (pfb.pfb_fir.launches, pfb.pfb_fir_stream_tmajor.launches) == (
        counts[0] + 1, counts[1] + 1)


def _stream_planes(lead, hlen, xlen, seed, dev):
    """Seeded (hist_re, hist_im), (x_re, x_im) on the card."""

    rng = np.random.default_rng(seed)
    return tuple(tuple(torch.from_numpy(rng.standard_normal((*lead, n)).astype(np.float32))
                       .to(dev) for _ in range(2)) for n in (hlen, xlen))


@pytest.mark.cuda
@pytest.mark.parametrize("m,p,k,lead", [(4096, 8, 70, (2,)), (1000, 8, 3, (3,)),
                                        (1024, 8, 1, (2, 2)), (96, 33, 40, (2,)),
                                        (4096, 4, 300, ())])
@pytest.mark.parametrize("hop", [0, 2])  # offset 0 and H = M/2
def test_pfb_stream_map_one_launch_for_both_planes(cuda_device, m, p, k, lead, hop):
    """B8's stream map: both planes in one launch, against its plain twin,
    at K >= P and K < P, M not a multiple of the phase tile, P = 33 (the
    plain loop) and the oversampled channelizer's offset H."""

    w = _stream_planes((p,), m, 1, m + 3, cuda_device)[0][0]
    hist, x = _stream_planes(lead, p * m, k * m, m + p + k, cuda_device)
    off = m // hop if hop else 0
    before = pfb.pfb_fir_stream_tmajor.launches
    got = pfb.pfb_fir_stream_tmajor(hist, x, w, k, off)
    assert pfb.pfb_fir_stream_tmajor.launches == before + 1
    _hold(got, pfb.pfb_fir_stream_tmajor_plain(hist, x, w, k, off))


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, 2, 3, 5, 6, 7, 8])
def test_pfb_stream_map_every_tile_and_sliced_rows(cuda_device, warps):
    """Every block size of the stream map but the default (tiles of 32 to
    256 frames, ragged against K), on chunk planes that are slices of wider
    rows (read in place, unaligned)."""

    m, p, k = 1024, 8, 100
    hist, wide = _stream_planes((3,), p * m, (k + 3) * m + 5, 11, cuda_device)
    x = tuple(t[:, 5 + m: 5 + m + k * m] for t in wide)
    w = _stream_planes((p,), m, 1, 12, cuda_device)[0][0]
    got = pfb.pfb_fir_stream_tmajor(hist, x, w, k, warps=warps)
    _hold(got, pfb.pfb_fir_stream_tmajor_plain(hist, x, w, k))


@pytest.mark.cuda
def test_fir_kernels_reject_bad_arguments(cuda_device):
    """Bad arguments raise; nothing falls back to the plain versions."""

    plan = D._thin_plan(128)
    re, im = _planes(128, 64, 8, cuda_device)
    hfr, hfi = _spectrum(128, 1, cuda_device, False)
    before = (ck.zconv_tmajor.launches, ck.zconv_stream.launches, pfb.pfb_fir.launches)
    with pytest.raises(ValueError, match="filter spectrum"):
        ck.zconv_tmajor(plan, re, im, hfr[:64], hfi[:64])
    with pytest.raises(ValueError, match="float32 or complex64"):
        ck.zconv_stream(plan, re.double(), hfr, hfi, 65, 100)
    with pytest.raises(ValueError, match="hop"):
        ck.zconv_stream(plan, re, hfr, hfi, 129, 100)
    with pytest.raises(ValueError, match="different devices|filter spectrum"):
        ck.zconv_tmajor(plan, re, im, hfr.cpu(), hfi.cpu())
    with pytest.raises(RuntimeError, match="fused conv kernel"):
        ck.zconv_tmajor(plan, re, im, hfr, hfi, tb=256)  # a tile too large for one block
    w = torch.ones((4, 64), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        pfb.pfb_fir(torch.ones((64, 20), device=cuda_device).t(), w, 8)
    with pytest.raises(ValueError, match="K \\+ P - 1"):
        pfb.pfb_fir(torch.ones((10, 64), device=cuda_device), w, 8)
    hist = (torch.zeros(256, device=cuda_device),) * 2
    x = (torch.ones(64 * 8, device=cuda_device),) * 2
    stream_before = pfb.pfb_fir_stream_tmajor.launches
    with pytest.raises(ValueError, match="weights on"):
        pfb.pfb_fir_stream_tmajor(hist, x, w.cpu(), 8)
    with pytest.raises(ValueError, match="float32"):
        pfb.pfb_fir_stream_tmajor(hist, tuple(t.double() for t in x), w, 8)
    with pytest.raises(ValueError, match="device"):
        pfb.pfb_fir_stream_tmajor((hist[0].cpu(), hist[1]), x, w, 8)
    with pytest.raises(RuntimeError, match="stream map"):  # the kernel refuses 9 warps
        pfb.pfb_fir_stream_tmajor(hist, x, w, 8, warps=9)
    assert pfb.pfb_fir_stream_tmajor.launches == stream_before
    assert (ck.zconv_tmajor.launches, ck.zconv_stream.launches, pfb.pfb_fir.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("flen", [16, 1024, 4096, 16385])
@pytest.mark.parametrize("flags", [tc.ConvFlags.NONE, tc.ConvFlags.CORRELATION,
                                   tc.ConvFlags.CPLX_INP_OUT,
                                   tc.ConvFlags.CPLX_INP_OUT | tc.ConvFlags.CPLX_SINGLE_FFT,
                                   tc.ConvFlags.CPLX_INP_OUT | tc.ConvFlags.CPLX_FILTER])
def test_fastconv_on_the_card_matches_oracle(cuda_device, flen, flags):
    rng = np.random.default_rng(flen + int(flags))
    cplx = bool(flags & tc.ConvFlags.CPLX_INP_OUT)
    h = rng.standard_normal(flen)
    if flags & tc.ConvFlags.CPLX_FILTER:
        h = h + 1j * rng.standard_normal(flen)
    x = rng.standard_normal((3, 5 * flen + 333))
    if cplx:
        x = x + 1j * rng.standard_normal(x.shape)
    fc = tc.FastConv(h, flags=flags)
    route = "fused" if fc.nfft <= 16384 else "tmajor"  # CPLX_SINGLE_FFT doubles nfft
    assert D.conv_route_mode(fc.nfft, None, cuda_device, stream=True) == route
    xt = torch.from_numpy(x.astype(np.complex64 if cplx else np.float32)).to(cuda_device)
    before = ck.zconv_stream.launches
    y = fc.apply_batched(xt)
    torch.cuda.synchronize()
    assert ck.zconv_stream.launches == before + (1 if route == "fused" else 0)
    # valid-mode y[i] = sum_j x[i + j] * c[j] (c = reversed h, or h for
    # correlation) as a complex128 FFT convolution with g = reversed c
    xd = xt.to(torch.complex128)
    g = torch.from_numpy(np.asarray(h, np.complex128)).to(cuda_device)
    if flags & tc.ConvFlags.CORRELATION:
        g = g.flip(0)
    nfull = xd.shape[-1] + flen - 1
    full = torch.fft.ifft(torch.fft.fft(xd, nfull) * torch.fft.fft(g, nfull))
    ref = full[..., flen - 1: xd.shape[-1]]
    if not cplx:
        ref = ref.real
    assert 0 < y.shape[-1] <= ref.shape[-1]
    assert _rel(y, ref[..., : y.shape[-1]]) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [tc.ConvFlags.NONE, tc.ConvFlags.CPLX_INP_OUT,
                                   tc.ConvFlags.CPLX_INP_OUT | tc.ConvFlags.CPLX_SINGLE_FFT])
def test_fastconv_reads_a_strided_view_in_place(cuda_device, flags):
    """FastConv on a slice of a ring buffer's rows: the stream map reads the
    caller's rows in place (no layout copy, one strided read); a view with a
    non-unit inner stride is still copied, and counted."""

    cplx = bool(flags & tc.ConvFlags.CPLX_INP_OUT)
    fc = tc.FastConv(pt.design_lowpass(1024, 0.1), flags=flags)
    x = _ring_view(4, 60001, 7, int(flags), cuda_device, cplx)
    want = fc.apply_batched(x.contiguous(), flush=False)
    keys = ("entry.copy_bytes", prof.STRIDED_READS)
    before = [prof.counters.get(k, 0) for k in keys]
    got = fc.apply_batched(x, flush=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert [prof.counters.get(k, 0) for k in keys] == [before[0], before[1] + 1]
    x2 = x[:, ::2]
    want = fc.apply_batched(x2.contiguous(), flush=False)
    before = [prof.counters.get(k, 0) for k in keys]
    got = fc.apply_batched(x2, flush=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # the interleaved stream's reshape to [R, 2L] has made its rows already
    copied = 0 if flags & tc.ConvFlags.CPLX_SINGLE_FFT else x2.nbytes
    assert [prof.counters.get(k, 0) for k in keys] == [before[0] + copied, before[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("m,p", [(16, 8), (1024, 8), (4096, 4)])
def test_channelizer_on_the_card_matches_oracle(cuda_device, m, p):
    rng = np.random.default_rng(m)
    ch = tch.Channelizer(m, p)
    k = 24
    x = rng.standard_normal((2, 2 * k * m)) + 1j * rng.standard_normal((2, 2 * k * m))
    xt = torch.from_numpy(x.astype(np.complex64)).to(cuda_device)
    before = pfb.pfb_fir_stream_tmajor.launches
    y1, st = ch.process(ch.init_state((2,)), xt[:, : k * m])
    y2, _ = ch.process(st, xt[:, k * m:])
    yall, _ = ch.process(ch.init_state((2,)), xt)
    torch.cuda.synchronize()
    assert pfb.pfb_fir_stream_tmajor.launches == before + 3  # one for both planes
    y = torch.cat([y1, y2], dim=-2)
    assert _rel(y, yall) <= 1e-6
    # oracle: the float64 polyphase sum, then an unscaled inverse DFT
    h = torch.from_numpy(ch.weights.astype(np.float64)).to(cuda_device)  # [P, M]
    xd = torch.cat([torch.zeros((2, p * m), dtype=torch.complex128, device=cuda_device),
                    xt.to(torch.complex128)], dim=-1)
    ks = torch.arange(2 * k, device=cuda_device)
    ph = torch.arange(m, device=cuda_device)
    v = torch.zeros((2, 2 * k, m), dtype=torch.complex128, device=cuda_device)
    for s in range(p):
        idx = (p + ks[:, None] - s) * m - ph[None, :]
        v += xd[:, idx] * h[s]
    ref = torch.fft.ifft(v, dim=-1) * m
    assert _rel(y, ref) <= 1e-5


# ---------------------------------------------------------------------------
# The batch-major transforms: the fused two-stage kernel (B9), the
# batch-major split kernel (B6), and the public API on the card
# ---------------------------------------------------------------------------

def _rows(b, n, seed, dev):
    return tuple(t.t().contiguous() for t in _planes(n, b, seed, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,mf", [(1024, 32), (1536, 48), (2400, 64), (4096, 64), (96, 16),
                                  (8192, 128), (16384, 128)])
@pytest.mark.parametrize("b", [13, 1000, 1001, 1])  # ragged last block, aligned, odd, one row
def test_fused2_kernel_matches_plain(cuda_device, n, mf, b):
    plan = pt.new_setup(n, max_factor=mf, strict=False)
    assert fs.supported(plan)
    re, im = _rows(b, n, n + b, cuda_device)
    for ordered in (True, False):
        for backward in (False, True):
            before = fs.cfft_fused2.launches
            _hold(fs.cfft_fused2(plan, re, im, backward=backward, ordered=ordered),
                  fs.cfft_fused2_plain(plan, re, im, backward=backward, ordered=ordered))
            assert fs.cfft_fused2.launches == before + 1


@pytest.mark.cuda
def test_fused2_kernel_scalar_path(cuda_device):
    """N % 4 != 0 (a derived length no public plan has) and a misaligned
    view take the kernel's scalar loads and stores."""

    plan = pt.new_setup(90, factors=(10, 9), strict=False)
    re, im = _rows(37, 90, 1, cuda_device)
    _hold(fs.cfft_fused2(plan, re, im, ordered=False),
          fs.cfft_fused2_plain(plan, re, im, ordered=False))
    plan = pt.new_setup(1024, max_factor=32)
    base = _planes(1, 1024 * 9 + 1, 2, cuda_device)
    re, im = (t.view(-1)[1:].reshape(9, 1024) for t in base)
    _hold(fs.cfft_fused2(plan, re, im), fs.cfft_fused2_plain(plan, re, im))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [16, 48, 4096, 3 * (1 << 14)])
@pytest.mark.parametrize("b", [1, 7, 33])
def test_bmajor_split_kernel_matches_plain(cuda_device, h, b):
    tw = _real_tw(h, cuda_device)
    zr, zi = _rows(b, h, h + b, cuda_device)
    for backward in (False, True):
        before = rk.real_split.launches
        _hold(rk.real_split(zr, zi, tw, backward=backward),
              rk.real_split_plain(zr, zi, tw, backward=backward))
        assert rk.real_split.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [pt.new_setup(1024), pt.new_setup(16),
                                  pt.new_setup(2048, pt.REAL)],
                         ids=["1024-five-stage", "16", "real-2048"])
def test_fused2_ordered_kernel_takes_any_plan(cuda_device, plan):
    n = plan.engine_n
    re, im = _rows(13, n, n, cuda_device)
    for backward in (False, True):
        before = fs.cfft_fused2.launches
        _hold(fs.cfft_fused2(plan, re, im, backward=backward),
              fs.cfft_fused2_plain(plan, re, im, backward=backward))
        assert fs.cfft_fused2.launches == before + 1


@pytest.mark.cuda
def test_refused_bmajor_launches_raise(cuda_device, monkeypatch):
    """A tile too large for one block is refused before launch and raises;
    the counter does not move."""

    plan = pt.new_setup(4096, max_factor=64)
    re, im = _rows(64, 4096, 3, cuda_device)
    before = fs.cfft_fused2.launches
    good = fs.fused2_tile(4096, cuda_device)
    # plans gone wrong: two rows on one row's threads; 240 KB of shared memory
    for bad in (good._replace(rows=2, smem=2 * good.smem),
                good._replace(pitch=30000, smem=240000)):
        with monkeypatch.context() as mp:
            mp.setattr(fs, "fused2_tile", lambda *a, bad=bad, **k: bad)
            with pytest.raises(RuntimeError, match="fused two-stage kernel"):
                fs.cfft_fused2(plan, re, im)
    assert fs.cfft_fused2.launches == before
    with pytest.raises(ValueError, match="contiguous float32"):
        rk.real_split(re.t(), im.t(), _real_tw(64, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("n,engine", [(96, "fused2"), (2400, "fused2"), (16384, "fused2"),
                                      (65536, "tmajor")])
def test_bmajor_transform_on_the_card_matches_oracle(cuda_device, n, engine):
    plan = pt.new_setup(n)
    assert D.select_engine(plan, 15, time_major=False, device=cuda_device) == engine
    re, im = (t.reshape(3, 5, n) for t in _rows(15, n, n, cuda_device))
    x = torch.complex(re, im)
    keep = x.clone()
    before = fs.cfft_fused2.launches
    y = pt.transform_ordered(plan, x)
    back = pt.icfft(plan, y)
    torch.cuda.synchronize()
    assert fs.cfft_fused2.launches == before + (2 if engine == "fused2" else 0)
    assert y.dtype == torch.complex64 and y.shape == x.shape
    ref = torch.fft.fft(x.to(torch.complex128), dim=-1)
    assert _rel(y.to(torch.complex128), ref) <= ORACLE_TOL
    assert _rel(back / n, x) <= ORACLE_TOL
    assert torch.equal(x, keep)
    sr, si = pt.transform_ordered_split(plan, (re, im))
    assert _rel(torch.complex(sr, si).to(torch.complex128), ref) <= ORACLE_TOL
    # internal order and back
    z = pt.transform(plan, x)
    assert _rel(pt.zreorder(plan, z).to(torch.complex128), ref) <= ORACLE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,engine", [(192, "fused2"), (2048, "fused2"), (32768, "fused2"),
                                      (131072, "tmajor")])
def test_bmajor_real_transform_on_the_card_matches_oracle(cuda_device, n, engine):
    plan = pt.new_setup(n, pt.REAL)
    assert D.select_engine(plan, 6, time_major=False, device=cuda_device) == engine
    x = _rows(6, n, n, cuda_device)[0].reshape(2, 3, n)
    counts = lambda: (rk.real_split.launches, fs.cfft_fused2.launches)
    c0 = counts()
    s = pt.rfft_packed(plan, x)
    c1 = counts()
    back = pt.irfft_packed(plan, s)
    torch.cuda.synchronize()
    c2 = counts()
    b9 = 1 if engine == "fused2" else 0
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (1, b9)
    assert (c2[0] - c1[0], c2[1] - c1[1]) == (1, b9)
    ref = torch.fft.rfft(x.double(), dim=-1)
    packed = ref[..., : n // 2].clone()
    packed[..., 0] = torch.complex(ref[..., 0].real, ref[..., n // 2].real)
    assert s.shape == (2, 3, n // 2) and _rel(s.to(torch.complex128), packed) <= ORACLE_TOL
    assert back.shape == x.shape and _rel(back / n, x) <= ORACLE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,conf", [(640, (128, 5)), (384, (128, 3)), (2048, (128, 16)),
                                    (4096, (128, 32)), (4096, None), (8192, None),
                                    (16384, None), (32768, None), (65536, None),
                                    (65536, (4096, 16))])
@pytest.mark.parametrize("b", [256, 250, 251])  # aligned, ragged, odd (scalar loads)
def test_ksplit2_kernel_matches_plain_and_oracle(cuda_device, n, conf, b):
    plan = pt.new_setup(n, strict=False)
    mplan, last = D._build_ksplit(n, *(conf or (2048, n // 2048)))
    re, im = _planes(n, b, n + b, cuda_device)
    z = torch.complex(re.double(), im.double())
    for backward in (False, True):
        before = D.cfft_ksplit2_tmajor.launches
        kr, ki = D.cfft_ksplit2_tmajor(plan, re, im, backward=backward, conf=conf)
        pr, pi = D.ksplit2_tmajor_plain(mplan, last, re, im, backward=backward)
        torch.cuda.synchronize()
        assert D.cfft_ksplit2_tmajor.launches == before + 1
        assert max(_rel(kr, pr), _rel(ki, pi)) <= KERNEL_TOL, backward
        ref = torch.fft.ifft(z, dim=0) * n if backward else torch.fft.fft(z, dim=0)
        assert _rel(torch.complex(kr.double(), ki.double()), ref) <= ORACLE_TOL, backward


@pytest.mark.cuda
def test_refused_ksplit2_launch_raises(cuda_device, monkeypatch):
    """A launch shape the kernel or the card refuses raises before launch;
    the counter does not move."""

    re, im = _planes(4096, 8, 1, cuda_device)
    before = D.cfft_ksplit2_tmajor.launches
    mplan, last = D._build_ksplit(4096, 2048, 2)
    good = D.ksplit2_tile(mplan, 2, cuda_device)
    # plans gone wrong: two slabs of 8 columns (32768 values) on 512 threads;
    # a cluster of 4 blocks for r = 2
    for bad in (good._replace(cluster=1, slabs=2), good._replace(cluster=4)):
        with monkeypatch.context() as mp:
            mp.setattr(D, "ksplit2_tile", lambda *a, bad=bad, **k: bad)
            with pytest.raises(RuntimeError, match="ksplit2 kernel"):
                D.cfft_ksplit2_tmajor(pt.new_setup(4096), re, im)
    assert D.cfft_ksplit2_tmajor.launches == before
    clusters, blocks = D.ksplit2_occupancy(mplan, 2, good, cuda_device)
    assert clusters >= 1 and blocks >= 1
    with pytest.raises(ValueError, match="CUDA tensor|contiguous float32"):
        D.cfft_ksplit2_tmajor(pt.new_setup(4096), re.T.contiguous().T, im)


def _f64_counts():
    return [w.launches for w in (pk.cfft_chain_tmajor, pk.cfft_combine_tmajor,
                                 pk.cfft_chain_tmajor_packed, pk.rfft_chain_tmajor_fused,
                                 pk.rfft_bwd_chain_tmajor_fused, pk.real_split_tmajor,
                                 fs.cfft_fused2, rk.real_split, D.cfft_ksplit2_tmajor)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [96, 4096, 65536])
def test_float64_on_the_card_matches_oracle(cuda_device, n):
    rng = np.random.default_rng(n)
    z = torch.from_numpy(rng.standard_normal((n, 6)) + 1j * rng.standard_normal((n, 6)))
    z = z.to(cuda_device)
    x = torch.from_numpy(rng.standard_normal((2 * n, 6))).to(cuda_device)
    c0 = _f64_counts()
    plan, rplan = pt.new_setup(n, dtype="float64"), pt.new_setup(2 * n, pt.REAL, dtype="float64")
    yr, yi = pt.transform_ordered_split_tmajor(plan, (z.real, z.imag))
    yb = pt.transform_ordered(plan, z.T)
    sr, si = pt.transform_ordered_split_tmajor(rplan, x)
    back = pt.transform_ordered_split_tmajor(rplan, (sr, si), pt.BACKWARD)
    s = pt.rfft_packed(rplan, x.T)
    torch.cuda.synchronize()
    assert _f64_counts() == c0  # no kernel is f64
    assert yr.dtype == torch.float64 and yb.dtype == torch.complex128
    ref = torch.fft.fft(z, dim=0)
    assert _rel(torch.complex(yr, yi), ref) <= 1e-12
    assert _rel(yb, ref.T) <= 1e-12
    rref = torch.fft.rfft(x, dim=0)
    packed = rref[:n].clone()
    packed[0] = torch.complex(rref[0].real, rref[n].real)
    assert _rel(torch.complex(sr, si), packed) <= 1e-12
    assert _rel(s, packed.T) <= 1e-12
    assert _rel(back / (2 * n), x) <= 1e-12


# ---------------------------------------------------------------------------
# The PFDSP chain, the STFT front end and the resampler: the card's result
# against the port's own CPU result on the same inputs
# ---------------------------------------------------------------------------

MIXER_TOL = 2e-6   # cos/sin and the complex product, a few ulp apart
DSP_TOL = 1e-5     # products and transforms summed in another order


def _cplx(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.123, -0.3, 0.49])
def test_mixer_on_the_card_matches_cpu(cuda_device, rate):
    dsp = pt.dsp
    x = _cplx(3 * 5000, 1).reshape(3, 5000)
    st = dsp.mixer_init(rate, 0.7)
    got, st_g = dsp.mixer_apply(st, x)
    want, st_w = dsp.mixer_apply(st, x, device="cpu")
    assert got.device.type == "cuda" and st_g == st_w
    assert _rel(got.cpu(), want) <= MIXER_TOL
    (gr, gi), _ = dsp.mixer_apply_split(st, x.real.copy(), x.imag.copy())
    assert max(_rel(gr.cpu(), want.real), _rel(gi.cpu(), want.imag)) <= MIXER_TOL
    x0 = x[0, :4096]
    algos = {  # ALGO C, E and I: the same host carries, the products on each device
        "C": lambda dev: dsp.shift_addfast_cc(x0, dsp.shift_addfast_init(rate), 0.3,
                                              device=dev)[0],
        "E": lambda dev: dsp.shift_limited_unroll_cc(x0, dsp.shift_limited_unroll_init(rate),
                                                     device=dev),
        "I": lambda dev: dsp.shift_recursive_osc_cc(x0, dsp.shift_recursive_osc_init(rate),
                                                    device=dev),
    }
    for name, fn in algos.items():
        assert _rel(fn("cuda").cpu(), fn("cpu")) <= MIXER_TOL, name
    for name in dsp.carrier.__all__:
        assert torch.equal(getattr(dsp, name)(64).cpu(), getattr(dsp, name)(64, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1, 16, 64])
@pytest.mark.parametrize("fmt", ["f", "s16", "cs16", "cu8"])
def test_cic_on_the_card_matches_cpu(cuda_device, factor, fmt):
    rng = np.random.default_rng(factor)
    n = 300 * factor
    x = {"f": _cplx(n, 2), "s16": rng.integers(-32000, 32000, n).astype(np.int16),
         "cs16": rng.integers(-32000, 32000, 2 * n).astype(np.int16),
         "cu8": rng.integers(0, 256, 2 * n).astype(np.uint8)}[fmt]
    per = 1 if fmt in ("f", "s16") else 2
    gpu, cpu = pt.dsp.CicDDC(factor), pt.dsp.CicDDC(factor, device="cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    for half in (slice(0, n // 2 * per), slice(n // 2 * per, n * per)):
        yg, sg = gpu.apply(sg, x[half], 0.1239, fmt)
        yc, sc = cpu.apply(sc, x[half], 0.1239, fmt)
        assert yg.device.type == "cuda" and _rel(yg.cpu(), yc) <= DSP_TOL
    assert sg.phase_fp == sc.phase_fp and _rel(sg.hist_re.cpu(), sc.hist_re) <= DSP_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("taps,dtype", [(129, "float32"), (1024, "float32"), (129, "float64")])
def test_ddc_chain_on_the_card_matches_cpu(cuda_device, taps, dtype):
    h = pt.design_lowpass(taps, 0.5 / 8)
    gpu = pt.DDCChain(-0.1, h, 8, dtype=dtype)
    cpu = pt.DDCChain(-0.1, h, 8, dtype=dtype, device="cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    for j in range(2):
        x = _cplx(1 << 14, 3 + j)
        before = ck.zconv_stream.launches
        yg, sg = gpu.process(sg, x)
        yc, sc = cpu.process(sc, x)
        torch.cuda.synchronize()
        assert ck.zconv_stream.launches - before == (1 if dtype == "float32" else 0)
        assert yg.dtype == yc.dtype and _rel(yg.cpu(), yc) <= DSP_TOL
    assert sg.mixer == sc.mixer and _rel(sg.tail.cpu(), sc.tail) <= DSP_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(1024, 512), (256, 64), (8192, 4096)])
@pytest.mark.parametrize("tmajor", [False, True])
def test_stft_on_the_card_matches_cpu(cuda_device, monkeypatch, n_fft, hop, tmajor):
    sp = pt.spectral
    monkeypatch.setattr(sp, "_TMAJOR_STFT", tmajor)
    x = np.random.default_rng(n_fft).standard_normal((3, 40000)).astype(np.float32)
    gr, gi = sp.stft_split(x, n_fft, hop)
    cr, ci = sp.stft_split(x, n_fft, hop, device="cpu")
    assert gr.device.type == "cuda" and gr.shape == cr.shape
    assert max(_rel(gr.cpu(), cr), _rel(gi.cpu(), ci)) <= DSP_TOL
    tr, ti = sp.stft_split_tmajor(x, n_fft, hop)
    assert _rel(tr.permute(1, 2, 0).cpu(), cr) <= DSP_TOL
    s = torch.complex(gr, gi)
    before = (fs.cfft_fused2.launches, rk.real_split.launches)
    y = sp.istft(s, hop, length=40000)
    torch.cuda.synchronize()
    if n_fft <= 4096:
        assert (fs.cfft_fused2.launches, rk.real_split.launches) > before
    core = slice(n_fft, 40000 - n_fft)
    assert _rel(y[:, core].cpu(), torch.from_numpy(x[:, core])) <= DSP_TOL
    assert _rel(sp.welch_psd(x, n_fft).cpu(), sp.welch_psd(x, n_fft, device="cpu")) <= DSP_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("up,down", [(3, 2), (2, 3), (7, 5)])
def test_resampler_on_the_card_matches_cpu(cuda_device, up, down):
    x = np.random.default_rng(up).standard_normal((4, 30000)).astype(np.float32)
    assert torch.get_float32_matmul_precision() == "highest"
    got = pt.resample.Resampler(up, down, 16)(x)
    want = pt.resample.Resampler(up, down, 16, device="cpu")(x)
    assert got.device.type == "cuda" and _rel(got.cpu(), want) <= DSP_TOL


# ---------------------------------------------------------------------------
# Any-length transforms, N-D, DCT/DST, the partitioned convolution and Fft
# ---------------------------------------------------------------------------


def _launches():
    return (fs.cfft_fused2.launches, rk.real_split.launches, pk.cfft_chain_tmajor.launches,
            pk.cfft_combine_tmajor.launches)


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [97, 4099, 12289])
def test_bluestein_on_the_card_matches_oracle(cuda_device, n):
    """B9 for inner lengths up to 16384 (N = 97, 4099), kern2 behind the
    "tmajor" route above (N = 12289, M = 25600)."""

    plan = pt.new_setup_any(n)
    x = torch.from_numpy(_crand((5, n), n)).to(cuda_device)
    ref = torch.fft.fft(x.to(torch.complex128), dim=-1)
    before = _launches()
    got = pt.transform_ordered(plan, x)
    back = pt.transform_ordered(plan, got, pt.BACKWARD)
    torch.cuda.synchronize()
    delta = [a - b for a, b in zip(_launches(), before)]
    if plan.m <= fs.MAX_N:
        assert delta[0] == 4
    else:
        assert delta[2] == 4 and delta[3] == 4
    assert _rel(got.to(torch.complex128), ref) <= ORACLE_TOL
    assert _rel(back / n, x) <= ORACLE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4099, 101])
def test_rfft_any_on_the_card_matches_cpu(cuda_device, n):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    got = pt.rfft_any(x)
    want = pt.rfft_any(x, device="cpu")
    assert got.device.type == "cuda" and _rel(got.cpu(), want) <= ORACLE_TOL
    assert _rel(pt.irfft_any(got, n).cpu(), pt.irfft_any(want, n)) <= ORACLE_TOL


@pytest.mark.cuda
def test_zoom_and_czt_on_the_card_match_cpu(cuda_device):
    x = np.random.default_rng(7).standard_normal((4, 4096)).astype(np.float32)
    got = pt.zoom_fft(x, (0.2, 0.3), 512)
    want = pt.zoom_fft(x, (0.2, 0.3), 512, device="cpu")
    assert got.device.type == "cuda" and _rel(got.cpu(), want) <= ORACLE_TOL
    plan = pt.CztPlan(53, 29, w_phase=0.013, a_phase=0.21)
    z = _crand((3, 53), 8)
    assert _rel(pt.czt(plan, z).cpu(), pt.czt(plan, z, device="cpu")) <= ORACLE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64, 128), (17, 30)])
def test_fftn_on_the_card_matches_oracle(cuda_device, shape):
    x = torch.from_numpy(_crand(shape, len(shape))).to(cuda_device)
    nd = pt.fftn_setup(shape[-2:])
    gr, gi = pt.fftn_split(nd, (x.real, x.imag))
    ref = torch.fft.fft2(x.to(torch.complex128))
    assert _rel(torch.complex(gr, gi).to(torch.complex128), ref) <= ORACLE_TOL
    got = pt.rfftn(x.real.contiguous())
    assert _rel(got.to(torch.complex128), torch.fft.rfftn(x.real.double())) <= ORACLE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("dct1", 4097), ("dst1", 4095), ("dct2", 4096),
                                    ("dct3", 4096), ("dst2", 97), ("dst3", 60)])
def test_dct_on_the_card_matches_cpu(cuda_device, name, n):
    x = np.random.default_rng(n).standard_normal((8, n)).astype(np.float32)
    before = fs.cfft_fused2.launches
    got = getattr(pt.dct, name)(x)
    torch.cuda.synchronize()
    assert fs.cfft_fused2.launches > before
    want = getattr(pt.dct, name)(x, device="cpu")
    assert got.device.type == "cuda" and _rel(got.cpu(), want) <= ORACLE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("taps,block", [(4096, 512), (48000, 512), (1000, 96)])
def test_pconv_on_the_card_matches_cpu(cuda_device, taps, block):
    """P <= 16 and P > 16; two calls with the state carried; B9 and B6 a
    transform."""

    h = np.random.default_rng(taps).standard_normal(taps).astype(np.float32)
    gpu, cpu = pt.PartitionedConv(h, block), pt.PartitionedConv(h, block, device="cpu")
    x = np.random.default_rng(block).standard_normal((2, 8 * block)).astype(np.float32)
    sg, sc = gpu.init_state((2,)), cpu.init_state((2,))
    for j in range(2):
        chunk = x[:, 4 * j * block:4 * (j + 1) * block]
        before = _launches()
        yg, sg = gpu.process(sg, chunk)
        torch.cuda.synchronize()
        delta = [a - b for a, b in zip(_launches(), before)]
        assert delta[0] == 2 and delta[1] == 2
        yc, sc = cpu.process(sc, chunk)
        assert _rel(yg.cpu(), yc) <= ORACLE_TOL
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(np.float32, 1024), (np.complex64, 4096),
                                     (np.float64, 256), (np.complex128, 96)])
def test_fft_object_on_the_card_matches_transform(cuda_device, dtype, n):
    f = pt.Fft(dtype, n)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((16, n))
    if np.iscomplexobj(np.zeros(1, dtype)):
        x = x + 1j * rng.standard_normal((16, n))
    x = x.astype(dtype)
    spec = f.forward(x)
    assert spec.device.type == "cuda"
    assert torch.equal(spec, pt.transform_ordered(f.plan, x))
    assert _rel(f.inverse(spec).cpu() / n, torch.from_numpy(x)) <= ORACLE_TOL
    assert f.value_vector(2).device.type == "cuda"


# ---------------------------------------------------------------------------
# The SDR capture path: the float64 channelizers (no kernel) and
# StreamingConv on the native ring buffer, on the card against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m,v", [(64, 1), (4096, 1), (1024, 2), (48, 4)])
def test_float64_channelizer_on_the_card_matches_cpu(cuda_device, m, v):
    from pffft_tpu_torch import channelizer as CH
    from pffft_tpu_torch.ops import pfb_kernel as pfb

    def make(dev):
        if v == 1:
            return CH.Channelizer(m, 8, dtype="float64", device=dev)
        return CH.OversampledChannelizer(m, v, 8, dtype="float64", device=dev)

    gpu, cpu = make("cuda"), make("cpu")
    x = np.random.default_rng(m + v).standard_normal((2, 2, 6 * m))
    sg, sc = gpu.init_state((2,)), cpu.init_state((2,))
    for j in range(2):
        c0 = (*_f64_counts(), pfb.pfb_fir_stream_tmajor.launches)
        (gr, gi), sg = gpu.process_split(sg, x[0, :, 3 * j * m:3 * (j + 1) * m],
                                         x[1, :, 3 * j * m:3 * (j + 1) * m])
        torch.cuda.synchronize()
        assert (*_f64_counts(), pfb.pfb_fir_stream_tmajor.launches) == c0
        (cr, ci), sc = cpu.process_split(sc, x[0, :, 3 * j * m:3 * (j + 1) * m],
                                         x[1, :, 3 * j * m:3 * (j + 1) * m])
        assert gr.dtype == torch.float64 and gr.device.type == "cuda"
        assert _rel(torch.complex(gr, gi).cpu(), torch.complex(cr, ci)) <= 1e-12
        assert torch.equal(sg.hist_re.cpu(), sc.hist_re)
    if v == 1:
        (tr, _), _ = gpu.process_split_tmajor(gpu.init_state((2,)), x[0], x[1])
        (br, _), _ = gpu.process_split(gpu.init_state((2,)), x[0], x[1])
        assert _rel(tr.reshape(m, 2, 6).permute(1, 2, 0), br) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [64, 1024])
def test_native_streaming_conv_on_the_card_matches_cpu(cuda_device, taps):
    from pffft_tpu_torch import conv as C
    from pffft_tpu_torch.ops import conv_kernel as ck

    h = pt.design_lowpass(taps, 0.1)
    gpu, cpu = C.StreamingConv(h), C.StreamingConv(h, device="cpu")
    assert gpu.native and cpu.native
    rng = np.random.default_rng(taps)
    x = rng.standard_normal(1 << 18).astype(np.float32)
    before = ck.zconv_tmajor.launches
    outs_g, outs_c, pos = [], [], 0
    while pos < x.size:
        step = int(rng.integers(1, 1 << 15))
        outs_g.append(gpu.push(x[pos:pos + step]))
        outs_c.append(cpu.push(x[pos:pos + step]))
        pos += step
    outs_g.append(gpu.flush())
    outs_c.append(cpu.flush())
    g, c = np.concatenate(outs_g), np.concatenate(outs_c)
    assert ck.zconv_tmajor.launches > before
    assert g.shape == c.shape == (x.size - taps + 1,)
    assert np.abs(g - c).max() <= ORACLE_TOL * np.abs(c).max()


# ---------------------------------------------------------------------------
# The distribution layer on a world of one NCCL rank, measure mode and the
# profiling utilities, on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world of one NCCL rank, started here and destroyed after the
    module's card tests."""

    import datetime

    import torch.distributed as dist
    from pffft_tpu_torch import parallel as pp

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels run only on the card)")
    init = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60),
                            device_id=torch.device("cuda", 0))
    try:
        yield pp.make_mesh(device_type="cuda")
    finally:
        dist.destroy_process_group()


def _launch_counts():
    from pffft_tpu_torch.ops import conv_kernel as ck

    return (pk.cfft_chain_tmajor.launches, pk.cfft_combine_tmajor.launches,
            fs.cfft_fused2.launches, ck.zconv_stream.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(1 << 16, 2), (1 << 22, 1)])
def test_fourstep_on_one_nccl_rank_matches_oracle(nccl_mesh, n, b):
    from pffft_tpu_torch import parallel as pp

    fp = pp.FourStepPlan(n, nccl_mesh)
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.complex(*(torch.randn((b, n), generator=gen, device="cuda") for _ in range(2)))
    c0 = _launch_counts()
    y = fp.forward(pp.shard_batch(x, nccl_mesh, axis=1)).to_local()
    c1 = _launch_counts()
    assert c1[0] > c0[0] and c1[2] > c0[2]  # the columns on B1 (or kern2), rows on B9
    ref = torch.fft.fft(x.to(torch.complex128), dim=-1)
    assert _rel(y.to(torch.complex128), ref) <= ORACLE_TOL
    back = fp.backward(fp.forward(x)).to_local() / n
    assert _rel(back, x) <= ORACLE_TOL
    internal = fp.forward(x, ordered=False)
    assert _rel(fp.reorder(internal).to_local(), y) <= ORACLE_TOL


@pytest.mark.cuda
def test_real_fourstep_on_one_nccl_rank_matches_oracle(nccl_mesh):
    from pffft_tpu_torch import parallel as pp

    n = 1 << 17
    fp = pp.FourStepPlan(n, nccl_mesh, kind=pt.REAL)
    x = torch.randn((2, n), generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda")
    s = fp.forward(x).to_local()
    ref = torch.fft.rfft(x.double(), dim=-1)
    packed = ref[:, :-1].clone()
    packed[:, 0] = torch.complex(ref[:, 0].real, ref[:, -1].real)
    assert _rel(s.to(torch.complex128), packed) <= ORACLE_TOL
    assert _rel(fp.backward(s).to_local() / n, x) <= ORACLE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
def test_pencil2d_on_one_nccl_rank_matches_oracle(nccl_mesh, transposed):
    from pffft_tpu_torch import parallel as pp

    p = pp.Pencil2D((512, 1024), nccl_mesh)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.complex(*(torch.randn((2, 512, 1024), generator=gen, device="cuda")
                        for _ in range(2)))
    s = p.forward(x, transposed=transposed).to_local()
    ref = torch.fft.fft2(x.to(torch.complex128))
    assert _rel(s.to(torch.complex128), ref.transpose(-1, -2) if transposed else ref) \
        <= ORACLE_TOL
    back = p.backward(s, transposed=transposed).to_local() / (512 * 1024)
    assert _rel(back, x) <= ORACLE_TOL


@pytest.mark.cuda
def test_sharded_fastconv_on_one_nccl_rank_equals_local(nccl_mesh):
    from pffft_tpu_torch import conv as C
    from pffft_tpu_torch import parallel as pp

    fc = C.FastConv(pt.design_lowpass(1024, 0.1))
    x = torch.randn((4, 1 << 18), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    c0 = _launch_counts()
    y = pp.sharded_fastconv_valid(fc, x, nccl_mesh).to_local()
    assert _launch_counts()[3] == c0[3] + 1  # one stream-map launch
    local = fc.apply_batched(x)
    assert y.shape == local.shape
    assert _rel(y, local) <= KERNEL_TOL


@pytest.mark.cuda
def test_cuda_tensor_on_a_cpu_mesh_raises():
    from pffft_tpu_torch.parallel import mesh as pm

    class CpuMesh:
        device_type = "cpu"

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with pytest.raises(ValueError, match="cuda tensor given to a cpu mesh"):
        pm.check_device(torch.zeros(4, device="cuda"), CpuMesh())


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,time_major", [(1024, 4096, True), (4096, 1024, True),
                                            (4096, 1024, False)])
def test_tune_engine_on_the_card_records_what_the_public_call_runs(cuda_device, n, b,
                                                                   time_major):
    from pffft_tpu_torch import tune as T

    saved = dict(D._MEASURED_TABLE)
    try:
        winner = T.tune_engine(n, b, time_major=time_major, iters=2, rounds=1)
        assert D._MEASURED_TABLE[(D.capability(cuda_device), n, time_major)] == winner
        plan = pt.new_setup(n)
        assert D.select_engine(plan, b, time_major, cuda_device) == winner
        re, im = _planes(n, b, 5, cuda_device)
        if not time_major:
            re, im = re.T.contiguous(), im.T.contiguous()
        counts = (pk.cfft_chain_tmajor.launches, fs.cfft_fused2.launches)
        call = pt.transform_ordered_split_tmajor if time_major else pt.transform_ordered_split
        call(plan, (re, im), pt.FORWARD)
        torch.cuda.synchronize()
        ran = (pk.cfft_chain_tmajor.launches - counts[0], fs.cfft_fused2.launches - counts[1])
        assert (ran[0] > 0) == (winner in ("chain", "kern2", "tmajor"))
        assert (ran[1] > 0) == (winner == "fused2")
    finally:
        D._MEASURED_TABLE.clear()
        D._MEASURED_TABLE.update(saved)


@pytest.mark.cuda
def test_tuned_setup_on_the_card(cuda_device, monkeypatch, tmp_path):
    from pffft_tpu_torch import tune as T

    monkeypatch.setattr(T, "_MEM_CACHE", {})
    monkeypatch.setenv("PFFFT_TPU_TUNE_CACHE", str(tmp_path / "tune.json"))
    # float32: one kernel runs every candidate, so nothing is timed or cached
    assert T.tuned_setup(4096, batch=256, iters=2) == pt.Plan.create(4096, strict=False)
    assert T._MEM_CACHE == {}
    # float64: the stage engine reads the policy, so the candidates race
    plan = T.tuned_setup(4096, dtype="float64", batch=256, iters=2)
    cap = torch.cuda.get_device_capability(0)
    key = f"cuda-{cap[0]}.{cap[1]}:4096:complex:float64"
    assert list(T._MEM_CACHE) == [key]
    assert plan == T._policy_plan(4096, pt.COMPLEX, "float64", T._MEM_CACHE[key])


@pytest.mark.cuda
def test_profiling_on_the_card(cuda_device, tmp_path):
    from pffft_tpu_torch.utils import profiling as P

    info = P.device_info()
    assert info["platform"] == "gpu" and info["device_kind"] == torch.cuda.get_device_name(0)
    assert info["hbm_bytes_limit"] > 0 and info["cuda_version"] == torch.version.cuda
    re, im = _planes(1024, 4096, 9, cuda_device)
    plan = pt.new_setup(1024)
    with P.trace(str(tmp_path)) as prof:
        pt.transform_ordered_split_tmajor(plan, (re, im), pt.FORWARD)
        torch.cuda.synchronize()
    assert list(tmp_path.glob("*.pt.trace.json"))
    assert any("chain_kernel" in e.key for e in prof.key_averages())


def _launch_total() -> int:
    """Every kernel wrapper's ``.launches``, summed."""

    import sys

    return sum(obj.launches for name, mod in list(sys.modules.items())
               if name.startswith("pffft_tpu_torch.ops.") and mod is not None
               for obj in vars(mod).values()
               if callable(obj) and isinstance(getattr(obj, "launches", None), int)
               and getattr(obj, "__module__", None) == name)


def _fir_chunk(taps, dev):
    fc = pt.FastConv(np.hanning(taps), device=dev)
    x = torch.randn(16, 1 << 16, device=dev)[:, 5:]
    return lambda: fc.apply_batched(x, flush=False)


def _chan_chunk(dev):
    ch = pt.Channelizer(4096, 8, device=dev)
    st = ch.init_state((4,))
    xr, xi = torch.randn(2, 4, 32 * 4096, device=dev).unbind(0)
    return lambda: ch.process_split(st, xr, xi)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fir_taps1024", "chan_bulk", "fir_taps4096"])
def test_launch_spans_hold_their_launches(cuda_device, tmp_path, cell):
    """One chunk of each benchmark entry under ``utils.profiling.trace``: one
    ``pffft.launch`` span a launch the wrappers count, each inside the
    chunk's ``pffft.entry`` and around its own launch call on the CUDA
    runtime, on the profiler's one clock."""

    import json

    from pffft_tpu_torch.utils import profiling as P

    chunk = {"fir_taps1024": lambda: _fir_chunk(1024, cuda_device),
             "chan_bulk": lambda: _chan_chunk(cuda_device),
             "fir_taps4096": lambda: _fir_chunk(4096, cuda_device)}[cell]()
    chunk()  # loads and plans outside the trace
    torch.cuda.synchronize()
    before = _launch_total()
    with P.trace(str(tmp_path)):
        chunk()
        torch.cuda.synchronize()
    launched = _launch_total() - before
    assert launched == {"fir_taps1024": 1, "chan_bulk": 3, "fir_taps4096": 1}[cell]
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e["name"] == "pffft.launch"]
    (entry,) = [e for e in events if e["name"] == "pffft.entry"]
    calls = [e for e in events if str(e.get("cat")).startswith("cuda_")
             and "LaunchKernel" in e["name"]]
    assert len(spans) == launched

    def inside(e, outer):
        return (outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
                and e["tid"] == outer["tid"])

    for s in spans:
        assert inside(s, entry)
        assert len([c for c in calls if inside(c, s)]) == 1, s


# ---------------------------------------------------------------------------
# Gradients through the kernels: the backward of each autograd Function
# against torch autograd through the plain versions (KERNEL_TOL) and, for
# the transforms, complex128 torch.fft autograd (ORACLE_TOL)
# ---------------------------------------------------------------------------

from pffft_tpu_torch.ops import _grad  # noqa: E402

# every kernel wrapper a gradient path runs, and its plain version
_PLAIN = {
    (pk, "cfft_chain_tmajor"): lambda plan, re, im, *, backward=False, tb=None, elems=None:
        pk.chain_tmajor_plain(plan, re, im, backward=backward),
    (pk, "cfft_combine_tmajor"): lambda last, re, im, *, backward=False:
        pk.combine_tmajor_plain(last, re, im, backward=backward),
    (pk, "cfft_chain_tmajor_packed"): lambda plan, y, *, slabs=1, tb=None, elems=None:
        pk.chain_tmajor_packed_plain(plan, y, slabs=slabs),
    (pk, "rfft_chain_tmajor_fused"): lambda plan, y, tw, *, tb=None, elems=None:
        pk.rfft_chain_tmajor_fused_plain(plan, y, tw),
    (pk, "rfft_bwd_chain_tmajor_fused"): lambda plan, sr, si, tw, *, tb=None, elems=None:
        pk.rfft_bwd_chain_tmajor_fused_plain(plan, sr, si, tw),
    (pk, "real_split_tmajor"): lambda zr, zi, tw, *, backward=False:
        pk.real_split_tmajor_plain(zr, zi, tw, backward=backward),
    (fs, "cfft_fused2"): lambda plan, re, im, *, backward=False, ordered=True:
        fs.cfft_fused2_plain(plan, re, im, backward=backward, ordered=ordered),
    (rk, "real_split"): lambda zr, zi, tw, *, backward=False:
        rk.real_split_plain(zr, zi, tw, backward=backward),
    (ck, "zconv_tmajor"): lambda plan, re, im, hfr, hfi, *, tb=None, elems=None:
        ck.zconv_tmajor_plain(plan, re, im, hfr, hfi),
    (ck, "zconv_stream"): lambda plan, x, hfr, hfi, u, total, adjoint=None:
        ck.zconv_stream_plain(plan, x, hfr, hfi, u, total),
    (pfb, "pfb_fir"): lambda rows, w, k: pfb.pfb_fir_plain(rows, w, k),
    (pfb, "pfb_fir_stream_tmajor"): lambda hist, x, w, k, offset=0, warps=None:
        pfb.pfb_fir_stream_tmajor_plain(hist, x, w, k, offset),
}


def _grad_launches():
    return {name: getattr(mod, name).launches for mod, name in _PLAIN}


def _hold_gradient(fn, xs, monkeypatch, want, oracle=None, seed=0):
    """The gradient of fn at xs through the kernels: within KERNEL_TOL of
    autograd through the plain versions (no Function entered) and of
    ``oracle`` (complex128 torch.fft) within ORACLE_TOL; the backward
    launches every wrapper of ``want``."""

    xs = [x.detach().requires_grad_(True) for x in xs]
    ys = fn(*xs)
    gen = torch.Generator(device=xs[0].device).manual_seed(seed)
    gs = [torch.randn(y.shape, generator=gen, device=y.device) for y in ys]
    before = _grad_launches()
    grads = torch.autograd.grad(ys, xs, gs)
    torch.cuda.synchronize()
    after = _grad_launches()
    assert all(after[w] > before[w] for w in want), (before, after)
    with monkeypatch.context() as mp:
        for (mod, name), plain in _PLAIN.items():
            mp.setattr(mod, name, plain)
        mp.setattr(_grad, "needed", lambda *ts: False)
        xp = [x.detach().clone().requires_grad_(True) for x in xs]
        plain = torch.autograd.grad(fn(*xp), xp, gs)
    scale = max(float(p.abs().max()) for p in plain)
    assert max(float((g - p).abs().max()) for g, p in zip(grads, plain)) <= KERNEL_TOL * scale
    if oracle is not None:
        xo = [x.detach().double().requires_grad_(True) for x in xs]
        ref = torch.autograd.grad(oracle(*xo), xo, [g.double() for g in gs])
        scale = max(float(r.abs().max()) for r in ref)
        assert max(float((g - r).abs().max()) for g, r in zip(grads, ref)) <= ORACLE_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,time_major,want", [
    (1024, 256, True, ("cfft_chain_tmajor",)),
    (4096, 16, True, ("cfft_chain_tmajor", "cfft_combine_tmajor")),
    (1024, 64, False, ("cfft_fused2",))])
@pytest.mark.parametrize("backward", [False, True])
def test_complex_transform_gradient_on_the_card(cuda_device, monkeypatch, n, b, time_major,
                                                want, backward):
    plan = pt.new_setup(n)
    dim = 0 if time_major else -1
    re, im = _planes(n, b, n + b, cuda_device)
    if not time_major:
        re, im = re.T.contiguous(), im.T.contiguous()
    call = pt.transform_ordered_split_tmajor if time_major else pt.transform_ordered_split
    d = pt.BACKWARD if backward else pt.FORWARD

    def oracle(a, c):
        z = torch.complex(a, c)
        y = torch.fft.ifft(z, dim=dim) * n if backward else torch.fft.fft(z, dim=dim)
        return y.real, y.imag

    _hold_gradient(lambda a, c: call(plan, (a, c), d), (re, im), monkeypatch, want, oracle)


def _packed_rfft(x, dim):
    f = torch.fft.rfft(x, dim=dim).movedim(dim, -1)
    h = f.shape[-1] - 1
    sr = torch.cat([f[..., :1].real, f[..., 1:h].real], -1)
    si = torch.cat([f[..., h:].real, f[..., 1:h].imag], -1)
    return sr.movedim(-1, dim), si.movedim(-1, dim)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,time_major,want_fwd,want_bwd", [
    (1024, 256, True, ("rfft_bwd_chain_tmajor_fused",), ("rfft_chain_tmajor_fused",)),
    (8192, 16, True, ("real_split_tmajor", "cfft_chain_tmajor", "cfft_combine_tmajor"),
     ("cfft_chain_tmajor_packed", "cfft_combine_tmajor", "real_split_tmajor")),
    (1024, 64, False, ("cfft_fused2", "real_split"), ("cfft_fused2", "real_split"))])
def test_real_transform_gradient_on_the_card(cuda_device, monkeypatch, n, b, time_major,
                                             want_fwd, want_bwd):
    """Both directions: the forward's gradient runs the real backward (on
    D*g), the backward's the real forward (then D^-1)."""

    plan = pt.new_setup(n, pt.REAL)
    dim = 0 if time_major else -1
    call = pt.transform_ordered_split_tmajor if time_major else pt.transform_ordered_split
    x = _planes(n, b, n, cuda_device)[0]
    if not time_major:
        x = x.T.contiguous()
    _hold_gradient(lambda v: call(plan, v), (x,), monkeypatch, want_fwd,
                   lambda v: _packed_rfft(v, dim))
    sr, si = call(plan, x)

    def inverse(a, c):  # complex128 irfft of the packed planes, unscaled
        a, c = a.movedim(dim, -1), c.movedim(dim, -1)
        zero = torch.zeros_like(c[..., :1])
        z = torch.complex(torch.cat([a, c[..., :1]], -1), torch.cat([zero, c[..., 1:], zero], -1))
        return (torch.fft.irfft(z, n=n, dim=-1).movedim(-1, dim) * n,)

    _hold_gradient(lambda a, c: (call(plan, (a, c), pt.BACKWARD),), (sr, si), monkeypatch,
                   want_bwd, inverse)


@pytest.mark.cuda
@pytest.mark.parametrize("taps,flags,force,want", [
    (64, tc.ConvFlags.NONE, None, ("zconv_stream",)),
    (40, tc.ConvFlags.CPLX_INP_OUT | tc.ConvFlags.CPLX_FILTER, None, ("zconv_stream",)),
    (4096, tc.ConvFlags.NONE, None, ("zconv_stream",)),
    (1100, tc.ConvFlags.NONE, "tmajor", ("cfft_chain_tmajor", "cfft_combine_tmajor"))])
def test_fastconv_gradient_on_the_card(cuda_device, monkeypatch, taps, flags, force, want):
    """B7's stream map (the reversed, conjugated taps' spectrum over the
    padded gradient) up to nfft 16384, and the "tmajor" route forced past
    nfft 2048."""

    rng = np.random.default_rng(taps)
    h = rng.standard_normal(taps)
    if flags & tc.ConvFlags.CPLX_FILTER:
        h = h + 1j * rng.standard_normal(taps)
    fc = tc.FastConv(h, flags=flags)
    fc._force_conv_kernel = force
    xr, xi = _planes(3, 20001, taps, cuda_device)
    if flags & tc.ConvFlags.CPLX_INP_OUT:
        fn = lambda a, c: (torch.view_as_real(fc.apply_batched(torch.complex(a, c))),)
        _hold_gradient(fn, (xr, xi), monkeypatch, want)
    else:
        _hold_gradient(lambda a: (fc.apply_batched(a),), (xr,), monkeypatch, want)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [64, 4096])
def test_fastconv_gradient_through_a_strided_view(cuda_device, monkeypatch, taps):
    """The gradient with respect to a slice of wider rows, whose forward the
    stream map reads in place, against plain autograd."""

    fc = tc.FastConv(np.random.default_rng(taps).standard_normal(taps))
    x = _planes(3, 30001, taps, cuda_device)[0][:, 11:20011]
    before = prof.counters.get(prof.STRIDED_READS, 0)
    _hold_gradient(lambda a: (fc.apply_batched(a),), (x,), monkeypatch, ("zconv_stream",))
    assert prof.counters.get(prof.STRIDED_READS, 0) == before + 1


@pytest.mark.cuda
def test_streaming_conv_gradient_on_the_card(cuda_device, monkeypatch):
    """A push's frames through B7's column map (its backward: the conjugate
    spectrum), an odd frame count."""

    sc = tc.StreamingConv(np.hanning(100))
    frames = _planes(37, sc.setup.nfft, 3, cuda_device)[0]
    _hold_gradient(lambda f: (sc._filter(f),), (frames,), monkeypatch, ("zconv_tmajor",))


@pytest.mark.cuda
@pytest.mark.parametrize("m,p,k,v", [(256, 8, 32, 1), (1000, 4, 3, 1), (512, 8, 16, 2)])
def test_channelizer_gradient_on_the_card(cuda_device, monkeypatch, m, p, k, v):
    """B8's stream map (its backward: the identity maps on the padded
    gradient rows) and the transform over the phases, with gradients for
    the chunk and the history; K < P; the oversampled step's two residues."""

    ch = (tch.Channelizer(m, p) if v == 1 else tch.OversampledChannelizer(m, v, p))
    hr, hi = _planes(2, p * m, m, cuda_device)
    xr, xi = _planes(2, k * m, m + 1, cuda_device)

    def step(a, c, d, e):
        return ch.process_split(tch.ChannelizerState(a, c), d, e)[0]

    _hold_gradient(step, (hr, hi, xr, xi), monkeypatch, ("pfb_fir", "cfft_chain_tmajor"))


@pytest.mark.cuda
def test_pfb_fir_gradient_on_the_card(cuda_device, monkeypatch):
    rows = torch.randn((3, 47, 128), device=cuda_device)
    w = torch.randn((8, 128), device=cuda_device)
    _hold_gradient(lambda r: (pfb.pfb_fir(r, w, 40),), (rows,), monkeypatch, ("pfb_fir",))


@pytest.mark.cuda
def test_no_grad_runs_no_function_on_the_card(cuda_device):
    plan = pt.new_setup(1024, pt.REAL)
    x = _planes(1024, 64, 1, cuda_device)[0].requires_grad_(True)
    with torch.no_grad():
        sr, si = pt.transform_ordered_split_tmajor(plan, x)
    assert sr.grad_fn is None and si.grad_fn is None
    sr, si = pt.transform_ordered_split_tmajor(plan, x)
    assert type(sr.grad_fn).__name__ == "_RealForwardBackward"
