"""The port's partitioned convolution, pffft_tpu_torch.pconv, against
pffft_tpu.pconv on the same seeded numpy inputs: across chunks at both of
the reference's accumulation regimes (P <= 16 and P > 16), with the state
handed over from the reference mid-stream, batched channels, float64, the
partition spectra and the errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pffft_tpu.pconv import PartitionedConv as RefConv
import pffft_tpu_torch as pt
from pffft_tpu_torch import pconv as tpc

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-5       # f32, relative to max|ref|
TOL64 = 1e-12    # f64
SPEC_TOL = 1e-6  # partition spectra, relative to their max


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max() / max(1.0, np.abs(ref).max()))


def _stream_ref(x, h):
    return np.convolve(np.asarray(x, np.float64), np.asarray(h, np.float64))[: np.shape(x)[-1]]


@pytest.mark.parametrize("taps,block", [
    (37, 16),         # P = 3
    (129, 128),       # P = 2, one tap spills
    (1000, 128),      # P = 8
    (4096, 256),      # P = 16, the reference's last one-contraction P
    (4097, 256),      # P = 17, the reference's partition loop
    (100_000, 1024),  # P = 98
])
def test_matches_reference_across_chunks(taps, block):
    h = _x(taps, taps)
    tp, rp = pt.PartitionedConv(h, block_len=block, device=CPU), RefConv(h, block_len=block)
    assert tp.parts == rp.parts and tp.nfft == rp.nfft
    x = _x(8 * block, block)
    st, rst = tp.init_state(), rp.init_state()
    ys, rys = [], []
    for a, b in ((0, 3), (3, 8)):
        y, st = tp.process(st, x[a * block:b * block])
        ry, rst = rp.process(rst, jnp.asarray(x[a * block:b * block]))
        ys.append(y)
        rys.append(np.asarray(ry))
        assert y.dtype == torch.float32
        assert _rel(y, rys[-1]) <= TOL
    y = torch.cat(ys)
    assert _rel(y, _stream_ref(x, h)) <= TOL
    for s, r in zip(st, rst):
        assert tuple(s.shape) == tuple(r.shape)


@pytest.mark.parametrize("taps,block", [(1000, 128), (4500, 256)])  # P = 8 and P = 18
def test_state_handed_over_from_reference(taps, block):
    """A stream started in pffft_tpu carries on in the port: the
    reference's (sr, si, tail) as numpy arrays, directly or through
    state_from_arrays."""

    h = _x(taps, taps + 1)
    x = _x((2, 6 * block), block + 1)
    rp = RefConv(h, block_len=block)
    _, rst = rp.process(rp.init_state((2,)), jnp.asarray(x[:, :2 * block]))
    want, _ = rp.process(rst, jnp.asarray(x[:, 2 * block:]))
    tp = pt.PartitionedConv(h, block_len=block, device=CPU)
    arrays = tuple(np.asarray(a) for a in rst)
    got, _ = tp.process(arrays, x[:, 2 * block:])
    assert _rel(got, want) <= TOL
    st = tpc.state_from_arrays(*arrays, device=CPU)
    assert all(isinstance(a, torch.Tensor) and a.dtype == torch.float32 for a in st)
    got2, _ = tp.process(st, x[:, 2 * block:])
    assert torch.equal(got, got2)


@pytest.mark.parametrize("taps,block", [(37, 16), (4096, 256), (100_000, 1024)])
def test_partition_spectra_match_reference(taps, block):
    h = _x(taps, taps + 2)
    tp, rp = pt.PartitionedConv(h, block_len=block, device=CPU), RefConv(h, block_len=block)
    scale = max(np.abs(np.asarray(a)).max() for a in rp._h)
    for t, r in zip(tp._h, rp._h):
        assert t.dtype == np.float32 and t.shape == np.asarray(r).shape
        assert np.abs(t - np.asarray(r)).max() <= SPEC_TOL * scale


def test_state_continuity_vs_oneshot():
    h = _x(777, 5)
    pc = pt.PartitionedConv(h, block_len=128, device=CPU)
    x = _x(1280, 6)
    yo, _ = pc.process(pc.init_state(), x)
    st = pc.init_state()
    parts = []
    for i in range(0, 1280, 256):
        yi, st = pc.process(st, x[i:i + 256])
        parts.append(yi)
    assert (torch.cat(parts) - yo).abs().max() < 2e-6 * max(1.0, float(yo.abs().max()))


def test_batched_channels():
    h = _x(700, 7)
    pc, rp = pt.PartitionedConv(h, block_len=256, device=CPU), RefConv(h, block_len=256)
    x = _x((3, 1024), 8)
    y, st = pc.process(pc.init_state((3,)), x)
    ry, _ = rp.process(rp.init_state((3,)), jnp.asarray(x))
    assert y.shape == (3, 1024) and _rel(y, ry) <= TOL
    assert _rel(y, np.stack([_stream_ref(r, h) for r in x])) <= TOL


def test_latency_and_shapes():
    pc = pt.PartitionedConv(np.ones(5000, np.float32), block_len=512, device=CPU)
    rp = RefConv(np.ones(5000, np.float32), block_len=512)
    assert pc.latency == rp.latency == 512
    assert pc.parts == rp.parts == -(-5000 // 512)
    sr, si, tail = pc.init_state((2,))
    for t, r in zip((sr, si, tail), rp.init_state((2,))):
        assert tuple(t.shape) == tuple(r.shape) and t.device.type == "cpu"
    assert sr.shape == (2, pc.parts - 1, pc.nfft // 2) and tail.shape == (2, 512)


def test_matches_fastconv_stream():
    """Same math as FastConv (shifted by its valid-mode start):
    partitioned[n] == fastconv_valid[n - (L-1)]."""

    h = _x(257, 9)
    x = _x(4096, 10)
    pc = pt.PartitionedConv(h, block_len=256, device=CPU)
    y, _ = pc.process(pc.init_state(), x)
    yv = pt.fastconv_valid(x, h, device=CPU)
    got = y.numpy()[len(h) - 1:]
    assert np.abs(got - yv.numpy()).max() < 2e-4 * max(1.0, float(yv.abs().max()))


def test_error_paths_match_reference():
    for args, kw in (([[]], {}), ([[1.0]], {"block_len": 1})):
        with pytest.raises(ValueError) as te:
            pt.PartitionedConv(*args, device=CPU, **kw)
        with pytest.raises(ValueError) as rf:
            RefConv(*args, **kw)
        assert str(te.value) == str(rf.value)
    pc = pt.PartitionedConv(np.ones(10, np.float32), block_len=16, device=CPU)
    rp = RefConv(np.ones(10, np.float32), block_len=16)
    for n in (17, 0):
        with pytest.raises(ValueError, match="multiple") as te:
            pc.process(pc.init_state(), np.ones(n, np.float32))
        with pytest.raises(ValueError) as rf:
            rp.process(rp.init_state(), jnp.ones(n, jnp.float32))
        assert str(te.value) == str(rf.value)


def test_dtype_float64():
    rng = np.random.default_rng(99)
    h = rng.standard_normal(300)
    x = rng.standard_normal(640)
    pc, rp = (pt.PartitionedConv(h, block_len=64, dtype="float64", device=CPU),
              RefConv(h, block_len=64, dtype="float64"))
    y, _ = pc.process(pc.init_state(), x)
    ry, _ = rp.process(rp.init_state(), jnp.asarray(x))
    assert y.dtype == torch.float64
    assert float(np.abs(y.numpy() - np.asarray(ry)).max() / np.abs(ry).max()) <= TOL64
    ref = _stream_ref(x, h)
    assert float(np.abs(y.numpy() - ref).max() / np.abs(ref).max()) < 1e-13


def test_caller_buffer_refill_does_not_change_state():
    h = _x(300, 11)
    pc = pt.PartitionedConv(h, block_len=64, device=CPU)
    x = torch.from_numpy(_x(256, 12))
    _, st = pc.process(pc.init_state(), x)
    keep = st.tail.clone()
    x.zero_()
    assert torch.equal(st.tail, keep)
