"""The port's polyphase channelizers, pffft_tpu_torch.channelizer, and the
polyphase FIR kernel's plain versions, against pffft_tpu on the same numpy
inputs, including a reference state carried into the port mid-stream.

On the CPU the kernel wrappers run their plain versions; the reference's
Pallas kernel runs in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pffft_tpu import channelizer as rch
from pffft_tpu.ops import pfb_kernel as rpfb
import pffft_tpu_torch as pt
from pffft_tpu_torch import channelizer as tch
from pffft_tpu_torch.ops import pfb_kernel as tpfb

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
# relative to max|ref|: f32 polyphase sums and FFTs on both sides, in
# another order (and through another FFT engine) on each
TOL = 1e-5
SHAPES = [(8, 4), (16, 8), (12, 6), (64, 4)]


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _stream(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pair(m, p):
    """The reference channelizer and the port's, on the reference's weights."""

    ref = rch.Channelizer(m, p)
    return ref, tch.Channelizer.from_weights(np.asarray(ref.weights), device=CPU)


# ---------------------------------------------------------------------------
# The polyphase FIR's plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "k,p,m,lead",
    [(16, 8, 128, ()), (64, 8, 256, (3,)), (24, 4, 384, (2, 2)), (128, 12, 128, (1,)),
     (8, 1, 128, ())],
)
def test_pfb_fir_matches_reference_kernel(k, p, m, lead):
    rng = np.random.default_rng(k * 1000 + p * 10 + m)
    q = k + p - 1 + int(rng.integers(0, 3))  # extra tail rows are ignored
    rows = rng.standard_normal((*lead, q, m)).astype(np.float32)
    w = rng.standard_normal((p, m)).astype(np.float32)
    want = np.asarray(rpfb.pfb_fir(jnp.asarray(rows), jnp.asarray(w), k, interpret=True))
    rt, wt = torch.from_numpy(rows), torch.from_numpy(w)
    for got in (tpfb.pfb_fir_plain(rt, wt, k), tpfb.pfb_fir(rt, wt, k)):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= 4e-6  # the reference test's own bound


def _ref_polyphase(ref, hist, chunk, k, offset=0):
    """The reference's time-major polyphase of one plane on ext = [hist,
    chunk] read from ``offset`` (zeros past the end, as its oversampled
    channelizer pads), as v [M, R*K]."""

    ext = np.concatenate([hist, chunk], axis=-1)
    if offset:
        ext = np.concatenate([ext[..., offset:], np.zeros((*ext.shape[:-1], offset),
                                                          np.float32)], axis=-1)
    return np.asarray(ref._polyphase_tmajor(jnp.asarray(ext), k)).reshape(ref.m, -1)


def _stream_planes(lead, p, k, m, seed):
    """(hist, chunk) pairs of seeded planes: hist [..., P*M], chunk [..., K*M]."""

    rng = np.random.default_rng(seed)
    return tuple(tuple(rng.standard_normal((*lead, n)).astype(np.float32) for _ in range(2))
                 for n in (p * m, k * m))


@pytest.mark.parametrize("m,p", SHAPES)
@pytest.mark.parametrize("lead", [(), (3,)])
def test_pfb_stream_map_matches_reference_polyphase(m, p, lead):
    """The channelizer's stream map on both planes: v[phi, r*K + k] from the
    history and the chunk read as one stream, equal to the reference's
    time-major polyphase (``_polyphase_tmajor``) on the concatenated stream."""

    k = 6
    ref = rch.Channelizer(m, p)
    hist, chunk = _stream_planes(lead, p, k, m, m + p)
    want = [_ref_polyphase(ref, h, c, k) for h, c in zip(hist, chunk)]
    w = torch.from_numpy(np.array(ref.weights))
    ht, ct = (tuple(torch.from_numpy(a) for a in pair) for pair in (hist, chunk))
    for got in (tpfb.pfb_fir_stream_tmajor_plain(ht, ct, w, k),
                tpfb.pfb_fir_stream_tmajor(ht, ct, w, k)):
        for g, wv in zip(got, want, strict=True):
            assert g.shape == (m, max(1, int(np.prod(lead))) * k)
            assert _rel(g.numpy(), wv) <= 4e-6


@pytest.mark.parametrize("m,p,k,lead", [
    (16, 4, 6, (2,)),      # K >= P
    (16, 8, 3, (2,)),      # K < P: most of the window in the history
    (12, 6, 1, (2, 2)),    # one frame, two leading dims
    (8, 33, 4, (3,)),      # P > 32: the kernel's plain loop
    (8, 33, 40, ()),
])
@pytest.mark.parametrize("hop", [0, 1, 2])  # offset 0, H = M/2, H = M/4
def test_pfb_stream_twin_matches_reference_at_offsets(m, p, k, lead, hop):
    """The two-plane, two-pointer plain twin (and the wrapper, which runs it
    on the CPU) against the reference's polyphase step on the stream read
    from offset r*H, as its oversampled channelizer reads it."""

    ref = rch.Channelizer(m, p)
    off = 0 if hop == 0 else (m // 2 if hop == 1 else m // 4)
    hist, chunk = _stream_planes(lead, p, k, m, 100 * m + 10 * p + k)
    want = [_ref_polyphase(ref, h, c, k, off) for h, c in zip(hist, chunk)]
    w = torch.from_numpy(np.array(ref.weights))
    ht, ct = (tuple(torch.from_numpy(a) for a in pair) for pair in (hist, chunk))
    before = tpfb.pfb_fir_stream_tmajor.launches
    for got in (tpfb.pfb_fir_stream_tmajor_plain(ht, ct, w, k, off),
                tpfb.pfb_fir_stream_tmajor(ht, ct, w, k, off)):
        assert len(got) == 2
        for g, wv in zip(got, want, strict=True):
            assert g.shape == (m, max(1, int(np.prod(lead))) * k)
            assert _rel(g.numpy(), wv) <= 4e-6
    assert tpfb.pfb_fir_stream_tmajor.launches == before  # the CPU launches nothing


def test_pfb_wrappers_reject_bad_arguments():
    w = torch.ones((4, 16))
    with pytest.raises(ValueError, match="K \\+ P - 1"):
        tpfb.pfb_fir(torch.ones((10, 16)), w, 8)
    with pytest.raises(ValueError, match="columns"):
        tpfb.pfb_fir(torch.ones((20, 8)), w, 8)
    with pytest.raises(ValueError, match=r"\[P, M\]"):
        tpfb.pfb_fir(torch.ones((20, 16)), torch.ones(16), 8)
    hist = (torch.zeros(64), torch.zeros(64))
    with pytest.raises(ValueError, match="stream length"):
        tpfb.pfb_fir_stream_tmajor(hist, (torch.ones(16 * 6), torch.ones(16 * 6)), w, 8)
    with pytest.raises(ValueError, match="history length"):
        tpfb.pfb_fir_stream_tmajor((torch.zeros(48), torch.zeros(48)),
                                   (torch.ones(128), torch.ones(128)), w, 8)
    with pytest.raises(ValueError, match="leading dims"):
        tpfb.pfb_fir_stream_tmajor(hist, (torch.ones(128), torch.ones((2, 128))), w, 8)
    with pytest.raises(ValueError, match="offset"):
        tpfb.pfb_fir_stream_tmajor(hist, (torch.ones(128), torch.ones(128)), w, 8, -1)
    before = (tpfb.pfb_fir.launches, tpfb.pfb_fir_stream_tmajor.launches)
    # the CPU launches nothing
    tpfb.pfb_fir_stream_tmajor(hist, (torch.ones(128), torch.ones(128)), w, 8)
    assert (tpfb.pfb_fir.launches, tpfb.pfb_fir_stream_tmajor.launches) == before


# ---------------------------------------------------------------------------
# Channelizer against the reference
# ---------------------------------------------------------------------------


def test_design_lowpass_is_bit_exact():
    for taps, cut, win in ((32, 0.0625, "hamming"), (63, 0.1, "blackman"), (17, 0.2, "rect")):
        assert np.array_equal(tch.design_lowpass(taps, cut, win),
                              rch.design_lowpass(taps, cut, win))
    with pytest.raises(ValueError, match="window"):
        tch.design_lowpass(8, 0.1, "kaiser")


@pytest.mark.parametrize("m,p", SHAPES)
@pytest.mark.parametrize("lead", [(), (3,)])
def test_channelizer_matches_reference(m, p, lead):
    ref, ch = _pair(m, p)
    x = _stream((*lead, 8 * m), m * p)
    xj = jnp.asarray(x)
    want, rst = ref.process(ref.init_state(lead), xj)
    got, st = ch.process(ch.init_state(lead), x)
    assert got.shape == want.shape == (*lead, 8, m) and got.dtype == torch.complex64
    assert _rel(got.numpy(), want) <= TOL
    np.testing.assert_array_equal(st.hist_re.numpy(), np.asarray(rst.hist_re))
    (wr, wi), _ = ref.process_split(ref.init_state(lead), jnp.real(xj), jnp.imag(xj))
    (gr, gi), _ = ch.process_split(ch.init_state(lead), x.real, x.imag)
    assert _rel(gr.numpy(), wr) <= TOL and _rel(gi.numpy(), wi) <= TOL


@pytest.mark.parametrize("m,p", SHAPES)
def test_streaming_continues_from_a_reference_state(m, p):
    """A reference state carried into the port mid-stream: the port goes on
    exactly as the reference does."""

    ref, ch = _pair(m, p)
    lead = (2,)
    x1, x2, x3 = (_stream((*lead, 4 * m), m + i) for i in range(3))
    _, rst = ref.process(ref.init_state(lead), jnp.asarray(x1))
    want2, rst = ref.process(rst, jnp.asarray(x2))
    want3, _ = ref.process(rst, jnp.asarray(x3))
    _, rst1 = ref.process(ref.init_state(lead), jnp.asarray(x1))
    st = tch.state_from_arrays(np.asarray(rst1.hist_re), np.asarray(rst1.hist_im), CPU)
    got2, st = ch.process(st, x2)
    got3, _ = ch.process(st, x3)
    assert _rel(got2.numpy(), want2) <= TOL
    assert _rel(got3.numpy(), want3) <= TOL


@pytest.mark.parametrize("frames", [1, 3, 8, 11])
def test_short_and_long_chunks_match_reference_outputs_and_states(frames):
    """Chunks of K < P frames (the state a concatenation of the history's
    tail and the chunk) and K >= P (a copy of the chunk's tail) over three
    steps: outputs and states as the reference's."""

    m, p, lead = 16, 8, (2,)
    ref, ch = _pair(m, p)
    rst, st = ref.init_state(lead), ch.init_state(lead)
    for step in range(3):
        x = _stream((*lead, frames * m), 50 + 7 * frames + step)
        want, rst = ref.process(rst, jnp.asarray(x))
        got, st = ch.process(st, x)
        assert got.shape == want.shape == (*lead, frames, m)
        assert _rel(got.numpy(), want) <= TOL
        assert st.hist_re.shape == (*lead, p * m)
        np.testing.assert_array_equal(st.hist_re.numpy(), np.asarray(rst.hist_re))
        np.testing.assert_array_equal(st.hist_im.numpy(), np.asarray(rst.hist_im))


@pytest.mark.parametrize("buffer", ["numpy", "tensor"])
@pytest.mark.parametrize("frames", [3, 8])
def test_refilled_input_buffer_leaves_the_state_alone(buffer, frames):
    """A caller that refills one input buffer each step (K < P and K >= P):
    the state it got back, and the next step's output, are the reference's."""

    m, p, lead = 16, 8, (2,)
    ref, ch = _pair(m, p)
    rst, st = ref.init_state(lead), ch.init_state(lead)
    br = np.zeros((*lead, frames * m), np.float32)
    bi = np.zeros_like(br)
    if buffer == "tensor":
        br, bi = torch.from_numpy(br), torch.from_numpy(bi)
    for step in range(3):
        x = _stream((*lead, frames * m), 90 + 7 * frames + step)
        br[...] = torch.from_numpy(x.real) if buffer == "tensor" else x.real
        bi[...] = torch.from_numpy(x.imag) if buffer == "tensor" else x.imag
        (wr, wi), rst = ref.process_split(rst, jnp.asarray(x.real), jnp.asarray(x.imag))
        (gr, gi), st = ch.process_split(st, br, bi)
        br[...] = 0.0  # the caller reuses its buffer before the next step
        bi[...] = 0.0
        assert _rel(gr.numpy(), wr) <= TOL and _rel(gi.numpy(), wi) <= TOL
        np.testing.assert_array_equal(st.hist_re.numpy(), np.asarray(rst.hist_re))
        np.testing.assert_array_equal(st.hist_im.numpy(), np.asarray(rst.hist_im))


def test_chunk_slices_of_wider_rows_are_read_in_place():
    """Planes that are slices of wider rows (a row stride above their
    length) give what their contiguous copies give, and the state is the
    chunk's tail."""

    _, ch = _pair(16, 4)
    rng = np.random.default_rng(3)
    wide_r = torch.from_numpy(rng.standard_normal((3, 16 * 20)).astype(np.float32))
    wide_i = torch.from_numpy(rng.standard_normal((3, 16 * 20)).astype(np.float32))
    xr, xi = wide_r[:, 16:16 * 9], wide_i[:, 16:16 * 9]
    (yr, yi), st = ch.process_split(ch.init_state((3,)), xr, xi)
    (cr, ci), cst = ch.process_split(ch.init_state((3,)), xr.contiguous(), xi.contiguous())
    assert torch.equal(yr, cr) and torch.equal(yi, ci)
    assert torch.equal(st.hist_re, cst.hist_re) and torch.equal(st.hist_im, xi[:, -64:])


def test_two_chunks_equal_one():
    _, ch = _pair(16, 8)
    x = _stream((2, 16 * 12), 4)
    y1, st = ch.process(ch.init_state((2,)), x[:, : 16 * 5])
    y2, _ = ch.process(st, x[:, 16 * 5:])
    yall, _ = ch.process(ch.init_state((2,)), x)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=-2).numpy(), yall.numpy(), atol=1e-6)


def test_tmajor_entry_layout():
    ref, ch = _pair(16, 4)
    rng = np.random.default_rng(12)
    xr = rng.standard_normal((3, 8 * 16)).astype(np.float32)
    xi = rng.standard_normal((3, 8 * 16)).astype(np.float32)
    (yr, yi), st = ch.process_split_tmajor(ch.init_state((3,)), xr, xi)
    assert yr.shape == (16, 3 * 8)  # [M, B*K], frame-fastest
    (br, bi), st2 = ch.process_split(ch.init_state((3,)), xr, xi)
    np.testing.assert_array_equal(yr.reshape(16, 3, 8).permute(1, 2, 0).numpy(), br.numpy())
    np.testing.assert_array_equal(yi.reshape(16, 3, 8).permute(1, 2, 0).numpy(), bi.numpy())
    assert torch.equal(st.hist_im, st2.hist_im)
    (wr, _), _ = ref.process_split_tmajor(ref.init_state((3,)), jnp.asarray(xr), jnp.asarray(xi))
    assert _rel(yr.numpy(), wr) <= TOL


def test_one_shot_and_default_prototype_match_reference():
    ref = rch.Channelizer(16, 8)
    ch = tch.Channelizer(16, 8, device=CPU)
    np.testing.assert_array_equal(ch.weights, np.asarray(ref.weights))
    x = _stream((16 * 10,), 7)
    assert _rel(ch.one_shot(x).numpy(), ref.one_shot(x)) <= TOL
    assert _rel(ch.one_shot(torch.from_numpy(x)).numpy(), ref.one_shot(x)) <= TOL


@pytest.mark.parametrize("m,v", [(16, 2), (16, 4), (12, 3)])
def test_oversampled_matches_reference(m, v):
    p = 4
    h = rch.design_lowpass(p * m, 0.5 / m)
    ref = rch.OversampledChannelizer(m, v, p, prototype=h)
    ch = tch.OversampledChannelizer(m, v, p, prototype=h, device=CPU)
    assert ch.m == m
    x1, x2 = _stream((2, 8 * m), m), _stream((2, 8 * m), m + 1)
    want1, rst1 = ref.process(ref.init_state((2,)), jnp.asarray(x1))
    want2, rst2 = ref.process(rst1, jnp.asarray(x2))
    got1, st1 = ch.process(ch.init_state((2,)), x1)
    got2, st2 = ch.process(st1, x2)
    assert got1.shape == want1.shape == (2, 8 * v, m)
    assert _rel(got1.numpy(), want1) <= TOL
    assert _rel(got2.numpy(), want2) <= TOL
    for st, rst in ((st1, rst1), (st2, rst2)):
        np.testing.assert_array_equal(st.hist_re.numpy(), np.asarray(rst.hist_re))
        np.testing.assert_array_equal(st.hist_im.numpy(), np.asarray(rst.hist_im))


def test_channelizer_errors():
    ch = tch.Channelizer(16, 4, device=CPU)
    with pytest.raises(ValueError, match="multiple of M=16"):
        ch.process(ch.init_state(), np.zeros(40, np.complex64))
    with pytest.raises(ValueError, match="P\\*M"):
        tch.Channelizer(16, 4, prototype=np.ones(10), device=CPU)
    with pytest.raises(ValueError, match=r"\[P, M\]"):
        tch.Channelizer.from_weights(np.ones(16), device=CPU)
    with pytest.raises(ValueError, match="divide"):
        tch.OversampledChannelizer(16, 3, device=CPU)
    # float64 channelizers construct and run (tests/test_torch_channelizer64.py
    # holds them to the reference)
    c64 = tch.Channelizer(16, 4, dtype="float64", device=CPU)
    y64, st64 = c64.process(c64.init_state(), np.zeros(32, np.complex128))
    assert y64.dtype == torch.complex128 and y64.shape == (2, 16)
    assert st64.hist_re.dtype == torch.float64
    assert pt.Channelizer is tch.Channelizer and pt.FastConv is pt.conv.FastConv
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            c = tch.Channelizer(16, 4)
            c.process(c.init_state(device=CPU), np.zeros(32, np.complex64))


# ---------------------------------------------------------------------------
# DDCChain: mixer -> overlap-save lowpass -> decimate
# ---------------------------------------------------------------------------

# relative to max|ref|: the f32 NCO, then f32 (or f64) block convolutions
DDC_TOL = 1e-5


@pytest.mark.parametrize("taps,decim,rate", [(63, 4, 0.11), (33, 2, -0.07), (129, 8, 0.3),
                                             (1024, 8, 0.0625), (2, 1, 0.2)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ddc_chain_matches_reference_streaming(taps, decim, rate, dtype):
    """Three chunks with the state carried (the last of another length),
    against the reference chain on the same chunks; the states match."""

    h = rch.design_lowpass(taps, 0.5 / decim)
    ref = rch.DDCChain(rate, h, decim, dtype=dtype)
    ddc = tch.DDCChain(rate, h, decim, dtype=dtype, device=CPU)
    rst, st = ref.init_state(), ddc.init_state()
    for j, n in enumerate((512 * decim, 512 * decim, 200 * decim)):
        x = _stream((n,), 40 + j)
        want, rst = ref.process(rst, jnp.asarray(x))
        got, st = ddc.process(st, x)
        assert got.dtype == (torch.complex128 if dtype == "float64" else torch.complex64)
        assert got.shape == want.shape == (n // decim,)
        assert _rel(got.numpy(), want) <= DDC_TOL
        assert st.mixer == tuple(int(np.asarray(a)) for a in rst.mixer)
        assert st.tail.shape == (taps - 1,) and _rel(st.tail.numpy(), rst.tail) <= DDC_TOL


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ddc_chain_state_carried_from_reference_mid_stream(dtype):
    h = rch.design_lowpass(63, 0.1)
    ref = rch.DDCChain(0.11, h, 4, dtype=dtype)
    rst = ref.init_state()
    for j in range(2):
        _, rst = ref.process(rst, jnp.asarray(_stream((1024,), 50 + j)))
    x = _stream((2048,), 52)
    want, _ = ref.process(rst, jnp.asarray(x))
    ddc = tch.DDCChain(0.11, h, 4, dtype=dtype, device=CPU)
    st = tch.ddc_state_from_arrays(np.asarray(rst.mixer.phase_fp),
                                   np.asarray(rst.mixer.rate_fp), np.asarray(rst.tail), CPU)
    got, _ = ddc.process(st, torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= DDC_TOL


def test_ddc_chain_matches_direct_mix_and_convolution():
    """Two chunks against the float64 mix, full convolution and decimation."""

    h = rch.design_lowpass(33, 0.1)
    ddc = tch.DDCChain(0.07, h, decim=2, device=CPU)
    xall = _stream((1536,), 5)
    st, outs = ddc.init_state(), []
    for c in (xall[:1024], xall[1024:]):
        y, st = ddc.process(st, c)
        outs.append(y.numpy())
    n = np.arange(xall.size)
    mixed = xall.astype(np.complex128) * np.exp(2j * np.pi * 0.07 * n)
    ref = np.convolve(mixed, h)[: xall.size : 2]
    assert _rel(np.concatenate(outs), ref) <= DDC_TOL


def test_ddc_chain_one_tap_is_the_mixer():
    """A one-tap filter carries an empty tail: the chain is the mixer,
    decimated, in every chunk."""

    ddc = tch.DDCChain(0.2, np.ones(1), decim=2, device=CPU)
    mix = pt.dsp.Mixer(0.2, device=CPU)
    st = ddc.init_state()
    for j in range(2):
        x = _stream((256,), 60 + j)
        y, st = ddc.process(st, x)
        assert st.tail.shape == (0,)
        assert _rel(y.numpy(), mix.shift(x)[::2].numpy()) <= DDC_TOL


def test_ddc_chain_errors_and_exports():
    ddc = tch.DDCChain(0.1, rch.design_lowpass(33, 0.1), decim=4, device=CPU)
    with pytest.raises(ValueError, match="multiple of decim=4"):
        ddc.process(ddc.init_state(), np.zeros(1022, np.complex64))
    assert pt.DDCChain is tch.DDCChain and pt.DDCState is tch.DDCState
