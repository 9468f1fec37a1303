"""The port's float64 polyphase channelizers against pffft_tpu's float64
channelizers (the conftest turns x64 on) on the same numpy inputs: every
entry point, streaming continued from a reference state, the time-major
layout, the state's dtype and memory, and the oversampled residues read
from their offsets.

A float64 channelizer launches no kernel: its polyphase step is the
multiply-accumulate of shifted slices, its DFT the float64 stage engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pffft_tpu import channelizer as rch
from pffft_tpu_torch import channelizer as tch

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
# relative to max|ref|: float64 polyphase sums and FFTs on both sides, in
# another order and through another FFT engine on each
TOL = 1e-12
SHAPES = [(8, 4, ()), (16, 8, (2,)), (12, 6, (3,)), (64, 4, (2, 2))]


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-300))


def _stream(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _pair(m, p):
    ref = rch.Channelizer(m, p, dtype="float64")
    return ref, tch.Channelizer.from_weights(np.asarray(ref.weights), dtype="float64",
                                             device=CPU)


def _split(x):
    return np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)


@pytest.mark.parametrize("m,p,lead", SHAPES)
def test_every_entry_point_matches_reference(m, p, lead):
    """process, process_split and process_split_tmajor over two chunks with
    the state carried, and one_shot: outputs within 1e-12, dtypes float64
    and complex128, states equal."""

    ref, ch = _pair(m, p)
    assert ch.weights.dtype == np.float64
    x1, x2 = _stream((*lead, 5 * m), m + p), _stream((*lead, 3 * m), m + p + 1)
    rst, st = ref.init_state(lead), ch.init_state(lead)
    st_s = st_t = st
    for x in (x1, x2):
        want, rst_next = ref.process(rst, jnp.asarray(x))
        (wtr, wti), _ = ref.process_split_tmajor(rst, *map(jnp.asarray, _split(x)))
        rst = rst_next
        got, st = ch.process(st, x)
        (gr, gi), st_s = ch.process_split(st_s, *_split(x))
        (tr, ti), st_t = ch.process_split_tmajor(st_t, *_split(x))
        assert got.dtype == torch.complex128 and gr.dtype == tr.dtype == torch.float64
        assert got.shape == want.shape == (*lead, x.shape[-1] // m, m)
        assert tr.shape == wtr.shape == (m, int(np.prod(lead, dtype=int)) * (x.shape[-1] // m))
        assert _rel(got.numpy(), want) <= TOL
        assert _rel(gr.numpy() + 1j * gi.numpy(), want) <= TOL
        assert _rel(tr.numpy(), wtr) <= TOL and _rel(ti.numpy(), wti) <= TOL
        for s in (st, st_s, st_t):
            assert s.hist_re.dtype == torch.float64
            np.testing.assert_array_equal(s.hist_re.numpy(), np.asarray(rst.hist_re))
            np.testing.assert_array_equal(s.hist_im.numpy(), np.asarray(rst.hist_im))
    want = ref.one_shot(jnp.asarray(x1))
    got = ch.one_shot(torch.from_numpy(x1))
    assert got.dtype == torch.complex128 and _rel(got.numpy(), want) <= TOL


def test_tmajor_layout_is_the_split_output_channel_major():
    """process_split_tmajor's [M, B*K] is process_split's [B, K, M] with
    the channel axis first and the columns frame-fastest."""

    m, p, lead = 16, 4, (3,)
    _, ch = _pair(m, p)
    x = _stream((*lead, 6 * m), 5)
    (yr, yi), _ = ch.process_split(ch.init_state(lead), *_split(x))
    (tr, ti), _ = ch.process_split_tmajor(ch.init_state(lead), *_split(x))
    for y, t in ((yr, tr), (yi, ti)):
        back = t.reshape(m, 3, 6).permute(1, 2, 0)
        assert _rel(back.numpy(), y.numpy()) <= TOL


@pytest.mark.parametrize("m,p", [(16, 8), (12, 6)])
def test_streaming_continues_from_a_reference_state(m, p):
    ref, ch = _pair(m, p)
    x1, x2 = _stream((2, 4 * m), 11), _stream((2, 7 * m), 12)
    _, rst = ref.process(ref.init_state((2,)), jnp.asarray(x1))
    want, rst2 = ref.process(rst, jnp.asarray(x2))
    st = tch.state_from_arrays(np.asarray(rst.hist_re), np.asarray(rst.hist_im), CPU)
    got, st2 = ch.process(st, x2)
    assert _rel(got.numpy(), want) <= TOL
    np.testing.assert_array_equal(st2.hist_re.numpy(), np.asarray(rst2.hist_re))


def test_state_dtypes():
    ch = tch.Channelizer(16, 4, dtype="float64", device=CPU)
    och = tch.OversampledChannelizer(16, 2, 4, dtype="float64", device=CPU)
    for st in (ch.init_state((2,)), och.init_state()):
        assert st.hist_re.dtype == st.hist_im.dtype == torch.float64
        assert st.hist_re.shape[-1] == 64
    # float64 arrays stay float64, others become float32; either carries
    # on in a float64 channelizer, which casts the state to its dtype
    st = tch.state_from_arrays(np.zeros(64), np.zeros(64), CPU)
    assert st.hist_re.dtype == st.hist_im.dtype == torch.float64
    st32 = tch.state_from_arrays(np.zeros(64, np.float32), np.zeros(64, np.float32), CPU)
    assert st32.hist_re.dtype == st32.hist_im.dtype == torch.float32
    x = _stream((2 * 64,), 5)
    for s in (st, st32):
        y, s2 = ch.process(s, x)
        assert y.dtype == torch.complex128 and s2.hist_re.dtype == torch.float64
    assert torch.equal(ch.process(st32, x)[0], ch.process(st, x)[0])
    assert tch.Channelizer(16, 4, device=CPU).init_state().hist_re.dtype == torch.float32
    assert och.ph_re.dtype == och.ph_im.dtype == np.float64


@pytest.mark.parametrize("buffer", ["numpy", "tensor"])
@pytest.mark.parametrize("frames", [3, 12])  # K < P and K >= P
def test_refilled_input_buffer_leaves_the_state_alone(buffer, frames):
    """A caller that refills one float64 input buffer each step: its state
    and the next step's output are the reference's."""

    m, p, lead = 16, 8, (2,)
    ref, ch = _pair(m, p)
    rst, st = ref.init_state(lead), ch.init_state(lead)
    br = np.zeros((*lead, frames * m))
    bi = np.zeros_like(br)
    if buffer == "tensor":
        br, bi = torch.from_numpy(br), torch.from_numpy(bi)
    for step in range(3):
        x = _stream((*lead, frames * m), 40 + frames + step)
        br[...] = torch.from_numpy(x.real) if buffer == "tensor" else x.real
        bi[...] = torch.from_numpy(x.imag) if buffer == "tensor" else x.imag
        (wr, wi), rst = ref.process_split(rst, jnp.asarray(x.real), jnp.asarray(x.imag))
        (gr, gi), st = ch.process_split(st, br, bi)
        br[...] = 0.0  # the caller reuses its buffer before the next step
        bi[...] = 0.0
        assert _rel(gr.numpy(), wr) <= TOL and _rel(gi.numpy(), wi) <= TOL
        np.testing.assert_array_equal(st.hist_re.numpy(), np.asarray(rst.hist_re))
        np.testing.assert_array_equal(st.hist_im.numpy(), np.asarray(rst.hist_im))


@pytest.mark.parametrize("m,v", [(16, 2), (16, 4), (12, 2), (64, 4)])
def test_oversampled_matches_reference(m, v):
    ref = rch.OversampledChannelizer(m, v, 4, dtype="float64")
    ch = tch.OversampledChannelizer(m, v, 4, prototype=np.asarray(ref.base.weights).reshape(-1),
                                    dtype="float64", device=CPU)
    rst, st, st_s = ref.init_state((2,)), ch.init_state((2,)), ch.init_state((2,))
    for seed, frames in ((m, 6), (m + 1, 9)):
        x = _stream((2, frames * m), seed)
        want, rst = ref.process(rst, jnp.asarray(x))
        got, st = ch.process(st, x)
        (gr, gi), st_s = ch.process_split(st_s, *_split(x))
        assert got.dtype == torch.complex128 and gr.dtype == torch.float64
        assert got.shape == want.shape == (2, v * frames, m)
        assert _rel(got.numpy(), want) <= TOL
        assert _rel(gr.numpy() + 1j * gi.numpy(), want) <= TOL
        for s in (st, st_s):
            np.testing.assert_array_equal(s.hist_re.numpy(), np.asarray(rst.hist_re))
            np.testing.assert_array_equal(s.hist_im.numpy(), np.asarray(rst.hist_im))


@pytest.mark.parametrize("v", [2, 4])
def test_residue_offsets_read_no_padding(v):
    """The reference shifts each residue's stream by r*H and zero-pads it
    back to (P+K)*M; the port reads from the offset instead.  Samples past
    the last one a residue needs (the reference's padded tail) may be NaN
    without reaching the output, in both layouts."""

    m, p, k, r = 16, 4, 5, 3
    _, ch = _pair(m, p)
    ext = torch.from_numpy(np.random.default_rng(v).standard_normal((r, (p + k) * m)))
    for res in range(v):
        off = res * m // v
        poisoned = ext.clone()
        poisoned[:, off + (p + k - 1) * m + 1:] = float("nan")
        want = ch._mac_tmajor(ext, k, off)
        got = ch._mac_tmajor(poisoned, k, off)
        assert torch.isfinite(got).all()
        assert torch.equal(got, want)
        # the reference's polyphase on its zero-padded shift
        padded = np.pad(ext.numpy()[:, off:], ((0, 0), (0, off)))
        rbase = rch.Channelizer(m, p, ch.weights.reshape(-1), dtype="float64")
        want = np.asarray(rbase._polyphase_tmajor(jnp.asarray(padded), k)).reshape(m, -1)
        assert _rel(ch._mac_tmajor(ext, k, off).numpy(), want) <= TOL
        want = np.asarray(rbase._polyphase(jnp.asarray(padded), k))
        got = ch._mac_tmajor(ext, k, off).reshape(m, r, k).permute(1, 2, 0)
        assert _rel(got.numpy(), want) <= TOL


def test_float32_channelizer_launches_the_float32_path(monkeypatch):
    """A float32 channelizer still takes B8's wrapper (its plain version on
    the CPU); a float64 one never does."""

    from pffft_tpu_torch.ops import pfb_kernel as tpfb

    x = _stream((2, 8 * 16), 3)
    calls = []
    orig = tpfb.pfb_fir_stream_tmajor
    monkeypatch.setattr(tpfb, "pfb_fir_stream_tmajor",
                        lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    tch.Channelizer(16, 4, dtype="float64", device=CPU).one_shot(x)
    assert calls == []
    tch.Channelizer(16, 4, device=CPU).one_shot(x.astype(np.complex64))
    assert calls == [1]
