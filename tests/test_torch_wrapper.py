"""The port's pffft.hpp ``Fft`` object, pffft_tpu_torch.wrapper, against
pffft_tpu.wrapper on the same seeded numpy inputs over all four types,
and the parity pieces of earlier slices: ``simd_size`` / ``simd_arch``,
``FastConv.hf`` and ``jitted_process`` of the channelizer and
``DDCChain``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu import channelizer as rch
from pffft_tpu import conv as rconv
from pffft_tpu import oracle
from pffft_tpu.wrapper import Fft as RefFft
import pffft_tpu_torch as pt
from pffft_tpu_torch import channelizer as tch
from pffft_tpu_torch.wrapper import Fft

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
TYPES = [np.float32, np.float64, np.complex64, np.complex128]


def _tol(dtype):
    return 1e-5 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-12


def _signal(n, dtype, seed):
    r = np.random.default_rng(seed)
    if np.iscomplexobj(np.zeros(1, dtype)):
        return (r.standard_normal((3, n)) + 1j * r.standard_normal((3, n))).astype(dtype)
    return r.standard_normal((3, n)).astype(dtype)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("n", [64, 512, 1280])
def test_forward_inverse_match_reference_all_types(dtype, n):
    f, rf = Fft(dtype, n, device=CPU), RefFft(dtype, n)
    x = _signal(n, dtype, n)
    spec = f.forward(x)
    want = np.asarray(rf.forward(jnp.asarray(x)))
    assert spec.shape[-1] == f.spectrum_size == rf.spectrum_size
    assert _rel(spec, want) <= _tol(dtype)
    back = f.inverse(spec)
    assert _rel(back, np.asarray(rf.inverse(jnp.asarray(want)))) <= _tol(dtype)
    assert _rel(back / f.length, x) <= _tol(dtype) * np.log2(n)
    assert back.dtype == {np.float32: torch.float32, np.float64: torch.float64,
                          np.complex64: torch.complex64,
                          np.complex128: torch.complex128}[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_internal_layout_reorder_and_convolve(dtype):
    n = 256
    f, rf = Fft(dtype, n, device=CPU), RefFft(dtype, n)
    a, b = _signal(n, dtype, 1)[0], _signal(n, dtype, 2)[0]
    za, zb = f.forward_to_internal_layout(a), f.forward_to_internal_layout(b)
    rza = rf.forward_to_internal_layout(jnp.asarray(a))
    rzb = rf.forward_to_internal_layout(jnp.asarray(b))
    assert _rel(za, rza) <= 1e-5
    assert _rel(f.reorder_spectrum(za, pt.FORWARD), f.forward(a).numpy()) <= 1e-5
    assert _rel(f.reorderSpectrum(f.reorder_spectrum(za), pt.BACKWARD), za.numpy()) == 0.0
    zc = f.convolve(za, zb, 1.0 / n)
    assert _rel(zc, rf.convolve(rza, rzb, 1.0 / n)) <= 1e-5
    acc = f.convolveAccumulate(za, zb, zc, 0.5)
    assert _rel(acc, rf.convolve_accumulate(rza, rzb, rf.convolve(rza, rzb, 1.0 / n), 0.5)) <= 1e-5
    y = f.inverse_from_internal_layout(zc)
    assert _rel(y, rf.inverse_from_internal_layout(rf.convolve(rza, rzb, 1.0 / n))) <= 1e-5
    # circular convolution oracle
    af, bf = (oracle.cfftf(v.astype(np.complex128)) for v in (a, b))
    ref = oracle.cfftb(af * bf) / n
    ref = ref if f.is_complex_transform else ref.real
    assert np.abs(y.numpy() - ref).max() < 1e-3
    assert f.forwardToInternalLayout is not None and f.inverseFromInternalLayout is not None


def test_replan_and_factories():
    f = Fft(np.float32, device=CPU)
    with pytest.raises(RuntimeError):
        _ = f.length
    f.prepare_length(1024)
    assert f.length == 1024 and f.spectrum_size == 512
    f.prepareLength(2048)
    assert f.length == 2048 and f.internal_layout_size == 2048
    rf = RefFft(np.float32, 2048)
    for name in ("value_vector", "spectrum_vector", "internal_layout_vector",
                 "valueVector", "spectrumVector", "internalLayoutVector"):
        v, rv = getattr(f, name)(3), getattr(rf, name)(3)
        assert tuple(v.shape) == rv.shape and v.device.type == "cpu"
        assert str(v.dtype).split(".")[-1] == str(rv.dtype) and not v.any()
    c = Fft(np.complex128, 64, device=CPU)
    assert c.is_complex_transform and c.spectrum_vector(2).dtype == torch.complex128


def test_statics_and_errors_match_reference():
    for n in (1000, 1024, 96, 4097):
        for dt in TYPES:
            assert Fft.is_valid_size(n, dt) == RefFft.is_valid_size(n, dt)
            for higher in (True, False):
                assert (Fft.nearest_transform_size(n, dt, higher)
                        == RefFft.nearest_transform_size(n, dt, higher))
    assert Fft.simd_size() == RefFft.simd_size() == 4
    with pytest.raises(TypeError) as te:
        Fft(np.int32)
    with pytest.raises(TypeError) as rf:
        RefFft(np.int32)
    assert str(te.value) == str(rf.value)
    with pytest.raises(ValueError) as te:
        Fft(np.float32, 1000)
    with pytest.raises(ValueError) as rf:
        RefFft(np.float32, 1000)
    assert str(te.value) == str(rf.value)


def test_simd_size_and_arch():
    assert pt.simd_size() == pf.simd_size() == 4
    assert pt.simd_arch() == "cuda-sm_90a"
    assert pt.plan.simd_size is pt.simd_size


def test_numpy_input_goes_to_the_card_by_default():
    f = Fft(np.float32, 64)
    if torch.cuda.is_available():
        assert f.forward(np.zeros(64, np.float32)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            f.forward(np.zeros(64, np.float32))


# ---------------------------------------------------------------------------
# Parity pieces of earlier slices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("taps,flags", [
    (64, pt.ConvFlags.NONE),
    (100, pt.ConvFlags.CORRELATION),
    (31, pt.ConvFlags.CPLX_INP_OUT | pt.ConvFlags.CPLX_SINGLE_FFT),
    (40, pt.ConvFlags.CPLX_INP_OUT | pt.ConvFlags.CPLX_FILTER),
])
def test_fastconv_hf_matches_reference(taps, flags):
    r = np.random.default_rng(taps)
    h = r.standard_normal(taps)
    if flags & pt.ConvFlags.CPLX_FILTER:
        h = h + 1j * r.standard_normal(taps)
    fc = pt.FastConv(h, flags=flags, device=CPU)
    ref = rconv.FastConv(h, flags=rconv.ConvFlags(int(flags)))
    want = np.asarray(ref.hf)
    got = fc.hf
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= 1e-5
    assert fc.hf is got  # computed once per setup


def test_jitted_process_is_process():
    ref = rch.Channelizer(16, 4)
    ch = tch.Channelizer.from_weights(np.asarray(ref.weights), device=CPU)
    x = (np.random.default_rng(1).standard_normal(64)
         + 1j * np.random.default_rng(2).standard_normal(64)).astype(np.complex64)
    got, _ = ch.jitted_process(ch.init_state(), x)
    want, _ = ref.jitted_process(ref.init_state(), jnp.asarray(x))
    assert ch.jitted_process == ch.process
    assert _rel(got, want) <= 1e-5
    taps = pt.design_lowpass(33, 0.05)
    ddc, rddc = pt.DDCChain(0.1, taps, 4, device=CPU), rch.DDCChain(0.1, taps, 4)
    x = np.random.default_rng(3).standard_normal(256).astype(np.complex64)
    got, _ = ddc.jitted_process(ddc.init_state(), x)
    want, _ = rddc.jitted_process(rddc.init_state(), jnp.asarray(x))
    assert ddc.jitted_process == ddc.process
    assert _rel(got, want) <= 1e-5
