"""Gradients through the port, pffft_tpu_torch, against jax.grad through
pffft_tpu on the same seeded numpy inputs.

Each case feeds real input planes to both packages, takes the vector-Jacobian
product of one seeded cotangent per output (a complex output against its
complex cotangent as Re(sum(conj(c) * y))), and compares the gradients with
respect to the real planes, so that the two packages' complex conventions
do not matter.  On the CPU the port's kernel wrappers run their plain
versions inside the same autograd Functions the card runs (dispatch._Cfft,
fft._RealForward / _RealBackward, conv_kernel._ZconvTmajor / _ZconvStream,
pfb_kernel._PfbFir / _PfbStream), so the adjoints tested here are the
card's.  Then gradcheck and gradgradcheck of the four Functions in float64,
vmap and checkpoint (the counterparts of the reference's functional tests),
and the no-gradient paths, which enter no Function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu import channelizer as rch
from pffft_tpu import conv as rconv
from pffft_tpu import dct as rdct
from pffft_tpu import pconv as rpconv
from pffft_tpu import resample as rres
from pffft_tpu import spectral as rsp
from pffft_tpu import wrapper as rwrap
from pffft_tpu.ops import dispatch as rdispatch
import pffft_tpu_torch as pt
from pffft_tpu_torch import channelizer as tch
from pffft_tpu_torch import conv as tconv
from pffft_tpu_torch import fft as tfft
from pffft_tpu_torch.ops import conv_kernel as ck
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import pfb_kernel as pfb

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
# gradient vs jax.grad, relative to max|jax gradient|: f32 transforms and
# sums on both sides, in another order on each
TOL = 1e-5


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cot(y, seed):
    """A seeded cotangent like the port's output ``y`` (complex or real)."""

    rng = np.random.default_rng(seed)
    c = rng.standard_normal(tuple(y.shape))
    if y.is_complex():
        c = c + 1j * rng.standard_normal(tuple(y.shape))
    return c.astype(np.complex64 if y.is_complex() else np.float32)


def _dot_torch(y, c):
    c = torch.from_numpy(c)
    if y.is_complex():
        return (y.real * c.real).sum() + (y.imag * c.imag).sum()
    return (y * c).sum()


def _dot_jax(y, c):
    c = jnp.asarray(c)
    if jnp.iscomplexobj(y):
        return jnp.sum(jnp.real(y) * jnp.real(c)) + jnp.sum(jnp.imag(y) * jnp.imag(c))
    return jnp.sum(y * c)


def _check(ref_fn, port_fn, inputs, seed=0, tol=TOL):
    """The gradients of both packages' sum of <cotangent, output> with
    respect to every real input array, within ``tol`` of max|jax grad|."""

    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in inputs]
    outs = port_fn(*ts)
    cots = [_cot(y, seed + i) for i, y in enumerate(outs)]
    got = torch.autograd.grad(sum(_dot_torch(y, c) for y, c in zip(outs, cots)), ts)

    def loss(*xs):
        return sum(_dot_jax(y, c) for y, c in zip(ref_fn(*xs), cots))

    want = jax.grad(loss, argnums=tuple(range(len(inputs))))(*map(jnp.asarray, inputs))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= tol


def _cplx(re, im):
    return torch.complex(re, im)


def _jcplx(re, im):
    return jax.lax.complex(re, im)


# ---------------------------------------------------------------------------
# The transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [96, 128])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("ordered", [True, False])
def test_complex_transform_grad_matches_jax(n, direction, ordered):
    d, rd = (pt.FORWARD, pf.FORWARD) if direction == "forward" else (pt.BACKWARD, pf.BACKWARD)
    factors = (8, n // 8)  # internal order: the same plan in both packages
    plan, rplan = pt.new_setup(n, factors=factors), pf.new_setup(n, factors=factors)
    tf, rf = (pt.transform_ordered, pf.transform_ordered) if ordered else (pt.transform,
                                                                            pf.transform)
    _check(lambda a, b: (rf(rplan, _jcplx(a, b), rd),),
           lambda a, b: (tf(plan, _cplx(a, b), d, device=CPU),),
           [_real((3, n), n), _real((3, n), n + 1)], seed=n)


@pytest.mark.parametrize("n", [96, 128])
def test_real_transform_grad_matches_jax(n):
    plan, rplan = pt.new_setup(n, pt.REAL), pf.new_setup(n, pf.REAL)
    _check(lambda x: (pf.transform_ordered(rplan, x),),
           lambda x: (pt.transform_ordered(plan, x, device=CPU),), [_real((3, n), n)])
    h = n // 2
    _check(lambda a, b: (pf.transform_ordered(rplan, _jcplx(a, b), pf.BACKWARD),),
           lambda a, b: (pt.transform_ordered(plan, _cplx(a, b), pt.BACKWARD, device=CPU),),
           [_real((3, h), n + 2), _real((3, h), n + 3)])


@pytest.mark.parametrize("kind", ["complex", "real"])
@pytest.mark.parametrize("tmajor", [False, True])
def test_split_transforms_grad_match_jax(kind, tmajor):
    n, b = 128, 5
    real = kind == "real"
    plan = pt.new_setup(n, pt.REAL if real else pt.COMPLEX)
    rplan = pf.new_setup(n, pf.REAL if real else pf.COMPLEX)
    tf = pt.transform_ordered_split_tmajor if tmajor else pt.transform_ordered_split
    rf = pf.transform_ordered_split_tmajor if tmajor else pf.transform_ordered_split

    def shape(rows):
        return (rows, b) if tmajor else (b, rows)

    if real:
        _check(lambda x: rf(rplan, x), lambda x: tf(plan, x, device=CPU), [_real(shape(n), 1)])
        _check(lambda a, c: (rf(rplan, (a, c), pf.BACKWARD),),
               lambda a, c: (tf(plan, (a, c), pt.BACKWARD, device=CPU),),
               [_real(shape(n // 2), 2), _real(shape(n // 2), 3)])
        return
    for d, rd in ((pt.FORWARD, pf.FORWARD), (pt.BACKWARD, pf.BACKWARD)):
        _check(lambda a, c: rf(rplan, (a, c), rd), lambda a, c: tf(plan, (a, c), d, device=CPU),
               [_real(shape(n), 4), _real(shape(n), 5)])


# ---------------------------------------------------------------------------
# FastConv, StreamingConv
# ---------------------------------------------------------------------------


def test_conv_stream_grad_matches_jax():
    """The reference's trainable front end (test_functional_transforms):
    the gradient of a loss through ``_conv_stream`` at F = 33, L = 1024."""

    h = _real(33, 3)
    fc, rfc = tconv.FastConv(h, device=CPU), rconv.FastConv(h)
    total = 1024 - 33 + 1
    _check(lambda x: (rfc._conv_stream(x, total),),
           lambda x: (fc._conv_stream(x[None], total)[0],), [_real(1024, 4)])


@pytest.mark.parametrize("flags", [pt.ConvFlags.NONE, pt.ConvFlags.CORRELATION,
                                   pt.ConvFlags.CPLX_INP_OUT,
                                   pt.ConvFlags.CPLX_INP_OUT | pt.ConvFlags.CPLX_SINGLE_FFT,
                                   pt.ConvFlags.CPLX_INP_OUT | pt.ConvFlags.CPLX_FILTER])
@pytest.mark.parametrize("route", ["fused", "tmajor"])
def test_fastconv_apply_grad_matches_jax(flags, route):
    """Every flag on both block pipelines: the stream map's adjoint (the
    reversed, conjugated taps) and the routed transforms'."""

    rng = np.random.default_rng(int(flags) + 7)
    flen, length = 40, 900
    h = rng.standard_normal(flen)
    if flags & pt.ConvFlags.CPLX_FILTER:
        h = h + 1j * rng.standard_normal(flen)
    fc = tconv.FastConv(h, flags=flags, device=CPU)
    rfc = rconv.FastConv(h, flags=rconv.ConvFlags(int(flags)))
    fc._force_conv_kernel = route
    if flags & pt.ConvFlags.CPLX_INP_OUT:
        _check(lambda a, b: (rfc.apply(_jcplx(a, b), flush=True)[0],),
               lambda a, b: (fc.apply(_cplx(a, b), flush=True)[0],),
               [_real(length, 1), _real(length, 2)])
    else:
        _check(lambda x: (rfc.apply(x, flush=True)[0],),
               lambda x: (fc.apply(x, flush=True)[0],), [_real(length, 3)])


def test_fastconv_valid_grad_matches_jax():
    h = _real(17, 5)
    _check(lambda x: (rconv.fastconv_valid(x, h),),
           lambda x: (tconv.fastconv_valid(x, h, device=CPU),), [_real((3, 500), 6)])


def test_streaming_conv_frames_grad_matches_jax():
    """StreamingConv's push runs its framer's frames [k, nfft] through the
    column map (the reference's jitted pipeline); the gradient with respect
    to the frames."""

    h = _real(20, 7)
    sc, rsc = tconv.StreamingConv(h, device=CPU), rconv.StreamingConv(h)
    s, rs = sc.setup, rsc.setup
    u, k = s.num_out_per_block, 7  # odd: _filter pads a zero frame
    pipe = rs._jitted_pipeline(k, rdispatch.state_key())
    _check(lambda f: (pipe(f)[:, :u],), lambda f: (sc._filter(f),), [_real((k, s.nfft), 8)])


# ---------------------------------------------------------------------------
# The STFT, the channelizers, the DDC chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tmajor", [None, True])
def test_stft_split_grad_matches_jax(tmajor, monkeypatch):
    from pffft_tpu_torch import spectral as tsp

    monkeypatch.setattr(tsp, "_TMAJOR_STFT", tmajor)
    _check(lambda x: rsp.stft_split(x, 64, 32), lambda x: tsp.stft_split(x, 64, 32, device=CPU),
           [_real((2, 600), 9)])


def test_istft_grad_matches_jax():
    s = (2, 9, 32)
    _check(lambda a, b: (rsp.istft(_jcplx(a, b), 32, length=300),),
           lambda a, b: (pt.spectral.istft(_cplx(a, b), 32, length=300),),
           [_real(s, 10), _real(s, 11)])


def _channelizer_case(ref, port, lead, length, hist, seed):
    """Gradients with respect to the chunk's planes and the state's (``hist``
    = P*M samples a row)."""

    hist = (*lead, hist)

    def rfn(xr, xi, hr, hi):
        y, st = ref.process(rch.ChannelizerState(hr, hi), _jcplx(xr, xi))
        return y, st.hist_re, st.hist_im

    def tfn(xr, xi, hr, hi):
        y, st = port.process(tch.ChannelizerState(hr, hi), _cplx(xr, xi))
        return y, st.hist_re, st.hist_im

    _check(rfn, tfn, [_real((*lead, length), seed), _real((*lead, length), seed + 1),
                      _real(hist, seed + 2), _real(hist, seed + 3)], seed=seed)


@pytest.mark.parametrize("m,p,k", [(16, 4, 8), (32, 8, 3)])  # K >= P and K < P
def test_channelizer_grad_matches_jax(m, p, k):
    ref = rch.Channelizer(m, p)
    port = tch.Channelizer.from_weights(np.asarray(ref.weights), device=CPU)
    _channelizer_case(ref, port, (2,), k * m, p * m, m + p)


def test_oversampled_channelizer_grad_matches_jax():
    m, v, p = 32, 2, 4
    h = rch.design_lowpass(p * m, 0.5 / m)
    ref = rch.OversampledChannelizer(m, v, p, prototype=h)
    port = tch.OversampledChannelizer(m, v, p, prototype=h, device=CPU)
    _channelizer_case(ref, port, (2,), 8 * m, p * m, 5)


def test_ddc_chain_grad_matches_jax():
    taps = pt.design_lowpass(33, 0.05)
    ddc, rddc = pt.DDCChain(0.1, taps, 4, device=CPU), rch.DDCChain(0.1, taps, 4)
    n = 400

    def rfn(xr, xi, tr, ti):
        st = rch.DDCState(rddc.init_state().mixer, _jcplx(tr, ti))
        y, st = rddc.process(st, _jcplx(xr, xi))
        return y, st.tail

    def tfn(xr, xi, tr, ti):
        st = tch.DDCState(ddc.init_state().mixer, _cplx(tr, ti))
        y, st = ddc.process(st, _cplx(xr, xi))
        return y, st.tail

    _check(rfn, tfn, [_real(n, 1), _real(n, 2), _real(32, 3), _real(32, 4)])


# ---------------------------------------------------------------------------
# Any length, N-D, DCT, the FDL, the resampler, Fft
# ---------------------------------------------------------------------------


def test_rfft_any_grad_matches_jax():
    for n in (96, 101):
        _check(lambda x: (pf.rfft_any(x),), lambda x: (pt.rfft_any(x, device=CPU),),
               [_real((2, n), n)])


def test_fftn_split_grad_matches_jax():
    nd, rnd = pt.fftn_setup((16, 48)), pf.fftn_setup((16, 48))
    for d, rd in ((pt.FORWARD, pf.FORWARD), (pt.BACKWARD, pf.BACKWARD)):
        _check(lambda a, b: pf.fftn_split(rnd, (a, b), rd),
               lambda a, b: pt.fftn_split(nd, (a, b), d, device=CPU),
               [_real((2, 16, 48), 1), _real((2, 16, 48), 2)])


def test_dct2_grad_matches_jax():
    _check(lambda x: (rdct.dct2(x),), lambda x: (pt.dct2(x, device=CPU),), [_real((3, 64), 12)])


def test_partitioned_conv_grad_matches_jax():
    h, block = _real(300, 13), 64
    tp, rp = pt.PartitionedConv(h, block_len=block, device=CPU), rpconv.PartitionedConv(h, block)

    def rfn(x):
        y, (sr, si, tail) = rp.process(rp.init_state((2,)), x)
        return y, sr, si, tail

    def tfn(x):
        y, st = tp.process(tp.init_state((2,)), x)
        return (y, *st)

    _check(rfn, tfn, [_real((2, 3 * block), 14)])


def test_resampler_grad_matches_jax():
    tr, rr = pt.resample.Resampler(3, 2, 8, device=CPU), rres.Resampler(3, 2, 8)
    _check(lambda x: (rr(x),), lambda x: (tr(x),), [_real((2, 400), 15)])


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_fft_object_grad_matches_jax(dtype):
    n = 128
    f, rf = pt.Fft(dtype, n, device=CPU), rwrap.Fft(dtype, n)
    if dtype == np.float32:
        _check(lambda x: (rf.forward(x),), lambda x: (f.forward(x),), [_real((2, n), 16)])
        return
    _check(lambda a, b: (rf.forward(_jcplx(a, b)), rf.inverse(_jcplx(a, b))),
           lambda a, b: (f.forward(_cplx(a, b)), f.inverse(_cplx(a, b))),
           [_real((2, n), 17), _real((2, n), 18)])


# ---------------------------------------------------------------------------
# The four Functions: gradcheck and gradgradcheck in float64, every engine
# ---------------------------------------------------------------------------


def _f64(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, dtype=torch.float64, generator=g).requires_grad_(True)


@pytest.mark.parametrize("time_major,ordered", [(True, True), (False, True), (False, False)])
@pytest.mark.parametrize("backward", [False, True])
def test_cfft_function_gradcheck(time_major, ordered, backward):
    """Function 1 (dispatch._Cfft) on a float64 plan (the stage engine)."""

    plan = pt.new_setup(48, dtype="float64")
    shape = (48, 3) if time_major else (3, 48)
    f = lambda a, b: D.cfft_dispatch(plan, a, b, backward=backward, time_major=time_major,
                                     ordered=ordered)
    args = (_f64(shape, 1), _f64(shape, 2))
    assert torch.autograd.gradcheck(f, args)
    assert torch.autograd.gradgradcheck(f, args)


@pytest.mark.parametrize("time_major", [True, False])
def test_real_function_gradcheck(time_major):
    """Function 2 (fft._RealForward / _RealBackward) on a float64 plan."""

    plan = pt.new_setup(64, pt.REAL, dtype="float64")
    x = _f64((64, 3) if time_major else (3, 64), 3)
    spec = (_f64((32, 3) if time_major else (3, 32), 4),
            _f64((32, 3) if time_major else (3, 32), 5))
    for f, args in ((lambda a: tfft._real_forward(plan, a, time_major), (x,)),
                    (lambda a, b: tfft._real_backward(plan, a, b, time_major), spec)):
        assert torch.autograd.gradcheck(f, args)
        assert torch.autograd.gradgradcheck(f, args)


def test_pfb_function_gradcheck():
    """Function 4 (pfb_kernel._PfbFir / _PfbStream): both maps, from offsets
    0 and 5, on chunks shorter and longer than the frames read."""

    p, m, k = 4, 8, 6
    w = torch.randn((p, m), dtype=torch.float64, generator=torch.Generator().manual_seed(6))
    f = lambda r: pfb.pfb_fir(r, w, k)
    assert torch.autograd.gradcheck(f, (_f64((2, k + p + 1, m), 7),))
    assert torch.autograd.gradgradcheck(f, (_f64((2, k + p + 1, m), 7),))
    for offset in (0, 5):
        for length in ((k - 1) * m + 1, k * m + 3):
            args = (_f64((2, p * m), 8), _f64((2, p * m), 9), _f64((2, length), 10),
                    _f64((2, length), 11))
            g = lambda a, b, c, d: pfb.pfb_fir_stream_tmajor((a, b), (c, d), w, k, offset)
            assert torch.autograd.gradcheck(g, args)
            assert torch.autograd.gradgradcheck(g, args)


def _adjoint_gap(fn, xs, seed):
    """|<g, L x> - <L^T g, x>| / (|g| |L x|) in float64, for the linear map
    ``fn`` of float32 tensors ``xs``; L^T g by autograd."""

    xs = [x.clone().requires_grad_(True) for x in xs]
    ys = fn(*xs)
    ys = ys if isinstance(ys, tuple) else (ys,)
    gen = torch.Generator().manual_seed(seed)
    gs = [torch.randn(y.shape, dtype=y.dtype, generator=gen) for y in ys]
    lts = torch.autograd.grad(ys, xs, gs)
    lhs = sum(float((g.double() * y.detach().double()).sum()) for g, y in zip(gs, ys))
    rhs = sum(float((t.double() * x.detach().double()).sum()) for t, x in zip(lts, xs))
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in gs)
                   * sum(float((y.detach().double() ** 2).sum()) for y in ys))
    return abs(lhs - rhs) / norm


@pytest.mark.parametrize("cplx", [False, True])
def test_conv_function_dot_product(cplx):
    """Function 3 (conv_kernel._ZconvTmajor / _ZconvStream): its plain
    versions run the f32 chain, so the dot-product test in float32 stands
    in for gradcheck: <g, L x> = <L^T g, x> within 1e-5 of |g| |L x|, and
    the double backward the same."""

    h = _real(25, 19) + (1j * _real(25, 20) if cplx else 0)
    flags = pt.ConvFlags.CPLX_INP_OUT | (pt.ConvFlags.CPLX_FILTER if cplx else 0)
    fc = tconv.FastConv(h, flags=flags if cplx else pt.ConvFlags.NONE, device=CPU)
    cplan = D.conv_kernel_choice(fc.nfft, 1)[0]
    hfr, hfi = fc._spectrum(torch.device(CPU))
    u, length = fc.num_out_per_block, 700
    total = length - fc.filter_span + 1
    gen = torch.Generator().manual_seed(21)
    x = torch.randn((2, length), dtype=torch.complex64 if cplx else torch.float32, generator=gen)
    adj = fc._adjoint(torch.device(CPU))
    stream = lambda v: ck.zconv_stream(cplan, v, hfr, hfi, u, total, adj)
    if cplx:  # the dot product of the real planes
        stream_planes = lambda a, b: torch.view_as_real(stream(torch.complex(a, b))).unbind(-1)
        assert _adjoint_gap(stream_planes, (x.real, x.imag), 22) <= 1e-5
    else:
        assert _adjoint_gap(stream, (x,), 22) <= 1e-5
    cols = (torch.randn((fc.nfft, 12), generator=gen), torch.randn((fc.nfft, 12), generator=gen))
    assert _adjoint_gap(lambda a, b: ck.zconv_tmajor(cplan, a, b, hfr, hfi), cols, 23) <= 1e-5
    # the backward is differentiable: its own adjoint is the forward map
    a, b = (c.clone().requires_grad_(True) for c in cols)
    ga, gb = (torch.randn_like(c).requires_grad_(True) for c in cols)
    yr, yi = ck.zconv_tmajor(cplan, a, b, hfr, hfi)
    da, db = torch.autograd.grad((yr, yi), (a, b), (ga, gb), create_graph=True)
    ha, hb = torch.autograd.grad((da, db), (ga, gb), cols)  # d<da, c>/dga = L c
    wr, wi = ck.zconv_tmajor(cplan, *cols, hfr, hfi)
    assert max(float((ha - wr).abs().max()), float((hb - wi).abs().max())) <= \
        1e-5 * float(torch.maximum(wr.abs().max(), wi.abs().max()))


def test_stream_map_needs_its_adjoint():
    fc = tconv.FastConv(_real(9, 24), device=CPU)
    cplan = D.conv_kernel_choice(fc.nfft, 1)[0]
    hfr, hfi = fc._spectrum(torch.device(CPU))
    x = torch.zeros((1, 200), requires_grad=True)
    with pytest.raises(ValueError, match="adjoint"):
        ck.zconv_stream(cplan, x, hfr, hfi, fc.num_out_per_block, 100)


@pytest.mark.parametrize("engine,n,tm", [("chain", 256, True), ("kern2", 4096, True),
                                         ("stages", 256, True), ("fused2", 256, False),
                                         ("tmajor", 256, False), ("stages", 256, False),
                                         ("b10", 4096, True)])
def test_every_engine_gradient_matches_torch_fft(engine, n, tm, monkeypatch):
    """Function 1 on each engine the card can route to (forced), held to
    complex128 torch.fft autograd: the gradient of Re<c, FFT(x)> is the
    unscaled backward transform of c."""

    plan = pt.new_setup(n)
    b = 3
    shape = (n, b) if tm else (b, n)
    re, im = (torch.from_numpy(_real(shape, s)).requires_grad_(True) for s in (25, 26))
    cr, ci = torch.from_numpy(_real(shape, 27)), torch.from_numpy(_real(shape, 28))
    if engine == "b10":
        yr, yi = D.cfft_ksplit2_tmajor(plan, re, im, conf=(1024, n // 1024))
    else:  # forced for the forward and the backward
        monkeypatch.setattr(D, "_FORCED", engine)
        yr, yi = D.cfft_dispatch(plan, re, im, time_major=tm)
    gr, gi = torch.autograd.grad((yr, yi), (re, im), (cr, ci))
    dim = 0 if tm else -1
    z = (re.detach().double() + 1j * im.detach().double()).requires_grad_(True)
    y = torch.fft.fft(z, dim=dim)
    c = cr.double() + 1j * ci.double()
    (gz,) = torch.autograd.grad((y.real * c.real + y.imag * c.imag).sum(), z)
    scale = float(gz.abs().max())
    assert max(float((gr - gz.real).abs().max()), float((gi - gz.imag).abs().max())) <= \
        TOL * scale


# ---------------------------------------------------------------------------
# vmap, checkpoint, and the paths with no gradient
# ---------------------------------------------------------------------------


def test_vmap_over_transform_ordered():
    """torch.func.vmap over transform_ordered equals the batched call (the
    reference's test_vmap_over_plans_batch); the real and time-major forms
    too, and a gradient through vmap."""

    plan = pt.new_setup(256)
    x = _real((5, 256), 0) + 1j * _real((5, 256), 1)
    z = torch.from_numpy(x.astype(np.complex64))
    direct = pt.transform_ordered(plan, z)
    vmapped = torch.func.vmap(lambda v: pt.transform_ordered(plan, v))(z)
    assert float((vmapped - direct).abs().max()) <= 1e-6 * float(direct.abs().max())
    rplan = pt.new_setup(128, pt.REAL)
    xs = torch.from_numpy(_real((4, 128, 6), 2))
    sr, si = torch.func.vmap(lambda v: pt.transform_ordered_split_tmajor(rplan, v))(xs)
    wr, wi = pt.transform_ordered_split_tmajor(rplan, xs[3])
    assert float((sr[3] - wr).abs().max()) == 0.0 and float((si[3] - wi).abs().max()) == 0.0
    back = torch.func.vmap(lambda a, b: pt.transform_ordered_split_tmajor(
        rplan, (a, b), pt.BACKWARD))(sr, si)
    assert float((back / 128 - xs).abs().max()) <= 1e-5
    g = torch.func.vmap(torch.func.grad(
        lambda v: pt.transform_ordered_split(rplan, v)[0].sum()))(xs[:, :, :2].mT.contiguous())
    assert g.shape == (4, 2, 128)


def test_checkpoint_around_a_real_transform():
    """torch.utils.checkpoint recomputes the real transform in the backward
    (the reference's test_jit_checkpoint_compose)."""

    plan = pt.new_setup(512, pt.REAL)
    x = torch.from_numpy(_real((4, 512), 3)).requires_grad_(True)

    def f(v):
        s = pt.transform_ordered(plan, v)
        return (s.abs() ** 2).sum()

    y = torch.utils.checkpoint.checkpoint(lambda v: f(v) * 2.0, x, use_reentrant=False)
    (g,) = torch.autograd.grad(y, x)
    x2 = x.detach().clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(f(x2) * 2.0, x2)
    assert float((g - g2).abs().max()) == 0.0
    assert np.isfinite(g.numpy()).all()


def test_no_grad_enters_no_function(monkeypatch):
    """With no input requiring grad, and under torch.no_grad, no Function is
    entered and the outputs carry no grad_fn."""

    def refuse(*a, **k):
        raise AssertionError("an autograd Function was entered")

    for cls in (D._Cfft, tfft._RealForward, tfft._RealBackward, ck._ZconvTmajor,
                ck._ZconvStream, pfb._PfbFir, pfb._PfbStream):
        monkeypatch.setattr(cls, "apply", refuse)
    plan, rplan = pt.new_setup(128), pt.new_setup(128, pt.REAL)
    x = torch.from_numpy(_real((2, 128), 4))
    xg = x.clone().requires_grad_(True)
    ch = tch.Channelizer(16, 4, device=CPU)
    h = _real(20, 5)
    for ctx, v in ((torch.enable_grad(), x), (torch.no_grad(), xg)):
        with ctx:
            outs = [pt.transform_ordered(plan, torch.complex(v, v)),
                    pt.transform_ordered(rplan, v),
                    pt.transform_ordered(rplan, pt.transform_ordered(rplan, v), pt.BACKWARD),
                    *pt.transform_ordered_split_tmajor(plan, (v.T, v.T)),
                    tconv.fastconv_valid(v, h, device=CPU),
                    ch.process(ch.init_state((2,)), torch.complex(v, v))[0]]
        assert all(o.grad_fn is None for o in outs)
