"""``torch.func.vmap`` over the port's FastConv, channelizers, DDCChain and
CIC against ``jax.vmap`` of ``pffft_tpu`` on the same seeded inputs.

Each case maps a leading axis of V = 3 streams through one public call,
with the stateful ones' state mapped (one state per stream, as
``jax.vmap`` maps the reference's with ``in_axes=0``) or shared
(``in_axes=None``, broadcast).  A case is held to ``jax.vmap`` of the
reference (1e-5 of max|ref| in float32, 1e-12 in float64), to the port's
loop of unbatched calls (2e-6), and its per-sample gradients,
``vmap(grad(...))``, to ``jax.vmap(jax.grad(...))`` (1e-5).  On the CPU
every kernel wrapper runs its plain version; the counting tests show that
a vmapped call hands each kernel's entry point one folded call, as one
unbatched call does, with contiguous operands.  The last tests hold each
write that ``vmap`` refused (an in-place write into a fresh tensor) on its
own.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap
from torch.utils._pytree import tree_map

import pffft_tpu as pf
from pffft_tpu import channelizer as rch
from pffft_tpu.dsp import cic as rcic
import pffft_tpu_torch as pt
from pffft_tpu_torch import channelizer as tch
from pffft_tpu_torch.dsp import cic as tcic
from pffft_tpu_torch.ops import conv_kernel as ck
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import pfb_kernel as pfb

CPU = "cpu"
V = 3
F32_TOL, F64_TOL, LOOP_TOL = 1e-5, 1e-12, 2e-6
CIC_RATE = 0.07


def _rng(name):
    return np.random.default_rng([2026, *name.encode()])


def _cplx(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _conv_case(name, taps, length, valid=False):
    r = _rng(name)
    x = r.standard_normal((V, 2, length)).astype(np.float32)
    h = r.standard_normal(taps).astype(np.float32)
    if valid:
        ref = lambda v: pf.conv.fastconv_valid(v, h)
        port = lambda v: pt.conv.fastconv_valid(v, h)
    else:
        ref, port = pf.conv.FastConv(h).apply_batched, pt.conv.FastConv(h, device=CPU).apply_batched
    return types.SimpleNamespace(ref=ref, port=port, args=(x,), state=None, f64=False,
                                 cplx=False)


def _chan_case(name, state, oversampled=False, dtype="float32"):
    r = _rng(name + state)
    m, p = 64, 8
    f64 = dtype == "float64"
    cd = np.complex128 if f64 else np.complex64
    if oversampled:
        rc = rch.OversampledChannelizer(m, 2, p, dtype=dtype)
        tc = tch.OversampledChannelizer(m, 2, p, dtype=dtype, device=CPU)
    else:
        rc = rch.Channelizer(m, p, dtype=dtype)
        tc = tch.Channelizer.from_weights(np.asarray(rc.weights), dtype=dtype, device=CPU)
    shape = (V, p * m) if state == "mapped" else (p * m,)
    hr, hi = (r.standard_normal(shape).astype(np.float64 if f64 else np.float32)
              for _ in range(2))
    return types.SimpleNamespace(
        ref=rc.process, port=tc.process, args=(_cplx(r, (V, 32 * m), cd),), f64=f64,
        cplx=True, state=state,
        ref_state=rch.ChannelizerState(jnp.asarray(hr), jnp.asarray(hi)),
        port_state=tch.state_from_arrays(hr, hi, CPU))


def _ddc_case(name, state):
    r = _rng(name + state)
    taps, decim, rate = 129, 4, 0.11
    h = rch.design_lowpass(taps, 0.5 / decim)
    rd, td = rch.DDCChain(rate, h, decim), tch.DDCChain(rate, h, decim, device=CPU)
    st = rd.init_state()
    if state == "mapped":
        phase = r.integers(0, 1 << 32, V, dtype=np.uint64).astype(np.uint32)
        rate_fp = np.full(V, np.asarray(st.mixer.rate_fp), np.uint32)
        tail = _cplx(r, (V, taps - 1))
    else:
        phase = np.uint32(r.integers(0, 1 << 32, dtype=np.uint64))
        rate_fp, tail = np.asarray(st.mixer.rate_fp), _cplx(r, taps - 1)
    ref_state = rch.DDCState(pf.dsp.mixer.MixerState(jnp.asarray(phase), jnp.asarray(rate_fp)),
                             jnp.asarray(tail))
    return types.SimpleNamespace(
        ref=rd.process, port=td.process, args=(_cplx(r, (V, 4096)),), f64=False, cplx=True,
        state=state, ref_state=ref_state,
        port_state=tch.ddc_state_from_arrays(phase, rate_fp, tail, CPU))


def _cic_case(name, state):
    r = _rng(name + state)
    factor = 16
    rd, td = rcic.CicDDC(factor), tcic.CicDDC(factor, device=CPU)
    shape = (V,) if state == "mapped" else ()
    phase = r.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    hr, hi = (r.standard_normal(shape + (2 * factor,)).astype(np.float32) for _ in range(2))
    return types.SimpleNamespace(
        ref=lambda s, v: rd.apply(s, v, CIC_RATE), port=lambda s, v: td.apply(s, v, CIC_RATE),
        args=(_cplx(r, (V, factor * 300)),), f64=False, cplx=True, state=state,
        ref_state=rcic.CicState(jnp.asarray(phase), jnp.asarray(hr), jnp.asarray(hi)),
        port_state=tcic.state_from_arrays(phase, hr, hi, CPU))


CASE_MAKERS = {
    "fastconv_33": lambda: _conv_case("fastconv_33", 33, 4096),
    "fastconv_1024": lambda: _conv_case("fastconv_1024", 1024, 4096),
    "fastconv_3000": lambda: _conv_case("fastconv_3000", 3000, 8192),
    "fastconv_valid": lambda: _conv_case("fastconv_valid", 21, 2048, valid=True),
}
for _st in ("mapped", "shared"):
    CASE_MAKERS[f"channelizer_{_st}"] = lambda s=_st: _chan_case("channelizer", s)
    CASE_MAKERS[f"oversampled_{_st}"] = lambda s=_st: _chan_case("oversampled", s, True)
    CASE_MAKERS[f"ddc_chain_{_st}"] = lambda s=_st: _ddc_case("ddc_chain", s)
    CASE_MAKERS[f"cic_{_st}"] = lambda s=_st: _cic_case("cic", s)
CASE_MAKERS["oversampled_f64"] = lambda: _chan_case("oversampled_f64", "mapped", True, "float64")
CASES = tuple(CASE_MAKERS)
GRAD_CASES = ("fastconv_33", "fastconv_1024", "fastconv_3000", "fastconv_valid",
              "channelizer_mapped", "oversampled_mapped", "ddc_chain_mapped", "cic_mapped")


def _dims(c):
    return (() if c.state is None else (0 if c.state == "mapped" else None,)) + (0,)


def _port_args(c):
    return (() if c.state is None else (c.port_state,)) + tuple(map(torch.from_numpy, c.args))


def _ref_args(c):
    return (() if c.state is None else (c.ref_state,)) + tuple(map(jnp.asarray, c.args))


def _leaves(out):
    """The array leaves of a call's output, as numpy (integers as int64)."""

    leaves = jax.tree_util.tree_leaves(
        tree_map(lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else t, out))
    return [np.asarray(a).astype(np.int64) if np.issubdtype(np.asarray(a).dtype, np.integer)
            else np.asarray(a) for a in leaves]


def _loop(c):
    """The port's unbatched calls, one a stream, stacked."""

    args = _port_args(c)
    dims = _dims(c)
    rows = [c.port(*(a if d is None else tree_map(lambda t: t[i], a)
                     for a, d in zip(args, dims))) for i in range(V)]
    return tree_map(lambda *ts: torch.stack(ts) if isinstance(ts[0], torch.Tensor)
                    else torch.tensor(ts), *rows)


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


@pytest.fixture(scope="module")
def cases():
    return {name: make() for name, make in CASE_MAKERS.items()}


@pytest.mark.parametrize("name", CASES)
def test_vmap_matches_jax_vmap(cases, name):
    c = cases[name]
    got = vmap(c.port, in_dims=_dims(c))(*_port_args(c))
    want = jax.vmap(c.ref, in_axes=_dims(c))(*_ref_args(c))
    _close(_leaves(got), _leaves(want), F64_TOL if c.f64 else F32_TOL)


@pytest.mark.parametrize("name", CASES)
def test_vmap_matches_loop_of_calls(cases, name):
    c = cases[name]
    got = vmap(c.port, in_dims=_dims(c))(*_port_args(c))
    _close(_leaves(got), _leaves(_loop(c)), LOOP_TOL)


def _port_loss(c):
    """(loss of the real input planes and the weights, number of planes)."""

    def call(*a):
        st, xs, ws = a[:-2], a[-2], a[-1]
        y = c.port(*st, xs)
        y = y[0] if isinstance(y, tuple) else y
        return (torch.view_as_real(y) * ws).sum() if y.is_complex() else (y * ws).sum()

    if c.cplx:
        return lambda *a: call(*a[:-3], torch.complex(a[-3], a[-2]), a[-1]), 2
    return call, 1


def _ref_loss(c):
    def call(*a):
        st, xs, ws = a[:-2], a[-2], a[-1]
        y = c.ref(*st, xs)
        y = y[0] if isinstance(y, tuple) else y
        if jnp.iscomplexobj(y):
            return jnp.sum(jnp.real(y) * ws[..., 0]) + jnp.sum(jnp.imag(y) * ws[..., 1])
        return jnp.sum(y * ws)

    if c.cplx:
        return lambda *a: call(*a[:-3], jax.lax.complex(a[-3], a[-2]), a[-1]), 2
    return call, 1


@pytest.mark.parametrize("name", GRAD_CASES)
def test_vmap_of_grad_matches_jax(cases, name):
    c = cases[name]
    x = c.args[0]
    planes = (x.real.copy(), x.imag.copy()) if c.cplx else (x,)
    y = vmap(c.port, in_dims=_dims(c))(*_port_args(c))
    y = y[0] if isinstance(y, tuple) else y
    w = _rng(name + "w").standard_normal(tuple(torch.view_as_real(y).shape) if y.is_complex()
                                         else tuple(y.shape)).astype(np.float32)
    st = () if c.state is None else (c.port_state,)
    rst = () if c.state is None else (c.ref_state,)
    loss, n = _port_loss(c)
    argnums = tuple(range(len(st), len(st) + n))
    dims = _dims(c)[:-1] + (0,) * (n + 1)
    got = vmap(grad(loss, argnums=argnums), in_dims=dims)(
        *st, *map(torch.from_numpy, planes), torch.from_numpy(w))
    rloss, _ = _ref_loss(c)
    want = jax.vmap(jax.grad(rloss, argnums=argnums), in_axes=dims)(
        *rst, *map(jnp.asarray, planes), jnp.asarray(w))
    _close(_leaves(got), _leaves(want), F32_TOL)
    loop = [grad(loss, argnums=argnums)(*(tree_map(lambda t: t[i], s) for s in st),
                                        *(torch.from_numpy(p[i]) for p in planes),
                                        torch.from_numpy(w[i])) for i in range(V)]
    _close(_leaves(got), [np.stack(t) for t in zip(*(_leaves(r) for r in loop))], LOOP_TOL)


# the entry points a kernel wrapper's work reaches on the CPU: each vmapped
# call hands each one call, as one unbatched call does
IMPLS = ((ck, "_zconv_stream"), (ck, "_zconv_tmajor"), (pfb, "_pfb_fir_stream"),
         (pfb, "_pfb_fir"), (D, "_cfft_dispatch"))


@pytest.fixture
def impl_calls(monkeypatch):
    """Records, per entry point, each call's operands' layout (contiguous,
    or unit inner stride for the stream map's rows, which it reads in
    place)."""

    seen = {name: [] for _, name in IMPLS}

    def wrap(name, fn):
        def counted(*a, **k):
            ts = [t for t in a if isinstance(t, torch.Tensor)]
            ts += [t for p in a if isinstance(p, tuple) for t in p if isinstance(t, torch.Tensor)]
            if name == "_pfb_fir_stream":
                seen[name].append(all(t.stride(-1) == 1 for t in ts))
            else:
                seen[name].append(all(t.is_contiguous() for t in ts))
            return fn(*a, **k)
        return counted

    for mod, name in IMPLS:
        monkeypatch.setattr(mod, name, wrap(name, getattr(mod, name)))
    return seen


@pytest.mark.parametrize("name", CASES)
def test_vmap_folds_into_one_call_per_kernel(cases, name, impl_calls):
    c = cases[name]
    args = _port_args(c)
    dims = _dims(c)
    c.port(*(a if d is None else tree_map(lambda t: t[0], a) for a, d in zip(args, dims)))
    one = {k: len(v) for k, v in impl_calls.items()}
    for v in impl_calls.values():
        v.clear()
    vmap(c.port, in_dims=dims)(*args)
    assert {k: len(v) for k, v in impl_calls.items()} == one
    assert all(all(v) for v in impl_calls.values()), impl_calls
    if not (c.f64 or name.startswith("cic")):  # the CIC is a matmul, no kernel
        assert sum(one[n] for n in ("_zconv_stream", "_pfb_fir_stream", "_cfft_dispatch")) > 0


def test_vmap_over_streaming_conv_frames_folds_into_one_column_map_call(impl_calls):
    """StreamingConv's block step (its frames through B7's column map) over
    the frames of V streams."""

    sc = pt.conv.StreamingConv(_rng("sc").standard_normal(129), device=CPU)
    frames = torch.from_numpy(_rng("scx").standard_normal((V, 6, sc.setup.nfft)).astype(
        np.float32))
    got = vmap(sc._filter)(frames)
    assert impl_calls["_zconv_tmajor"] == [True]
    want = torch.stack([sc._filter(f) for f in frames])
    assert float((got - want).abs().max()) <= LOOP_TOL * float(want.abs().max())


def test_vmap_of_a_mapped_filter_spectrum_raises():
    fc = pt.conv.FastConv(np.ones(33, np.float32), device=CPU)
    plan = D.conv_kernel_choice(fc.nfft, 1, torch.device(CPU))[0]
    hfr, hfi = fc._spectrum(torch.device(CPU))
    x = torch.zeros((V, 1, 1024))
    with pytest.raises(ValueError, match="filter spectrum"):
        vmap(lambda v, h: ck.zconv_stream(plan, v, h, hfi, fc.num_out_per_block, 512,
                                          fc._adjoint(torch.device(CPU))))(
            x, hfr.expand(V, -1))
    w = torch.ones((8, 64))
    with pytest.raises(ValueError, match="polyphase weights"):
        vmap(lambda r, ww: pfb.pfb_fir(r, ww, 4))(torch.zeros((V, 16, 64)), w.expand(V, 8, 64))


# each write that vmap refused, on its own: an in-place write of a mapped
# tensor into a fresh one


def test_ddc_chain_stream_is_built_out_of_place():
    c = _ddc_case("ddc_inplace", "shared")
    ddc = tch.DDCChain(0.11, rch.design_lowpass(129, 0.125), 4, device=CPU)
    x = torch.from_numpy(c.args[0])
    y, st = vmap(ddc.process, in_dims=(None, 0))(ddc.init_state(), x)
    want = torch.stack([ddc.process(ddc.init_state(), v)[0] for v in x])
    assert torch.equal(y, want) and st.tail.shape == (V, 128)


def test_cic_stream_is_built_out_of_place():
    c = _cic_case("cic_inplace", "shared")
    cic = tcic.CicDDC(16, device=CPU)
    x = torch.from_numpy(c.args[0])
    y, st = vmap(lambda v: cic.apply(cic.init_state(), v, CIC_RATE))(x)
    want = torch.stack([cic.apply(cic.init_state(), v, CIC_RATE)[0] for v in x])
    assert torch.equal(y, want) and st.phase_fp.shape == (V,)


def test_stream_conv_columns_are_built_out_of_place():
    fr, fi = (torch.randn((V, 3, 5, 16)) for _ in range(2))
    got = vmap(ck.columns)(fr, fi)
    want = [ck.columns(fr[i], fi[i]) for i in range(V)]
    for g, w in zip(got, zip(*want)):
        assert torch.equal(g, torch.stack(w)) and g.shape == (V, 16, 16)


def test_stream_conv_unpacked_pairs_are_built_out_of_place():
    yr, yi = (torch.randn((V, 16, 12)) for _ in range(2))
    got = vmap(lambda a, b: ck.unpack_pairs(a, b, 8, 3, 4))(yr, yi)
    want = torch.stack([ck.unpack_pairs(yr[i], yi[i], 8, 3, 4) for i in range(V)])
    assert torch.equal(got, want) and got.shape == (V, 3, 8, 8)


def test_oversampled_residues_are_stacked_out_of_place():
    # float64 runs no kernel: the residues' interleave alone
    c = _chan_case("oversampled_inplace", "shared", True, "float64")
    y, _ = vmap(c.port, in_dims=(None, 0))(c.port_state, torch.from_numpy(c.args[0]))
    assert y.shape == (V, 2 * 32, 64)
