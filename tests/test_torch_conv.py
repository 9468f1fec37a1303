"""The port's overlap-save FIR filtering, pffft_tpu_torch.conv, and its
fused spectral-conv kernel's plain version, against pffft_tpu on the same
numpy inputs; the conv routes and the error messages.

On the CPU the kernel wrapper runs its plain version over the routes the
card takes (FastConv's streams "fused", the kernel's stream map, for nfft
<= 16384; the column pipeline, StreamingConv's frames, "fused" for nfft <=
2048; "tmajor" above); the reference's Pallas kernel runs in interpret
mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pffft_tpu as pf
from pffft_tpu import conv as rconv
from pffft_tpu import runtime as rruntime
from pffft_tpu.ops import conv_kernel as rck
from pffft_tpu.ops import pallas_fft as rpk
import pffft_tpu_torch as pt
from pffft_tpu_torch import conv as tconv
from pffft_tpu_torch import runtime as truntime
from pffft_tpu_torch.ops import _build as tbuild
from pffft_tpu_torch.ops import conv_kernel as tck
from pffft_tpu_torch.ops import dispatch as D
from pffft_tpu_torch.ops import fused_stage as tfs
from pffft_tpu_torch.ops import pallas_fft as tpk
from pffft_tpu_torch.utils import profiling as tprof

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CPU = "cpu"
# the plain kernel vs the interpret-mode Pallas kernel, relative to max|ref|:
# the same f32 stage chain on both sides, rounded in another order
KERNEL_TOL = 2e-6
# FastConv vs the reference, relative to max|ref|: two f32 FFT pipelines
# (the reference's batch-major XLA engine, the port's time-major routes)
TOL = 1e-5
F_ = tconv.ConvFlags
FLAG_SETS = {
    "real": F_.NONE,
    "correlation": F_.CORRELATION,
    "cplx_inp_out": F_.CPLX_INP_OUT,
    "cplx_single_fft": F_.CPLX_INP_OUT | F_.CPLX_SINGLE_FFT,
    "cplx_filter": F_.CPLX_INP_OUT | F_.CPLX_FILTER,
    "cplx_filter_correlation": F_.CPLX_FILTER | F_.CORRELATION,
}


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _inputs(flags, flen, length, seed, lead=()):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(flen).astype(np.float32)
    if flags & F_.CPLX_FILTER:
        h = (h + 1j * rng.standard_normal(flen)).astype(np.complex64)
    x = rng.standard_normal((*lead, length)).astype(np.float32)
    if flags & (F_.CPLX_INP_OUT | F_.CPLX_FILTER):
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    return h, x


# ---------------------------------------------------------------------------
# The kernel's plain version and the filter spectrum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 256, 480])
@pytest.mark.parametrize("filt", ["complex", "real_two_frames"])
def test_zconv_plain_matches_reference_kernel(n, filt):
    rng = np.random.default_rng(n)
    b = 256
    h = rng.standard_normal(17)
    if filt == "complex":
        h = h + 1j * rng.standard_normal(17)
    rplan = pf.new_setup(n, pf.COMPLEX, factors=rpk.thin_factors(n), strict=False)
    hfr, hfi = rck.filter_spectrum(rplan, h)
    re = rng.standard_normal((n, b)).astype(np.float32)
    im = rng.standard_normal((n, b)).astype(np.float32)
    er, ei = rck.zconv_pallas_tmajor(rplan, re, im, hfr, hfi, tb=128, interpret=True)
    er, ei = np.asarray(er), np.asarray(ei)
    tplan = D._thin_plan(n)
    args = [torch.from_numpy(a) for a in (re, im, hfr, hfi)]
    scale = max(np.abs(er).max(), np.abs(ei).max())
    for fn in (tck.zconv_tmajor_plain, tck.zconv_tmajor):  # the wrapper takes the plain
        gr, gi = fn(tplan, *args)                          # version on the CPU
        assert np.abs(gr.numpy() - er).max() <= KERNEL_TOL * scale
        assert np.abs(gi.numpy() - ei).max() <= KERNEL_TOL * scale


@pytest.mark.parametrize("n", [64, 480, 8192])
@pytest.mark.parametrize("cplx", [False, True])
def test_filter_spectrum_is_bit_exact(n, cplx):
    rng = np.random.default_rng(n + cplx)
    h = rng.standard_normal(n // 2)
    if cplx:
        h = h + 1j * rng.standard_normal(n // 2)
    ref = rck.filter_spectrum(pf.new_setup(n, pf.COMPLEX, strict=False), h)
    got = tck.filter_spectrum(pt.new_setup(n, pt.COMPLEX, strict=False), h)
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == np.float32 and np.array_equal(g, r)


def test_cpu_wrapper_launches_nothing():
    plan = D._thin_plan(64)
    re = torch.zeros((64, 8))
    hf = torch.zeros(64)
    before = tck.zconv_tmajor.launches, tck.zconv_stream.launches
    tck.zconv_tmajor(plan, re, re, hf, hf)
    tck.zconv_stream(plan, torch.zeros((2, 300)), hf, hf, 40, 200)
    assert (tck.zconv_tmajor.launches, tck.zconv_stream.launches) == before


# ---------------------------------------------------------------------------
# The stream map: the framing, block convolution and valid-sample slice
# of FastConv's fused route in one kernel call
# ---------------------------------------------------------------------------


def _old_stream_composition(plan, x, hfr, hfi, u, total):
    """FastConv's fused route as it stood before the stream map, written out:
    frames zero-padded past the end, columns padded to a multiple of 4, the
    column map's plain version, the valid samples back out."""

    import torch.nn.functional as F

    nfft = plan.n
    r = x.shape[0]

    def frames(s, nb):
        need = (nb - 1) * u + nfft
        if s.shape[-1] < need:
            s = F.pad(s, (0, need - s.shape[-1]))
        return s[:, :need].unfold(-1, nfft, u)

    def cols(fr, fi):
        c = fr.shape[1]
        out = []
        for f in (fr, fi):
            p = torch.zeros((nfft, -(-(r * c) // 4) * 4), dtype=f.dtype)
            p[:, : r * c].view(nfft, r, c).copy_(f.permute(2, 0, 1))
            out.append(p)
        return out

    def keep(y, c):
        return y[:u, : r * c].view(u, r, c).permute(1, 2, 0)

    nb = -(-total // u)
    if not x.is_complex():
        nb += nb & 1
        v = frames(x, nb)
        yr, yi = tck.zconv_tmajor_plain(plan, *cols(v[:, 0::2], v[:, 1::2]), hfr, hfi)
        out = torch.empty((r, nb // 2, 2, u), dtype=yr.dtype)
        out[:, :, 0] = keep(yr, nb // 2)
        out[:, :, 1] = keep(yi, nb // 2)
        return out.view(r, nb, u).reshape(r, -1)[:, :total]
    yr, yi = tck.zconv_tmajor_plain(plan, *cols(frames(x.real, nb), frames(x.imag, nb)),
                                    hfr, hfi)
    return torch.complex(keep(yr, nb).reshape(r, -1)[:, :total],
                         keep(yi, nb).reshape(r, -1)[:, :total])


# (nfft, u, rows, L, total short of a whole frame by): real mode with an even
# and an odd number of frames, a ragged last frame, R = 1 and 3
STREAM_CASES = [(64, 33, 1, 400, 0), (64, 33, 3, 400, 5), (128, 65, 3, 65 * 9 + 63, 0),
                (480, 200, 1, 2880, 0), (480, 200, 3, 2880, 17)]


@pytest.mark.parametrize("n,u,rows,length,short", STREAM_CASES)
@pytest.mark.parametrize("mode", ["real", "complex", "complex_filter"])
def test_stream_map_plain_equals_old_composition(n, u, rows, length, short, mode):
    rng = np.random.default_rng(n + rows + length)
    h = rng.standard_normal(n - u + 1)
    x = rng.standard_normal((rows, length)).astype(np.float32)
    if mode != "real":
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    if mode == "complex_filter":
        h = h + 1j * rng.standard_normal(h.size)
    plan = D._thin_plan(n)
    hfr, hfi = (torch.from_numpy(a) for a in tck.filter_spectrum(plan, h))
    xt = torch.from_numpy(x)
    total = length - (n - u) - short
    want = _old_stream_composition(plan, xt, hfr, hfi, u, total)
    before = tck.zconv_stream.launches
    for fn in (tck.zconv_stream_plain, tck.zconv_stream):  # the wrapper takes the plain
        got = fn(plan, xt, hfr, hfi, u, total)              # version on the CPU
        assert got.shape == (rows, total) and got.dtype == xt.dtype
        assert torch.equal(got, want)
    assert tck.zconv_stream.launches == before


def test_stream_map_rejects_bad_arguments():
    plan = D._thin_plan(64)
    hf = torch.zeros(64)
    x = torch.zeros((2, 300))
    with pytest.raises(ValueError, match="hop"):
        tck.zconv_stream(plan, x, hf, hf, 65, 100)
    with pytest.raises(ValueError, match="hop"):
        tck.zconv_stream(plan, x, hf, hf, 0, 100)
    with pytest.raises(ValueError, match=r"\[R, L\]"):
        tck.zconv_stream(plan, x[0], hf, hf, 40, 100)
    with pytest.raises(ValueError, match="filter spectrum"):
        tck.zconv_stream(plan, x, hf[:32], hf[:32], 40, 100)


def _ring(*shape):
    return torch.arange(float(np.prod(shape))).reshape(shape)


# view -> (rows the stream map reads in place [R, L] and their row stride, or
# None where only a copy gives such rows)
STREAM_ROW_VIEWS = {
    "contiguous": (lambda: _ring(3, 40), ((3, 40), 40)),
    "column_slice": (lambda: _ring(3, 101)[:, 7:47], ((3, 40), 101)),
    "one_row_slice": (lambda: _ring(1, 101)[:, 7:47], ((1, 40), 101)),
    "inner_stride_2": (lambda: _ring(3, 80)[:, ::2], None),
    "overlapping_rows": (lambda: _ring(200).as_strided((3, 40), (20, 1)), None),
    "collapsible_3d": (lambda: _ring(2, 3, 50)[:, :, 3:43], ((6, 40), 50)),
    "non_collapsible_3d": (lambda: _ring(2, 4, 40)[:, 1:4], None),
}


@pytest.mark.parametrize("case", sorted(STREAM_ROW_VIEWS))
def test_stream_rows_reads_views_in_place(case):
    """The stream map's rows: a view whose rows it reads where they lie
    (unit inner stride, rows at least L apart, leading dims that collapse)
    is taken as it is; any other needs a copy.  On the CPU FastConv's rows
    helper copies every non-contiguous view and counts it, as before."""

    make, want = STREAM_ROW_VIEWS[case]
    x = make()
    rows = tck.stream_rows(x)
    if want is None:
        assert rows is None
    else:
        assert (tuple(rows.shape), rows.stride(0), rows.stride(1)) == (*want, 1)
        assert rows.data_ptr() == x.data_ptr()
        assert torch.equal(rows, x.reshape(rows.shape))
    if x.ndim == 2:
        before = tprof.counters.get("entry.copy_bytes", 0)
        got = tconv._stream_rows(x)
        assert got.is_contiguous() and torch.equal(got, x)
        copied = 0 if x.is_contiguous() else x.nbytes
        assert tprof.counters.get("entry.copy_bytes", 0) - before == copied


def test_stream_map_signature_matches_its_source():
    """pf_conv_stream's ctypes argument types against its C parameters:
    six pointers, fifteen ints (the row stride ld after len), the stream."""

    src = (tbuild.CSRC / "conv_fused.cu").read_text()
    params = src.split("int pf_conv_stream(", 1)[1].split(")", 1)[0]
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    argtypes = tpk._SIGNATURES["pf_conv_stream"][1]
    assert len(argtypes) == len(names) == 22
    assert names[names.index("len") + 1] == "ld"
    assert [t is tpk._P for t in argtypes] == [
        n in ("x", "y", "hfr", "hfi", "tw", "desc", "stream") for n in names]


# ---------------------------------------------------------------------------
# FastConv against the reference
# ---------------------------------------------------------------------------


# pffastconv block negotiation (the reference's tests/test_fastconv.py table)
@pytest.mark.parametrize(
    "filter_len,block_len,expect_nfft",
    [(16, 0, 32), (17, 0, 32), (33, 0, 64), (128, 0, 256), (4, 0, 32), (32, 1024, 1024),
     (32, 1000, 1024)],
)
def test_block_negotiation(filter_len, block_len, expect_nfft):
    assert tconv._negotiate_nfft(filter_len, block_len) == expect_nfft
    assert tconv._negotiate_nfft(filter_len, block_len) == rconv._negotiate_nfft(
        filter_len, block_len)
    s = tconv.FastConv(np.ones(filter_len, np.float32), block_len=block_len, device=CPU)
    r = rconv.FastConv(np.ones(filter_len, np.float32), block_len=block_len)
    assert s.block_len == s.nfft == expect_nfft
    assert (s.num_out_per_block, s.filter_span) == (r.num_out_per_block, r.filter_span)


def _routes(fc):
    """The default route, and the other one where the kernel covers nfft."""

    default = D.conv_route_mode(fc.nfft, stream=True)
    return [None] + (["tmajor"] if default == "fused" else [])


@pytest.mark.parametrize("flen", [4, 16, 53, 128, 1024, 4096])
@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_fastconv_matches_reference(name, flen):
    flags = FLAG_SETS[name]
    h, x = _inputs(flags, flen, 3 * max(flen, 32) + 117, flen + int(flags))
    ref = rconv.FastConv(h, flags=flags)
    for flush in (True, False):
        ry, rc = ref.apply(jnp.asarray(x), flush=flush)
        fc = tconv.FastConv(h, flags=flags, device=CPU)
        assert fc.nfft == ref.nfft and fc.num_out_per_block == ref.num_out_per_block
        for route in _routes(fc):
            fc._force_conv_kernel = route
            y, consumed = fc.apply(x, flush=flush)
            assert consumed == rc, (flush, route)
            assert y.shape == (consumed,) and y.is_complex() == np.iscomplexobj(ry)
            assert _rel(y.numpy(), ry) <= TOL, (flush, route)


@pytest.mark.parametrize("name", ["real", "cplx_inp_out", "cplx_single_fft", "cplx_filter"])
def test_apply_batched_matches_reference(name):
    flags = FLAG_SETS[name]
    h, x = _inputs(flags, 33, 700, 5, lead=(2, 3))
    want = np.asarray(rconv.FastConv(h, flags=flags).apply_batched(jnp.asarray(x)))
    got = tconv.FastConv(h, flags=flags, device=CPU).apply_batched(x)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= TOL


# (flags, taps, rows, L): real and complex filters, CPLX_INP_OUT,
# CPLX_SINGLE_FFT and CORRELATION on the fused route (the stream map) at R = 1
# and 3, with lengths that leave a ragged last frame and, in real mode, an odd
# number of frames
STREAM_RUNS = [("real", 33, 1, 700), ("real", 33, 3, 64 * 31 + 13),
               ("correlation", 40, 3, 1001), ("cplx_inp_out", 33, 1, 777),
               ("cplx_single_fft", 33, 3, 640), ("cplx_filter", 20, 3, 555),
               ("cplx_filter_correlation", 20, 1, 601), ("real", 2100, 3, 9001),
               ("cplx_single_fft", 1100, 1, 5000)]


@pytest.mark.parametrize("name,flen,rows,length", STREAM_RUNS)
def test_fused_route_stream_map_matches_reference(name, flen, rows, length):
    flags = FLAG_SETS[name]
    h, x = _inputs(flags, flen, length, flen + rows, lead=(rows,))
    fc = tconv.FastConv(h, flags=flags, device=CPU)
    assert D.conv_route_mode(fc.nfft, stream=True) == "fused"
    want = np.asarray(rconv.FastConv(h, flags=flags).apply_batched(jnp.asarray(x)))
    got = fc.apply_batched(x)
    assert got.shape == want.shape and got.shape[-1] == length - flen + 1
    assert _rel(got.numpy(), want) <= TOL
    fc._force_conv_kernel = "tmajor"  # the same pipeline composed of copies
    assert _rel(fc.apply_batched(x).numpy(), got.numpy()) <= TOL


def test_interleaved_float_input_is_a_complex_stream():
    h, x = _inputs(F_.CPLX_INP_OUT, 20, 500, 6)
    fc = tconv.FastConv(h, flags=F_.CPLX_INP_OUT, device=CPU)
    inter = np.stack([x.real, x.imag], axis=-1).reshape(-1)
    a, ca = fc.apply(x, flush=True)
    b, cb = fc.apply(inter, flush=True)
    assert ca == cb and torch.equal(a, b)


@pytest.mark.parametrize("flen", [32, 128])
def test_streaming_contract(flen):
    """Chunked apply with the remainder carried == the one-shot result."""

    rng = np.random.default_rng(flen)
    x = rng.standard_normal(10000).astype(np.float32)
    h = rng.standard_normal(flen).astype(np.float32)
    fc = tconv.FastConv(h, device=CPU)
    full, full_consumed = fc.apply(x, flush=True)
    out, buf, pos = [], np.zeros(0, np.float32), 0
    while pos < x.size:
        buf = np.concatenate([buf, x[pos:pos + 1500]])
        pos += 1500
        y, consumed = fc.apply(buf, flush=pos >= x.size)
        out.append(y.numpy())
        buf = buf[consumed:]
    stream = np.concatenate(out)
    assert stream.shape[0] == full_consumed
    np.testing.assert_allclose(stream, full.numpy(), atol=1e-4)


@pytest.mark.parametrize("flen,block_len", [(17, 0), (65, 0), (65, 512)])
def test_streaming_conv_matches_reference(flen, block_len):
    rng = np.random.default_rng(flen + block_len)
    h = rng.standard_normal(flen).astype(np.float32)
    x = rng.standard_normal(6000).astype(np.float32)
    ref = rconv.StreamingConv(h, block_len=block_len)
    got = tconv.StreamingConv(h, block_len=block_len, device=CPU)
    assert got.native is truntime.HAVE_NATIVE
    pos = 0
    while pos < x.size:
        step = int(rng.integers(100, 900))
        a, b = ref.push(x[pos:pos + step]), got.push(x[pos:pos + step])
        assert isinstance(b, np.ndarray) and b.shape == a.shape
        if a.size:
            assert _rel(b, a) <= TOL
        pos += step
    a, b = ref.flush(), got.flush()
    assert b.shape == a.shape
    if a.size:
        assert _rel(b, a) <= TOL


@pytest.mark.parametrize("flen", [1100, 2100])  # nfft 4096, 8192
def test_column_pipeline_composes_past_the_chain(flen, monkeypatch):
    """Past the chain's nfft 2048 the column pipeline (StreamingConv's
    frames, ``FastConv._block_conv``) takes the composed route and no kernel
    map, matching the reference, while FastConv's streams at the same nfft
    take the stream map."""

    seen = []
    for name in ("zconv_tmajor", "zconv_stream"):
        real = getattr(tck, name)
        monkeypatch.setattr(tck, name, lambda *a, _f=real, _n=name, **k: seen.append(_n) or
                            _f(*a, **k))
    rng = np.random.default_rng(flen)
    h = rng.standard_normal(flen).astype(np.float32)
    x = rng.standard_normal(5 * flen + 3001).astype(np.float32)
    got = tconv.StreamingConv(h, device=CPU)
    nfft = got.setup.nfft
    assert D.conv_route_mode(nfft) == "tmajor" and D.conv_kernel_choice(nfft, 1) is None
    ref = rconv.StreamingConv(h)
    a = np.concatenate([ref.push(x[:4000]), ref.push(x[4000:]), ref.flush()])
    b = np.concatenate([got.push(x[:4000]), got.push(x[4000:]), got.flush()])
    assert b.shape == a.shape and _rel(b, a) <= TOL
    assert seen == []
    want = np.asarray(rconv.FastConv(h).apply_batched(jnp.asarray(x[None])))
    y = got.setup.apply_batched(x[None])
    assert seen == ["zconv_stream"] and _rel(y.numpy(), want) <= TOL


def test_stream_framer_matches_reference():
    rng = np.random.default_rng(9)
    ref = rruntime.StreamFramer(frame_len=64, hop=40)
    got = truntime.StreamFramer(frame_len=64, hop=40)
    for n in (10, 100, 3, 250, 7):
        chunk = rng.standard_normal(n).astype(np.float32)
        assert got.push(chunk) == ref.push(chunk)
        assert got.pending() == ref.pending()
        np.testing.assert_array_equal(got.frames(), ref.frames())
    np.testing.assert_array_equal(got.flush(), ref.flush())
    assert got.pending() == ref.pending() == 0
    assert got.flush().shape == (0, 64)
    with pytest.raises(ValueError, match="hop"):
        truntime.StreamFramer(frame_len=8, hop=9)


def test_one_shot_helpers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 2, 1000)).astype(np.float32)
    h = rng.standard_normal(17).astype(np.float32)
    want = np.asarray(rconv.fastconv_valid(jnp.asarray(x), h))
    got = tconv.fastconv_valid(x, h, device=CPU)
    assert got.shape == want.shape == (3, 2, 1000 - 17 + 1)
    assert _rel(got.numpy(), want) <= TOL
    assert torch.equal(tconv.fastconv_valid(torch.from_numpy(x), h), got)  # tensor: stays
    s = tconv.new_setup(h, block_len=512, device=CPU)
    r = rconv.new_setup(h, block_len=512)
    assert s.block_len == r.block_len == 512
    y, consumed = tconv.apply(s, x[0, 0], flush=True)
    ry, rc = rconv.apply(r, jnp.asarray(x[0, 0]), flush=True)
    assert consumed == rc and _rel(y.numpy(), ry) <= TOL
    assert tconv.new_setup(h, filter_len=9, device=CPU).filter_len == 9


def test_short_input_consumes_nothing():
    fc = tconv.FastConv(np.ones(32, np.float32), device=CPU)
    y, consumed = fc.apply(np.zeros(fc.nfft - 1, np.float32), flush=False)
    assert consumed == 0 and y.shape == (0,)
    y, consumed = fc.apply(np.zeros(fc.nfft, np.float32), flush=False)
    assert consumed == fc.num_out_per_block
    fcx = tconv.FastConv(np.ones(8), flags=F_.CPLX_INP_OUT | F_.CPLX_SINGLE_FFT, device=CPU)
    y, consumed = fcx.apply(np.zeros(3, np.complex64), flush=True)
    assert consumed == 0 and y.shape == (0,) and y.is_complex()


# ---------------------------------------------------------------------------
# Routes and errors
# ---------------------------------------------------------------------------


@pytest.fixture
def clean_conv_state():
    yield
    D.set_engine(None)


# the stream map's route (FastConv's streams): B9's rows, nfft <= 16384
STREAM_ROUTE = {32: "fused", 128: "fused", 2048: "fused", 4096: "fused", 8192: "fused",
                16384: "fused", 32768: "tmajor"}


# route: the column pipeline's (the chain's coverage, nfft <= 2048)
@pytest.mark.parametrize("nfft,route", [(32, "fused"), (128, "fused"), (2048, "fused"),
                                        (4096, "tmajor"), (8192, "tmajor"), (16384, "tmajor"),
                                        (32768, "tmajor")])
def test_conv_route_follows_coverage(nfft, route):
    assert D.conv_route_mode(nfft) == route
    assert D.conv_route_mode(nfft, stream=True) == STREAM_ROUTE[nfft]
    tile = tck.stream_tile(nfft)
    assert (tile is not None) == (STREAM_ROUTE[nfft] == "fused")
    if tile is not None:
        assert tile.threads * tile.elems >= tile.rows * nfft  # whole rows a block
    choice = D.conv_kernel_choice(nfft, 10)
    if route == "fused":
        plan, tile = choice
        radices = [st.r for st in plan.stages if st.r != 1]
        assert plan.n == nfft and tile == tck.column_tile(plan)
        assert tile == tpk.chain_core_tile(plan, elems=16)  # B1's planner at 16 values
        assert tpk.chain_tile(nfft, radices) is not None  # the coverage is the chain's
    else:
        assert choice is None
    assert D.conv_kernel_choice(nfft, 0) is None


@pytest.mark.parametrize("n", [32, 64, 480, 2048, 4096, 8192, 16384, 32768])
def test_stream_tile_is_b9_rows_but_at_8192(n):
    """The stream map launches B9's rows, except one row of 512 threads x 16
    values at nfft 8192 (the faster shape on the H100, where its plan opens
    with a radix-32 stage); every other length keeps B9's shape exactly,
    and nothing past 16384."""

    t, b9 = tck.stream_tile(n), tfs.fused2_tile(n)
    if n == 32768:
        assert t is None and b9 is None
    elif n != 8192:
        assert t == b9
    else:
        assert (t.rows, t.threads, t.elems, t.blocks_per_sm) == (1, 512, 16, 1)
        assert (b9.threads, b9.elems) == (256, 32)
        assert t._replace(threads=256, elems=32, blocks_per_sm=b9.blocks_per_sm) == b9


# n -> the stream map's factors where they differ from the thin plan's
STREAM_R32 = {8192: (32, 16, 16)}


@pytest.mark.parametrize("n", [32, 64, 480, 1000, 2048, 4096, 8192, 16384, 32768])
def test_stream_plan_takes_radix32_only_where_it_saves_a_stage(n):
    """The stream map's plan is the thin plan exactly, except at nfft 8192:
    three stages, one of them radix 32, one stage fewer than 16*16*16*2."""

    plan, thin = tck.stream_plan(n), tpk.thin_plan(n)
    if n not in STREAM_R32:
        assert plan is thin
        return
    radices = [st.r for st in plan.stages if st.r != 1]
    assert plan.n == n and tuple(radices) == plan.factors == STREAM_R32[n]
    assert radices.count(32) == 1 and len(radices) == 3
    assert len([st for st in thin.stages if st.r != 1]) == 4
    assert not tpk.supported(plan)  # the chain kernels refuse it
    assert tpk.supported(thin) and thin.factors == tpk.thin_factors(n) == (16, 16, 16, 2)


def test_radix32_stays_out_of_the_chain_kernels():
    """The chain's radices, thin plans and checks are as they were: a
    radix-32 plan handed to B1 (or B9 in internal order) is refused before
    any launch; the stream map takes it."""

    assert tpk.CHAIN_RADICES == (2, 3, 4, 5, 8, 16)
    assert tpk.thin_factors(8192) == (16, 16, 16, 2)
    assert tpk.thin_factors(16384) == (16, 16, 16, 4)
    plan = tck.stream_plan(8192)
    re = torch.zeros((8192, 4))
    before = tpk.cfft_chain_tmajor.launches, tfs.cfft_fused2.launches
    with pytest.raises(ValueError, match="chain kernel does not run"):
        tpk.cfft_chain_tmajor(plan, re, re)
    with pytest.raises(ValueError, match="not a two-stage plan"):
        tfs.cfft_fused2(plan, re.T, re.T, ordered=False)
    with pytest.raises(ValueError, match="stream conv kernel does not run"):
        tck.zconv_stream(pt.new_setup(8192, pt.COMPLEX, factors=(64, 128), strict=False),
                         torch.zeros((1, 9000)), re[:, 0], re[:, 0], 4097, 100)
    assert (tpk.cfft_chain_tmajor.launches, tfs.cfft_fused2.launches) == before


def _spy_stream_plans(monkeypatch):
    """The factors of every plan the stream map's plain version runs."""

    seen = []
    plain = tck.zconv_stream_plain

    def spy(plan, *a, **k):
        seen.append(plan.factors)
        return plain(plan, *a, **k)

    monkeypatch.setattr(tck, "zconv_stream_plain", spy)
    return seen


def _lowpass(taps):
    n = np.arange(taps) - (taps - 1) / 2.0
    h = 0.2 * np.sinc(0.2 * n) * np.hamming(taps)
    return h / h.sum()


@pytest.mark.parametrize("mode", ["real_strided", "complex"])
def test_stream_map_at_8192_on_radix32_matches_float64(mode, monkeypatch):
    """FastConv at 4096 taps (nfft 8192) runs the stream map on 32*16*16:
    a real stream read out of wider rows, and a complex stream, against the
    float64 valid convolution; within 2e-6 of the thin plan's plain map."""

    taps, rows, u = 4096, 3, 4097
    rng = np.random.default_rng(26 + len(mode))
    h = _lowpass(taps).astype(np.float32)
    length = taps - 1 + 3 * u + 123
    flags = F_.NONE if mode == "real_strided" else F_.CPLX_INP_OUT
    buf = rng.standard_normal((rows, length + 1001))
    if mode == "complex":
        buf = buf + 1j * rng.standard_normal(buf.shape)
    buf = torch.from_numpy(buf.astype(np.complex64 if mode == "complex" else np.float32))
    x = buf[:, 500:500 + length]  # rows length + 1001 apart
    fc = tconv.FastConv(h, flags=flags, device=CPU)
    assert fc.nfft == 8192 and fc.num_out_per_block == u
    seen = _spy_stream_plans(monkeypatch)
    got = fc.apply_batched(x, flush=True)
    assert seen == [(32, 16, 16)]
    x64 = x.numpy().astype(np.complex128 if mode == "complex" else np.float64)
    want = np.stack([np.convolve(r, h.astype(np.float64), "valid") for r in x64])
    assert got.shape == want.shape == (rows, length - taps + 1)
    assert _rel(got.numpy(), want) <= TOL
    hfr, hfi = fc._spectrum(torch.device(CPU))
    xs = x if mode == "complex" else x.contiguous()
    thin = tck.zconv_stream(tpk.thin_plan(8192), xs, hfr, hfi, u, got.shape[-1])
    assert _rel(got.numpy(), thin.numpy()) <= KERNEL_TOL


def test_stream_map_gradient_at_8192_on_radix32_matches_float64(monkeypatch):
    """The gradient of FastConv at 4096 taps through the stream map on
    32*16*16 (forward, and the backward's map over the reversed taps),
    against float64 autograd of the same valid convolution."""

    taps, rows = 4096, 2
    rng = np.random.default_rng(4096)
    h = _lowpass(taps).astype(np.float32)
    length = taps - 1 + 2 * 4097 + 77
    x = torch.from_numpy(rng.standard_normal((rows, length)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((rows, length - taps + 1)).astype(np.float32))
    fc = tconv.FastConv(h, device=CPU)
    seen = _spy_stream_plans(monkeypatch)
    xg = x.clone().requires_grad_(True)
    (fc.apply_batched(xg, flush=True) * g).sum().backward()
    assert seen == [(32, 16, 16), (32, 16, 16)]
    x64 = x.double().requires_grad_(True)
    w = torch.from_numpy(h.astype(np.float64)[::-1].copy())[None, None]
    (torch.nn.functional.conv1d(x64[:, None], w)[:, 0] * g.double()).sum().backward()
    assert _rel(xg.grad.numpy(), x64.grad.numpy()) <= TOL


def test_cpu_stream_map_counts_no_radix32_launch():
    """The radix-32 launch counter counts card launches only: the CPU's
    plain version at nfft 8192 leaves it and the launch counter alone."""

    plan = tck.stream_plan(8192)
    hf = torch.zeros(8192)
    before = tprof.counters.get(tck.R32_LAUNCHES, 0), tck.zconv_stream.launches
    tck.zconv_stream(plan, torch.zeros((2, 9000)), hf, hf, 4097, 800)
    assert (tprof.counters.get(tck.R32_LAUNCHES, 0), tck.zconv_stream.launches) == before
    assert tck.R32_LAUNCHES == "kernels.stream_map.r32_launches"


def test_conv_route_table_force_and_engine(clean_conv_state):
    # no table: the route is coverage's, under a forced route or engine
    assert not hasattr(D, "record_conv_route") and not hasattr(D, "_CONV_TABLE")
    assert D.conv_route_mode(128) == "fused"
    assert D.conv_route_mode(128, "tmajor") == "tmajor"
    assert D.conv_route_mode(128, "fused") == "fused"
    assert D.conv_route_mode(8192) == "tmajor"  # past the column map
    assert D.conv_route_mode(8192, stream=True) == "fused"  # the stream map covers it
    assert D.conv_route_mode(8192, "tmajor", stream=True) == "tmajor"
    assert D.conv_route_mode(8192, "fused", stream=True) == "fused"
    D.set_engine("stages")  # an engine other than the chain keeps the kernel out
    assert D.conv_route_mode(256) == "tmajor"
    assert D.conv_route_mode(4096, stream=True) == "tmajor"
    assert D.conv_route_mode(256, "fused") == "fused"  # a forced route wins
    D.set_engine("chain")  # the chain is the kernel's own engine
    assert D.conv_route_mode(256) == "fused"
    assert D.conv_route_mode(4096, stream=True) == "fused"
    D.set_engine(None)
    with pytest.raises(ValueError, match="unknown conv route"):
        D.conv_route_mode(128, "xla")
    with pytest.raises(ValueError, match="unknown conv route"):
        D.conv_route_mode(128, "pallas")
    with pytest.raises(ValueError, match="column map cannot hold nfft=4096"):
        D.conv_route_mode(4096, "fused")
    assert D.conv_route_mode(4096, "fused", stream=True) == "fused"
    with pytest.raises(ValueError, match="stream map cannot hold nfft=32768"):
        D.conv_route_mode(32768, "fused", stream=True)


def _raises(name):
    def call(*a, **k):
        raise AssertionError(f"{name} called on the composed route")
    return call


# (dtype, forced route, taps, flags): the composed route's cases: float64
# (nfft 2048), a forced "tmajor" where both maps hold nfft (2048; a complex
# stream at 128), and nfft 32768, past the stream map
COMPOSED_RUNS = [("float64", None, 1024, "real"), ("float32", "tmajor", 1024, "real"),
                 ("float32", "tmajor", 64, "cplx_inp_out"), ("float32", None, 9000, "real")]


@pytest.mark.parametrize("dtype,force,flen,name", COMPOSED_RUNS)
def test_composed_route_decides_once(dtype, force, flen, name, monkeypatch):
    """FastConv's streams on the "tmajor" route take the routed transforms
    directly: no column-map decision, no kernel map."""

    flags = FLAG_SETS[name]
    h, x = _inputs(flags, flen, flen + 3 * 2048 + 401, flen, lead=(2,))
    fc = tconv.FastConv(h, flags=flags, dtype=dtype, device=CPU)
    fc._force_conv_kernel = force
    assert fc._route(torch.device(CPU), stream=True) == "tmajor"
    monkeypatch.setattr(D, "conv_kernel_choice", _raises("conv_kernel_choice"))
    for kernel in ("zconv_tmajor", "zconv_stream"):
        monkeypatch.setattr(tck, kernel, _raises(kernel))
    got = fc.apply_batched(x)
    want = np.stack([np.convolve(r.astype(np.complex128 if np.iscomplexobj(r) else np.float64),
                                 h.astype(np.float64), "valid") for r in x])
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= TOL


def test_fastconv_errors():
    with pytest.raises(ValueError, match="use float32 or float64"):
        tconv.FastConv(np.ones(8), dtype="float16", device=CPU)
    with pytest.raises(ValueError, match="1-D"):
        tconv.FastConv(np.ones((2, 4)), device=CPU)
    fc = tconv.FastConv(np.ones(8), device=CPU)
    with pytest.raises(ValueError, match="set CPLX_INP_OUT"):
        fc.apply(np.zeros(64, np.complex64))
    with pytest.raises(ValueError, match="apply_batched"):
        fc.apply(np.zeros((2, 64), np.float32))
    with pytest.raises(ValueError, match="cannot hold nfft=32768"):
        big = tconv.FastConv(np.ones(16385), device=CPU)  # nfft 32768: past the stream map
        big._force_conv_kernel = "fused"
        big.apply(np.zeros(40000, np.float32), flush=True)
    with pytest.raises(ValueError, match="column map cannot hold nfft=8192"):
        frames = tconv.StreamingConv(np.ones(4096), device=CPU)
        frames.setup._force_conv_kernel = "fused"
        frames.push(np.zeros(9000, np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tconv.FastConv(np.ones(8)).apply(np.zeros(64, np.float32))
