"""The port's host runtime, pffft_tpu_torch.runtime, against pffft_tpu's on
the same numpy inputs: the native planner (bit for bit against the port's
own Python tables and the reference's native planner), the stream framer
on both arms (the native ring buffer and the numpy arm), the four sample
converters bit for bit, StreamingConv on the native framer; and the build:
lazy, raising with the compiler's message, safe under parallel builds.

The numpy arms are forced by replacing ``runtime.load`` with a function
that finds no library, as a machine without a C++ compiler does."""

import ctypes
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import pffft_tpu as pf
from pffft_tpu import conv as rconv
from pffft_tpu import runtime as rruntime
import pffft_tpu_torch as pt
from pffft_tpu_torch import conv as tconv
from pffft_tpu_torch import plan as tplan
from pffft_tpu_torch import runtime as truntime

CPU = "cpu"
# the sizes of the reference's own planner test
VALID_SIZES = list(range(1, 200)) + [512, 1000, 1024, 2400, 9216, 1 << 26, (1 << 26) + 32]
NEAREST_SIZES = [5, 100, 1000, 40000]
# (l, r) stage twiddles: the reference test's, then stages of real plans
STAGES = [(1, 4), (16, 5), (64, 3), (4, 4), (80, 5), (1536, 2), (1000, 3), (4096, 5)]
SPLIT_SIZES = [32, 256, 960, 4096, 24000]
ARMS = ["native", "numpy"]


@pytest.fixture
def arm(request, monkeypatch):
    """The runtime arm under test: the native library, or the numpy arm
    (``load`` finds nothing, as without a compiler)."""

    if request.param == "numpy":
        monkeypatch.setattr(truntime, "load", lambda: None)
    else:
        assert truntime.load() is not None, "g++ is on PATH here: the native arm must load"
    return request.param


def test_import_starts_no_compiler():
    """Importing the package (every module) builds and loads nothing: the
    first load() does, and HAVE_NATIVE is resolved on first access."""

    code = textwrap.dedent("""
        import subprocess
        def refuse(*a, **k):
            raise AssertionError("a process was started at import")
        subprocess.run = subprocess.Popen = refuse
        import pffft_tpu_torch
        from pffft_tpu_torch import runtime
        assert runtime._lib is runtime._UNSET
        assert "HAVE_NATIVE" not in vars(runtime)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_native_planner_equals_python_tables_bit_for_bit():
    nat = truntime.native_planner()
    assert nat is not None and truntime.HAVE_NATIVE is True
    for n in VALID_SIZES:
        assert nat.is_valid_size(n, True) == tplan.is_valid_size(n, tplan.COMPLEX), n
        assert nat.is_valid_size(n, False) == tplan.is_valid_size(n, tplan.REAL), n
    for n in NEAREST_SIZES:
        for kind_c, kind in ((True, tplan.COMPLEX), (False, tplan.REAL)):
            for higher in (True, False):
                assert nat.nearest_transform_size(n, kind_c, higher) == \
                    tplan.nearest_transform_size(n, kind, higher), (n, kind, higher)
    for n in (1, 360, 4096, 2400, 7, 14, 0):
        try:
            want = tplan.decompose_smooth(n)
        except ValueError:
            want = None
        assert nat.decompose(n) == want, n
    c128 = np.complex128
    for l, r in STAGES:
        np.testing.assert_array_equal(nat.stage_twiddle(l, r, l * r),
                                      tplan._stage_twiddle(l, r, -1, c128))
    for r in (2, 3, 4, 5, 8, 16, 32):
        np.testing.assert_array_equal(nat.dft_matrix(r), tplan._dft_matrix(r, -1, c128))
    for n in SPLIT_SIZES:
        np.testing.assert_array_equal(nat.real_split_twiddle(n),
                                      tplan._real_split_twiddle(n, -1, c128))
    # and through plans: every stage of a complex and a real plan
    for plan in (pt.new_setup(2400), pt.new_setup(4096, pt.REAL, dtype="float64")):
        for st in plan.stages:
            want = nat.stage_twiddle(st.l, st.r, st.l * st.r).astype(plan.cdtype)
            np.testing.assert_array_equal(st.twiddle, want)


def test_native_planner_equals_the_reference_native_planner():
    ref = rruntime.native_planner()
    if ref is None:
        pytest.skip("the reference's native library is not loaded (PFFFT_TPU_NO_NATIVE)")
    nat = truntime.native_planner()
    for n in VALID_SIZES:
        for kind_c in (True, False):
            assert nat.is_valid_size(n, kind_c) == ref.is_valid_size(n, kind_c)
            assert nat.is_valid_size(n, kind_c) == pf.is_valid_size(
                n, pf.COMPLEX if kind_c else pf.REAL)
    for n in NEAREST_SIZES:
        for kind_c in (True, False):
            for higher in (True, False):
                assert nat.nearest_transform_size(n, kind_c, higher) == \
                    ref.nearest_transform_size(n, kind_c, higher)
    for n in (360, 7, 4096, 0):
        assert nat.decompose(n) == ref.decompose(n)
    for l, r in STAGES:
        np.testing.assert_array_equal(nat.stage_twiddle(l, r, l * r),
                                      ref.stage_twiddle(l, r, l * r))
    for r in (2, 3, 5, 16):
        np.testing.assert_array_equal(nat.dft_matrix(r), ref.dft_matrix(r))
    for n in SPLIT_SIZES:
        np.testing.assert_array_equal(nat.real_split_twiddle(n), ref.real_split_twiddle(n))


# ---------------------------------------------------------------------------
# The stream framer
# ---------------------------------------------------------------------------


def _drain_both(got, ref, max_frames=1 << 16):
    g, r = got.frames(max_frames), ref.frames(max_frames)
    assert g.dtype == np.float32 and g.shape == r.shape
    np.testing.assert_array_equal(g, r)
    assert got.pending() == ref.pending()
    return g.shape[0]


@pytest.mark.parametrize("arm", ARMS, indirect=True)
@pytest.mark.parametrize("frame,hop", [(64, 40), (128, 128), (2048, 1025)])
def test_stream_framer_matches_reference(arm, frame, hop):
    """Chunk sequences of every size (empty, shorter than a frame, several
    frames) through a small ring that wraps many times, a bounded
    frames() call, and flush."""

    rng = np.random.default_rng(frame + hop)
    ref = rruntime.StreamFramer(frame, hop, capacity=4 * frame)
    got = truntime.StreamFramer(frame, hop, capacity=4 * frame)
    assert got.native == (arm == "native")
    emitted = 0
    for i in range(60):
        n = int(rng.integers(0, 2 * frame)) if i % 7 else 0
        chunk = rng.standard_normal(n).astype(np.float32)
        assert got.push(chunk) == ref.push(chunk) == n
        assert got.pending() == ref.pending()
        emitted += _drain_both(got, ref, 1 if i % 5 == 0 else 1 << 16)
    assert emitted * hop > 8 * frame  # the ring wrapped
    _drain_both(got, ref)
    np.testing.assert_array_equal(got.flush(), ref.flush())
    assert got.pending() == ref.pending()
    while ref.pending():
        np.testing.assert_array_equal(got.flush(), ref.flush())
    assert got.flush().shape == ref.flush().shape == (0, frame)
    with pytest.raises(ValueError, match="hop"):
        truntime.StreamFramer(frame_len=8, hop=9)


def test_full_ring_raises_and_leaves_the_ring_untouched():
    """A chunk larger than the ring's free space raises BufferError and
    writes nothing, as the reference's ring does; after a drain the same
    chunk goes in."""

    rng = np.random.default_rng(5)
    got = truntime.StreamFramer(256, 200, capacity=1000)  # rounded up to 1024
    assert got.native
    ref = rruntime.StreamFramer(256, 200, capacity=1000)
    a, b = (rng.standard_normal(n).astype(np.float32) for n in (900, 200))
    assert got.push(a) == ref.push(a) == 900
    with pytest.raises(BufferError, match="nothing written"):
        got.push(b)
    if ref.native:  # the reference's numpy arm has no capacity
        with pytest.raises(BufferError):
            ref.push(b)
    assert got.pending() == 900
    _drain_both(got, ref)
    assert got.pending() == 900 - 4 * 200
    assert got.push(b) == ref.push(b) == 200
    _drain_both(got, ref)
    np.testing.assert_array_equal(got.flush(), ref.flush())


@pytest.mark.parametrize("arm", ARMS, indirect=True)
@pytest.mark.parametrize("capacity,fits", [(1000, False), (1025, True), (2048, True)])
def test_ring_must_hold_a_frame(arm, capacity, fits):
    """A capacity whose ring (rounded up to a power of two, at least 1024)
    holds no frame of 2048 samples is refused on either arm."""

    if not fits:
        with pytest.raises(ValueError, match="cannot hold a frame of 2048"):
            truntime.StreamFramer(2048, 1025, capacity=capacity)
        return
    got = truntime.StreamFramer(2048, 1025, capacity=capacity)
    x = np.arange(2048, dtype=np.float32)
    assert got.push(x) == 2048
    np.testing.assert_array_equal(got.frames(), x[None])


# ---------------------------------------------------------------------------
# The sample converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arm", ARMS, indirect=True)
def test_converters_match_reference_bit_for_bit(arm):
    rng = np.random.default_rng(0)
    s16 = np.concatenate([rng.integers(-32768, 32768, 4094, dtype=np.int16),
                          np.array([-32768, 32767], np.int16)])
    got = truntime.convert_s16_f32(s16.reshape(2, -1))
    want = rruntime.convert_s16_f32(s16.reshape(2, -1))
    assert got.dtype == np.float32 and got.shape == (2, 2048)
    np.testing.assert_array_equal(got, want)

    cs16 = np.concatenate([s16, rng.integers(-32768, 32768, 4096, dtype=np.int16)])
    for g, w in zip(truntime.convert_cs16_planar_f32(cs16),
                    rruntime.convert_cs16_planar_f32(cs16), strict=True):
        assert g.dtype == np.float32 and g.shape == (4096,)
        np.testing.assert_array_equal(g, w)

    # every byte value, on both planes (127 and 128 straddle the 127.4
    # midpoint)
    cu8 = np.concatenate([np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8)[::-1],
                          rng.integers(0, 256, 1024, dtype=np.uint8)])
    for g, w in zip(truntime.convert_cu8_planar_f32(cu8),
                    rruntime.convert_cu8_planar_f32(cu8), strict=True):
        assert g.dtype == np.float32 and g.shape == (768,)
        np.testing.assert_array_equal(g, w)
    re, im = truntime.convert_cu8_planar_f32(np.array([127, 128], np.uint8))
    assert re[0] == (np.float32(127) - np.float32(127.4)) / np.float32(128) < 0 < im[0]

    # saturation at +-1 and beyond, both signs, and values that truncate
    edge = np.array([0.0, 1.0, -1.0, 1.5, -1.5, 2.0, -2.0, 1e-6, -1e-6, 0.49999 / 32767,
                     -32768.0 / 32767, 1e30, -1e30, 0.75, -0.75], np.float32)
    fr = np.concatenate([edge, rng.standard_normal(1000).astype(np.float32) * 0.7])
    fi = np.concatenate([-edge[::-1], rng.standard_normal(1000).astype(np.float32) * 0.7])
    got = truntime.convert_planar_f32_cs16(fr, fi)
    assert got.dtype == np.int16 and got.shape == (2 * fr.size,)
    np.testing.assert_array_equal(got, rruntime.convert_planar_f32_cs16(fr, fi))
    assert got[2] == 32767 and got[4] == -32767 and got[10] == 32767 and got[12] == -32768


@pytest.mark.parametrize("arm", ARMS, indirect=True)
def test_converters_reject_malformed_input(arm):
    with pytest.raises(ValueError, match="even"):
        truntime.convert_cs16_planar_f32(np.zeros(5, np.int16))
    with pytest.raises(ValueError, match="even"):
        truntime.convert_cu8_planar_f32(np.zeros(3, np.uint8))
    with pytest.raises(ValueError, match="differ"):
        truntime.convert_planar_f32_cs16(np.zeros(4, np.float32), np.zeros(3, np.float32))
    assert truntime.convert_cs16_planar_f32(np.zeros(0, np.int16))[0].shape == (0,)


# ---------------------------------------------------------------------------
# StreamingConv on the framer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arm", ARMS, indirect=True)
@pytest.mark.parametrize("flen,block_len", [(17, 0), (129, 512)])
def test_streaming_conv_matches_reference(arm, flen, block_len):
    rng = np.random.default_rng(flen)
    h = rng.standard_normal(flen).astype(np.float32)
    x = rng.standard_normal(20000).astype(np.float32)
    ref = rconv.StreamingConv(h, block_len=block_len)
    got = tconv.StreamingConv(h, block_len=block_len, device=CPU)
    assert got.native == (arm == "native")
    outs, want, pos = [], [], 0
    while pos < x.size:
        step = int(rng.integers(1, 3000))
        a, b = ref.push(x[pos:pos + step]), got.push(x[pos:pos + step])
        assert b.shape == a.shape
        want.append(a)
        outs.append(b)
        pos += step
    want.append(ref.flush())
    outs.append(got.flush())
    got_all, want_all = np.concatenate(outs), np.concatenate(want)
    assert got_all.shape == want_all.shape == (x.size - flen + 1,)
    assert np.abs(got_all - want_all).max() <= 1e-5 * np.abs(want_all).max()
    np.testing.assert_allclose(got_all, np.convolve(x.astype(np.float64), h, "valid"),
                               atol=1e-4 * np.abs(want_all).max())


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


def _copy_sources(dst):
    dst.mkdir()
    for name in truntime.SOURCES:
        shutil.copy(truntime.NATIVE_DIR / name, dst / name)
    return dst


def test_broken_source_raises_with_the_compiler_message(tmp_path, monkeypatch):
    """A compile error in the runtime's sources raises, with g++'s message,
    from build(), load() and HAVE_NATIVE alike; nothing half-built is left."""

    src = _copy_sources(tmp_path / "src")
    with open(src / "convert.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    out = tmp_path / "build"
    with pytest.raises(RuntimeError, match=r"g\+\+ failed") as err:
        truntime.build(src, out)
    assert "convert.cc" in str(err.value) and "error" in str(err.value)
    assert sorted(p.name for p in out.iterdir()) == ["runtime.lock"]
    monkeypatch.setattr(truntime, "NATIVE_DIR", src)
    monkeypatch.setattr(truntime, "BUILD_DIR", out)
    monkeypatch.setattr(truntime, "_lib", truntime._UNSET)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="this is not C"):
            truntime.load()
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        truntime.HAVE_NATIVE


def test_no_compiler_takes_the_numpy_arms(tmp_path, monkeypatch):
    monkeypatch.setattr(truntime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(truntime, "_lib", truntime._UNSET)
    monkeypatch.setattr(truntime.shutil, "which", lambda name: None)
    assert truntime.load() is None and truntime.HAVE_NATIVE is False
    assert truntime.native_planner() is None
    assert not truntime.StreamFramer(64, 32).native
    assert not tconv.StreamingConv(np.ones(5), device=CPU).native
    re, _ = truntime.convert_cs16_planar_f32(np.array([16384, -16384], np.int16))
    assert re[0] == 0.5
    assert not (tmp_path / "build").exists()


def test_parallel_builds_load_one_library(tmp_path):
    """Several processes building the same sources at once into an empty
    directory: each loads a whole library and calls it, one library is
    left, and no temporary file."""

    src = _copy_sources(tmp_path / "src")
    out = tmp_path / "build"
    code = textwrap.dedent(f"""
        import ctypes, importlib.util, sys
        spec = importlib.util.spec_from_file_location("rt", {str(truntime.__file__)!r})
        rt = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(rt)
        lib = rt._bind(ctypes.CDLL(str(rt.build({str(src)!r}, {str(out)!r}))))
        print(lib.pftt_nearest_transform_size(1000, 1, 1))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr
        assert stdout.strip() == "1024"
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["runtime.lock", truntime.library_path(src, out).name])


def test_library_symbols_are_the_ports_own():
    """The port's library exports pftt_ symbols and none of the
    reference's pftpu_ ones, so that both load into one process."""

    lib = truntime.load()
    assert hasattr(lib, "pftt_ring_new")
    with pytest.raises(AttributeError):
        ctypes.CDLL(str(truntime.library_path())).pftpu_ring_new
    assert truntime.library_path().parent == truntime.BUILD_DIR
    assert pt.runtime is truntime
