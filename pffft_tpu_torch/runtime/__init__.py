"""The host runtime: the native planner, the stream ring buffer and the
sample-format converters, through ctypes.

Counterpart of ``pffft_tpu/runtime``, on C++ sources of the port's own
(``native/planner.cc``, ``stream_buffer.cc``, ``convert.cc``; symbols
prefixed ``pftt_``), which g++ builds on the first :func:`load`, never at
import, into ``pffft_tpu_torch/_build/`` under a name keyed by a hash of
the sources and flags:

  * :func:`native_planner`: factorization, size validity, the nearest
    valid size and the twiddle tables in long double (equal, bit for bit,
    to ``plan.py``'s);
  * :class:`StreamFramer`: the overlap-save framer on a native ring buffer;
  * the converters between SDR sample formats and planar float32.

Each entry point keeps the reference's numpy arm, and takes it only where
no C++ compiler is found: then ``HAVE_NATIVE`` (resolved on first access)
is False.  A failed compile or load of the port's sources raises, with
the compiler's message.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "HAVE_NATIVE", "load", "native_planner", "StreamFramer",
    "convert_s16_f32", "convert_cs16_planar_f32", "convert_cu8_planar_f32",
    "convert_planar_f32_cs16",
]

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("planner.cc", "stream_buffer.cc", "convert.cc")
# the reference Makefile's flags; no -ffast-math: the converters must round
# as the numpy arms do
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_UNSET = object()
_lib = _UNSET  # the loaded library, None where no compiler was found


def library_path(src_dir: Optional[Path] = None, build_dir: Optional[Path] = None) -> Path:
    """Where the library of the sources in ``src_dir`` is built."""

    src_dir, build_dir = Path(src_dir or NATIVE_DIR), Path(build_dir or BUILD_DIR)
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((src_dir / name).read_bytes())
    return build_dir / f"libpffft_tpu_torch_native-{h.hexdigest()[:16]}.so"


def build(src_dir: Optional[Path] = None, build_dir: Optional[Path] = None) -> Optional[Path]:
    """Compile the runtime's sources with g++ unless built already; returns
    the library's path, or None when no g++ is on PATH.

    Processes that build at once take turns on a lock file; each compiles
    to a temporary name and moves the result into place, so no process
    loads a half-written library.  Raises RuntimeError with the compiler's
    output if the compile fails."""

    src_dir, build_dir = Path(src_dir or NATIVE_DIR), Path(build_dir or BUILD_DIR)
    out = library_path(src_dir, build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "runtime.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by another process while this one waited
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [cxx, *CXXFLAGS, "-o", tmp, *(str(src_dir / s) for s in SOURCES), "-lm"],
                capture_output=True, text=True, timeout=300)
            if proc.returncode:
                raise RuntimeError(
                    f"g++ failed on the native runtime in {src_dir}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64, i32, vp = ctypes.c_uint64, ctypes.c_int32, ctypes.c_void_p
    f64p, f32p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float)
    i16p, u8p = ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "decompose": (ctypes.c_int, [u64, ctypes.POINTER(i32)]),
        "is_valid_size": (ctypes.c_int, [u64, ctypes.c_int]),
        "nearest_transform_size": (u64, [u64, ctypes.c_int, ctypes.c_int]),
        "fill_stage_twiddle": (None, [f64p, f64p, u64, u64, u64]),
        "fill_dft_matrix": (None, [f64p, f64p, u64]),
        "fill_real_split_twiddle": (None, [f64p, f64p, u64]),
        "ring_new": (vp, [u64]),
        "ring_free": (None, [vp]),
        "ring_size": (u64, [vp]),
        "ring_capacity": (u64, [vp]),
        "ring_write": (u64, [vp, f32p, u64]),
        "ring_read_frames": (u64, [vp, f32p, u64, u64, u64]),
        "ring_flush_frame": (u64, [vp, f32p, u64]),
        "convert_s16_f32": (None, [i16p, f32p, u64]),
        "convert_cs16_planar_f32": (None, [i16p, f32p, f32p, u64]),
        "convert_cu8_planar_f32": (None, [u8p, f32p, f32p, u64]),
        "convert_planar_f32_cs16": (None, [f32p, f32p, i16p, u64]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, "pftt_" + name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library, built first if needed; None where no C++
    compiler is found.  A failed compile or load raises."""

    global _lib
    with _lock:
        if _lib is _UNSET:
            path = build()
            _lib = None if path is None else _bind(ctypes.CDLL(str(path)))
        return _lib


def __getattr__(name: str):
    # HAVE_NATIVE is resolved on first access, so that importing the
    # package starts no compiler
    if name == "HAVE_NATIVE":
        return load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# Planner facade
# ---------------------------------------------------------------------------


class _NativePlanner:
    """Typed facade over the C planner."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def decompose(self, n: int) -> Optional[Tuple[int, ...]]:
        out = (ctypes.c_int32 * 64)()
        cnt = self.lib.pftt_decompose(n, out)
        if cnt < 0:
            return None
        return tuple(out[i] for i in range(cnt))

    def is_valid_size(self, n: int, kind_is_complex: bool) -> bool:
        return bool(self.lib.pftt_is_valid_size(n, 1 if kind_is_complex else 0))

    def nearest_transform_size(self, n: int, kind_is_complex: bool, higher: bool) -> int:
        return int(self.lib.pftt_nearest_transform_size(
            n, 1 if kind_is_complex else 0, 1 if higher else 0))

    def stage_twiddle(self, l: int, r: int, period: int) -> np.ndarray:
        re = np.empty((l, r), dtype=np.float64)
        im = np.empty((l, r), dtype=np.float64)
        self.lib.pftt_fill_stage_twiddle(_ptr(re, ctypes.c_double), _ptr(im, ctypes.c_double),
                                         l, r, period)
        return re + 1j * im

    def dft_matrix(self, r: int) -> np.ndarray:
        return self.stage_twiddle(r, r, r)

    def real_split_twiddle(self, n: int) -> np.ndarray:
        re = np.empty(n // 2, dtype=np.float64)
        im = np.empty(n // 2, dtype=np.float64)
        self.lib.pftt_fill_real_split_twiddle(_ptr(re, ctypes.c_double),
                                              _ptr(im, ctypes.c_double), n)
        return re + 1j * im


def native_planner() -> Optional[_NativePlanner]:
    """The native planner, or None where no C++ compiler is found."""

    lib = load()
    return _NativePlanner(lib) if lib is not None else None


# ---------------------------------------------------------------------------
# Streaming framer
# ---------------------------------------------------------------------------


class StreamFramer:
    """Overlap-save stream framer (native ring buffer; numpy arm).

    push() arbitrary float chunks; frames() returns [k, frame_len] batches
    advancing by ``hop`` with ``frame_len - hop`` samples of carried
    overlap (the block-cutting loop of pffastconv_apply), so the device
    sees fixed shapes.  The native ring holds ``capacity`` samples (rounded
    up to a power of two, at least 1024), which must hold a frame; a chunk
    that does not fit raises BufferError and leaves the ring untouched.
    """

    def __init__(self, frame_len: int, hop: int, capacity: int = 1 << 22):
        if hop < 1 or hop > frame_len:
            raise ValueError("need 1 <= hop <= frame_len")
        ring = max(1024, 1 << (int(capacity) - 1).bit_length())
        if ring < frame_len:
            raise ValueError(f"a ring of {ring} samples (capacity {capacity}) cannot hold "
                             f"a frame of {frame_len}")
        self.frame_len = int(frame_len)
        self.hop = int(hop)
        self._lib = load()
        self._ring = None
        if self._lib is None:
            self._buf = np.zeros(0, dtype=np.float32)
            return
        self._ring = self._lib.pftt_ring_new(capacity)
        if not self._ring:
            raise MemoryError(f"cannot allocate a stream ring of {capacity} samples")

    @property
    def native(self) -> bool:
        return self._ring is not None

    def push(self, x) -> int:
        x = np.ascontiguousarray(np.asarray(x, dtype=np.float32).ravel())
        if self._ring is None:
            self._buf = np.concatenate([self._buf, x])
            return x.size
        # all or nothing: a raised BufferError leaves the ring untouched, so
        # the caller may drain frames() and push the same chunk again
        free = int(self._lib.pftt_ring_capacity(self._ring)) - self.pending()
        if x.size > free:
            raise BufferError(
                f"stream ring full: {x.size} samples do not fit in {free} free slots "
                f"(nothing written); drain frames() before pushing, or push smaller chunks")
        return int(self._lib.pftt_ring_write(self._ring, _ptr(x, ctypes.c_float), x.size))

    def pending(self) -> int:
        if self._ring is None:
            return int(self._buf.size)
        return int(self._lib.pftt_ring_size(self._ring))

    def frames(self, max_frames: int = 1 << 16) -> np.ndarray:
        """Pop all complete frames: [k, frame_len] float32 (k may be 0)."""

        if self._ring is not None:
            pending = self.pending()
            ready = 0 if pending < self.frame_len else (pending - self.frame_len) // self.hop + 1
            out = np.empty((min(ready, max_frames), self.frame_len), dtype=np.float32)
            self._lib.pftt_ring_read_frames(self._ring, _ptr(out, ctypes.c_float),
                                            self.frame_len, self.hop, out.shape[0])
            return out
        k = 0
        frames = []
        while self._buf.size >= self.frame_len and k < max_frames:
            frames.append(self._buf[: self.frame_len].copy())
            self._buf = self._buf[self.hop :]
            k += 1
        return np.stack(frames) if frames else np.empty((0, self.frame_len), np.float32)

    def flush(self) -> np.ndarray:
        """Drain remaining samples as one zero-padded frame ([1, frame_len]
        with the pending samples) or an empty array."""

        if self._ring is not None:
            out = np.zeros((1, self.frame_len), dtype=np.float32)
            k = int(self._lib.pftt_ring_flush_frame(self._ring, _ptr(out, ctypes.c_float),
                                                    self.frame_len))
            return out if k else np.empty((0, self.frame_len), np.float32)
        if self._buf.size == 0:
            return np.empty((0, self.frame_len), np.float32)
        out = np.zeros((1, self.frame_len), dtype=np.float32)
        n = min(self._buf.size, self.frame_len)
        out[0, :n] = self._buf[:n]
        self._buf = self._buf[n:]
        return out

    def __del__(self):
        ring = getattr(self, "_ring", None)
        if ring:
            self._lib.pftt_ring_free(ring)
            self._ring = None


# ---------------------------------------------------------------------------
# Sample-format converters: SDR byte formats <-> the planar float32 the
# device consumes (the original library's cicddc_s16 / cs16 / cu8 inputs)
# ---------------------------------------------------------------------------


def _interleaved(x, dtype) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=dtype).ravel()
    if x.size % 2:
        raise ValueError(f"interleaved IQ needs an even number of values; got {x.size}")
    return x


def convert_s16_f32(x) -> np.ndarray:
    """int16 samples -> float32 scaled by 1/32768 (same shape)."""

    x = np.ascontiguousarray(x, dtype=np.int16)
    lib = load()
    if lib is None:
        return x.astype(np.float32) / np.float32(32768.0)
    out = np.empty(x.shape, dtype=np.float32)
    lib.pftt_convert_s16_f32(_ptr(x, ctypes.c_int16), _ptr(out, ctypes.c_float), x.size)
    return out


def convert_cs16_planar_f32(x) -> Tuple[np.ndarray, np.ndarray]:
    """Interleaved int16 IQ [2n] -> planar (re, im) float32 [n], 1/32768."""

    x = _interleaved(x, np.int16)
    lib = load()
    if lib is None:
        f = x.astype(np.float32) / np.float32(32768.0)
        return np.ascontiguousarray(f[0::2]), np.ascontiguousarray(f[1::2])
    re = np.empty(x.size // 2, dtype=np.float32)
    im = np.empty(x.size // 2, dtype=np.float32)
    lib.pftt_convert_cs16_planar_f32(_ptr(x, ctypes.c_int16), _ptr(re, ctypes.c_float),
                                     _ptr(im, ctypes.c_float), re.size)
    return re, im


def convert_cu8_planar_f32(x) -> Tuple[np.ndarray, np.ndarray]:
    """Interleaved offset-binary uint8 IQ [2n] -> planar float32 [n],
    (x - 127.4) / 128 (the original library's cu8 midpoint)."""

    x = _interleaved(x, np.uint8)
    lib = load()
    if lib is None:
        f = (x.astype(np.float32) - np.float32(127.4)) / np.float32(128.0)
        return np.ascontiguousarray(f[0::2]), np.ascontiguousarray(f[1::2])
    re = np.empty(x.size // 2, dtype=np.float32)
    im = np.empty(x.size // 2, dtype=np.float32)
    lib.pftt_convert_cu8_planar_f32(_ptr(x, ctypes.c_uint8), _ptr(re, ctypes.c_float),
                                    _ptr(im, ctypes.c_float), re.size)
    return re, im


def convert_planar_f32_cs16(re, im) -> np.ndarray:
    """Planar float32 [n] -> interleaved int16 IQ [2n], scaled by 32767,
    saturating."""

    re = np.ascontiguousarray(re, dtype=np.float32).ravel()
    im = np.ascontiguousarray(im, dtype=np.float32).ravel()
    if im.size != re.size:
        raise ValueError(f"planes differ in length: {re.size}, {im.size}")
    lib = load()
    if lib is None:
        z = np.empty(2 * re.size, dtype=np.float32)
        z[0::2] = re * 32767.0
        z[1::2] = im * 32767.0
        return np.clip(z, -32768.0, 32767.0).astype(np.int16)
    out = np.empty(2 * re.size, dtype=np.int16)
    lib.pftt_convert_planar_f32_cs16(_ptr(re, ctypes.c_float), _ptr(im, ctypes.c_float),
                                     _ptr(out, ctypes.c_int16), re.size)
    return out
