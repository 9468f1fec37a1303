"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), compiled on first use for
Hopper (``sm_90a``) into ``pffft_tpu_torch/_build/``, keyed by a hash of
the sources and flags.  ``ksplit2.cu`` becomes one library per combine
radix (``ksplit2_r<r>``, see :data:`VARIANTS`).  Several libraries build in
parallel, one nvcc each.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

from ..utils import profiling as _profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# The combine radices of ksplit2.cu (pallas_fft.COMBINE_RADICES).
KSPLIT2_RADICES = (2, 3, 4, 5, 8, 16, 32)
# library -> (source in csrc/, extra nvcc flags): a source built more than once
VARIANTS = {f"ksplit2_r{r}": ("ksplit2", (f"-DPF_KSPLIT2_RADIX={r}",))
            for r in KSPLIT2_RADICES}
# every library
SOURCES = ("stockham_chain", "combine", "stream_copy", "chain_packed", "real_fused",
           "real_split", "conv_fused", "pfb_fir", "fused2", "real_split_bmajor", *VARIANTS)
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""

    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source(name: str) -> str:
    """The csrc/ source (without .cu) that library ``name`` is built from."""

    return VARIANTS.get(name, (name, ()))[0]


def _flags(name: str) -> tuple:
    return (*FLAGS, *VARIANTS.get(name, (name, ()))[1])


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for p in [CSRC / f"{source(name)}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def log_path(name: str) -> Path:
    """nvcc's output (ptxas register and spill report) of the last build."""

    return BUILD_DIR / f"{name}-{_digest(name)}.log"


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel of library ``name``, from
    the ptxas report of its last build: {mangled entry name: {"registers",
    "spill_stores", "spill_loads"}}."""

    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log_path(name).read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile the named sources that are not built yet, all in parallel.

    Returns the wall seconds spent.  Raises RuntimeError with nvcc's
    output if any build fails."""

    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *_flags(name), "-o", tmp, str(CSRC / f"{source(name)}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        log_path(name).write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            os.unlink(tmp)
            variant = f" ({name})" if name in VARIANTS else ""
            failed.append(f"nvcc failed on {source(name)}.cu{variant}:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The shared library ``name`` (see :data:`SOURCES`), built first if
    needed; a first load's time goes to ``setup.seconds.load``."""

    lib = _LOADED.get(name)
    if lib is None:
        with _profiling.setup("load"):
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.pf_error_string.argtypes = [ctypes.c_int]
            lib.pf_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""

    if err:
        msg = lib.pf_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
