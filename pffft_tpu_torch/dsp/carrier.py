"""Carrier generators (pf_carrier parity).

Counterpart of ``pffft_tpu/dsp/carrier.py``.  exp(i*pi*k/2) is one of
{1, i, -1, -i}, so the DC / +-fs/4 / +-fs/2 carriers are period-4
patterns, tiled in numpy and placed on ``device`` (default "cuda").  The
reference's exact values are kept, including its combined-carrier
amplitude m = SHRT_MAX/2 and the float amplitude 127/128.

Float variants return complex64 tensors of length ``size``; s16 variants
return int16 tensors of shape [size, 2] (re, im pairs), or the flat
interleaved [2*size] layout with ``interleaved=True`` (the C buffer).
"""

from __future__ import annotations

import numpy as np
import torch

_AF = np.float32(127.0 / 128.0)
_SM = np.int16(32767)  # SHRT_MAX
_M = np.int16(32767 // 2)  # SHRT_MAX / 2 = 16383

__all__ = [
    "generate_dc_f", "generate_dc_s16",
    "generate_pos_fs4_f", "generate_pos_fs4_s16",
    "generate_neg_fs4_f", "generate_neg_fs4_s16",
    "generate_dc_pos_fs4_s16", "generate_dc_neg_fs4_s16",
    "generate_pos_neg_fs4_s16", "generate_dc_pos_neg_fs4_s16",
    "generate_pos_neg_fs2_s16", "generate_dc_pos_neg_fs2_s16",
]


def _place(a: np.ndarray, device) -> torch.Tensor:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.from_numpy(a).to(dev)


def _tile_f(pattern, size: int, device) -> torch.Tensor:
    if size % 4:
        raise ValueError("size must be a multiple of 4 (pf_carrier contract)")
    pat = np.asarray(pattern, dtype=np.complex64)
    return _place(np.tile(pat, size // 4), device)


def _tile_s16(pairs, size: int, interleaved: bool, device) -> torch.Tensor:
    if size % 4:
        raise ValueError("size must be a multiple of 4 (pf_carrier contract)")
    out = np.tile(np.asarray(pairs, dtype=np.int16), (size // 4, 1))  # [size, 2]
    return _place(out.reshape(-1) if interleaved else out, device)


# --- single carriers --------------------------------------------------------

def generate_dc_f(size: int, device="cuda"):
    """pf_carrier.cpp:41-50."""

    return _tile_f([_AF, _AF, _AF, _AF], size, device)


def generate_dc_s16(size: int, interleaved: bool = False, device="cuda"):
    return _tile_s16([[_SM, 0]] * 4, size, interleaved, device)


def generate_pos_fs4_f(size: int, device="cuda"):
    """exp(+i*pi*k/2) * 127/128 (pf_carrier.cpp:62-81)."""

    return _tile_f([_AF, 1j * _AF, -_AF, -1j * _AF], size, device)


def generate_pos_fs4_s16(size: int, interleaved: bool = False, device="cuda"):
    return _tile_s16([[_SM, 0], [0, _SM], [-_SM, 0], [0, -_SM]], size, interleaved, device)


def generate_neg_fs4_f(size: int, device="cuda"):
    return _tile_f([_AF, -1j * _AF, -_AF, 1j * _AF], size, device)


def generate_neg_fs4_s16(size: int, interleaved: bool = False, device="cuda"):
    return _tile_s16([[_SM, 0], [0, -_SM], [-_SM, 0], [0, _SM]], size, interleaved, device)


# --- combined carriers (values as in pf_carrier.cpp:150-298) ---------------

def generate_dc_pos_fs4_s16(size: int, interleaved: bool = False, device="cuda"):
    m = int(_M)
    return _tile_s16([[2 * m, 0], [m, m], [0, 0], [m, -m]], size, interleaved, device)


def generate_dc_neg_fs4_s16(size: int, interleaved: bool = False, device="cuda"):
    m = int(_M)
    return _tile_s16([[2 * m, 0], [m, -m], [0, 0], [m, m]], size, interleaved, device)


def generate_pos_neg_fs4_s16(size: int, interleaved: bool = False, device="cuda"):
    m = int(_M)
    return _tile_s16([[m, -m], [-m, m], [-m, m], [m, -m]], size, interleaved, device)


def generate_dc_pos_neg_fs4_s16(size: int, interleaved: bool = False, device="cuda"):
    m = int(_M)
    return _tile_s16([[2 * m, -m], [0, m], [0, m], [2 * m, -m]], size, interleaved, device)


def generate_pos_neg_fs2_s16(size: int, interleaved: bool = False, device="cuda"):
    m = int(_M)
    return _tile_s16([[m, 0], [-m, 0], [m, 0], [-m, 0]], size, interleaved, device)


def generate_dc_pos_neg_fs2_s16(size: int, interleaved: bool = False, device="cuda"):
    m = int(_M)
    return _tile_s16([[m, m], [-m, m], [m, m], [-m, m]], size, interleaved, device)
