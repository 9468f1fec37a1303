"""Real <-> complex split steps of the real transform, complex dtype.

Counterpart of ``pffft_tpu/ops/real.py``: the half-length complex trick

    forward:  z[m] = x[2m] + i x[2m+1];  Z = CFFT_{N/2}(z);
              E[k] = (Z[k] + conj(Z[H-k]))/2,  O[k] = -i/2 (Z[k] - conj(Z[H-k]))
              X[k] = E[k] + W^k O[k],  W = e^{-2i pi/N}

with pffft's packing: N/2 complex bins, bin0 = F(0) + i*F(N/2).  The
backward step is the algebraic inverse scaled by 2, so that the unscaled
backward engine and the interleave give N * x.  The planar forms the
transforms run are in ``ops/split.py``.

``real_twiddle`` is the plan's numpy table exp(-2i pi k / N), k < N/2.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_real_input(x: torch.Tensor, cdtype=torch.complex64) -> torch.Tensor:
    """[..., N] real -> [..., N/2] complex z[m] = x[2m] + i x[2m+1]."""

    lead = x.shape[:-1]
    xz = x.reshape(*lead, x.shape[-1] // 2, 2)
    return torch.complex(xz[..., 0], xz[..., 1]).to(cdtype)


def _reverse_conj(z: torch.Tensor) -> torch.Tensor:
    """y[k] = conj(z[(H - k) mod H]) along the last axis."""

    h = z.shape[-1]
    idx = (h - torch.arange(h, device=z.device)) % h
    return torch.conj(z.index_select(-1, idx))


def _table(real_twiddle: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.asarray(real_twiddle)).to(like.device, like.dtype)


def real_forward_split(Z: torch.Tensor, real_twiddle: np.ndarray) -> torch.Tensor:
    """Half-length complex spectrum Z [..., H] -> packed real spectrum [..., H]."""

    Zc = _reverse_conj(Z)
    e = 0.5 * (Z + Zc)
    o = -0.5j * (Z - Zc)
    x = e + _table(real_twiddle, Z) * o
    z0 = Z[..., 0]
    x[..., 0] = torch.complex(z0.real + z0.imag, z0.real - z0.imag)
    return x


def real_backward_split(S: torch.Tensor, real_twiddle: np.ndarray) -> torch.Tensor:
    """Packed real spectrum S [..., H] -> 2*Z, the input of the unscaled
    backward half-length transform."""

    xa = S.clone()
    xa[..., 0] = S[..., 0].real.to(S.dtype)  # X[0] = DC, real
    # xb[k] = X[H - k]: xb[0] = X[H] (the real Nyquist), xb[k > 0] = S[H - k]
    xb = torch.conj(_reverse_conj(xa))
    xb[..., 0] = S[..., 0].imag.to(S.dtype)
    xbc = torch.conj(xb)
    e = xa + xbc
    o = torch.conj(_table(real_twiddle, S)) * (xa - xbc)
    return e + 1j * o


def interleave_to_real(w: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[..., H] complex -> [..., N] real via x[2m] = Re(w), x[2m+1] = Im(w)."""

    lead = w.shape[:-1]
    out = torch.stack([w.real, w.imag], dim=-1)
    return out.reshape(*lead, 2 * w.shape[-1]).to(dtype)
