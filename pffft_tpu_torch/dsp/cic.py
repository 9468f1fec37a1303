"""CIC digital downconverter (pf_cic parity).

Counterpart of ``pffft_tpu/dsp/cic.py``.  The reference's C loop fuses an
NCO with a 3-stage CIC decimator (three integrators at the input rate, two
combs at the output rate, gain 1/(32767*32767*R^3)).  Its composite LTI
system has a closed form,

    out_k = (x * b3)[k*R + R - 3],   b3 = boxcar_R ** (*3), len 3R-2,

a strided FIR with the triple-boxcar kernel.  As in the reference, S =
128 outputs share one row of the mixed stream, so the whole CIC is one
product ``rows @ block_w``: rows [K/S, (S+2)R] overlapping by 2R samples
(``Tensor.unfold``, no concatenation), and the banded weight block_w
[(S+2)R, S].  The product runs in full fp32 (no TF32; the port leaves
``torch.get_float32_matmul_precision()`` at "highest").  The NCO carrier
is the reference's table convention (-sin + i*cos) on the 32-bit
fixed-point phase of :mod:`mixer`.

Streaming state: the NCO phase and the last 2R mixed samples; a fresh
state reproduces the C's zeroed registers.  numpy input goes to the
setup's ``device`` (default "cuda"); tensors stay where they are.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

from ..ops import _grad
from . import mixer as _mixer

__all__ = ["CicState", "CicDDC", "cicddc_init", "cicddc_apply", "state_from_arrays"]

class CicState(NamedTuple):
    """Planar streaming state.  The phase is an int, or an int64 tensor (one
    per stream under ``torch.func.vmap``, and always out of a transformed
    call)."""

    phase_fp: Union[int, torch.Tensor]  # NCO phase, 32-bit fixed point
    hist_re: torch.Tensor    # [2R] float32 mixed-sample history
    hist_im: torch.Tensor


def state_from_arrays(phase_fp, hist_re, hist_im, device="cuda") -> CicState:
    """The port's state from a reference ``CicState`` as numpy arrays: the
    stream carries on from there.  A phase array (one state per stream, for
    ``torch.func.vmap``) becomes an int64 tensor on ``device``."""

    phase = _mixer.state_from_arrays(phase_fp, 0, device).phase_fp
    return CicState(phase, *(_mixer._to_device(h, device, torch.float32)
                             for h in (hist_re, hist_im)))


def _boxcar3(r: int) -> np.ndarray:
    b = np.ones(r, dtype=np.float64)
    return np.convolve(np.convolve(b, b), b)  # len 3R-2, integer-valued


class CicDDC:
    """cicddc_init analog: the static plan (factor, banded weight), with the
    weight cached per device."""

    #: outputs per row of the banded product
    BLOCK_S = 128

    def __init__(self, factor: int, device="cuda"):
        if factor < 1:
            raise ValueError("factor must be >= 1")
        self.factor = int(factor)
        self.device = device
        # reversed kernel: out_k = ext[k*R : k*R + 3R-2] @ b3_rev
        self.b3_rev = _boxcar3(self.factor)[::-1].astype(np.float32)
        # banded block weight: W[j*R + t, j] = b3_rev[t], so row i of the
        # stream times W gives outputs i*S .. i*S+S-1
        r, s = self.factor, self.BLOCK_S
        w = np.zeros((s * r + 2 * r, s), dtype=np.float32)
        for j in range(s):
            w[j * r : j * r + 3 * r - 2, j] = self.b3_rev
        self.block_w = w
        self._w: Dict[torch.device, torch.Tensor] = {}
        self._gains: Dict[Tuple[float, torch.device], torch.Tensor] = {}
        # integrator-gain compensation 1/R^3 (pf_cic.cpp:70); the extra
        # 1/SHRT_MAX of the C gain is the int16 normalization, per fmt
        self.gain = np.float32(1.0 / self.factor**3)

    def _weight(self, device: torch.device) -> torch.Tensor:
        w = self._w.get(device)
        if w is None:
            w = self._w[device] = torch.from_numpy(self.block_w).to(device)
        return w

    def _signs(self, g: float, device: torch.device) -> torch.Tensor:
        """[[-g], [g]]: the output gain of the two planes, the first one
        negated back (see :meth:`_apply_impl`)."""

        key = (g, device)
        t = self._gains.get(key)
        if t is None:
            t = self._gains[key] = torch.tensor([[-g], [g]], dtype=torch.float32,
                                                device=device)
        return t

    def init_state(self, device=None) -> CicState:
        z = torch.zeros(2 * self.factor, dtype=torch.float32,
                        device=self.device if device is None else device)
        return CicState(phase_fp=0, hist_re=z, hist_im=z)

    # ------------------------------------------------------------------
    def apply(self, state: CicState, x, rate: float, fmt: str = "f"
              ) -> Tuple[torch.Tensor, CicState]:
        """Process R*K input samples into K output samples.

        fmt: 'f'    float or complex input, used as is;
             's16'  int16 real input (cicddc_s16_c parity);
             'cs16' int16 [2L] interleaved or [L] complex (cicddc_cs16_c);
             'cu8'  uint8 [2L] interleaved IQ (cicddc_cu8_c, with the
                    rtl-sdr offset (v<<8) - 32614, pf_cic.cpp:219-220).
        Returns (out [K] complex64, next_state).
        """

        x = _mixer._to_device(x, self.device, None)
        scale = 1.0 / 32767.0  # int16-input normalization (part of the C gain)
        if fmt == "s16":
            x = x.to(torch.float32)
        elif fmt == "cs16":
            if not x.is_complex():
                x = x.reshape(-1, 2).to(torch.float32)
                x = torch.complex(x[:, 0], x[:, 1])
        elif fmt == "cu8":
            xs = (x.reshape(-1, 2).to(torch.int32) << 8) - 32614
            x = torch.complex(xs[:, 0].to(torch.float32), xs[:, 1].to(torch.float32))
        elif fmt == "f":
            scale = 1.0  # already-normalized float/complex input
        else:
            raise ValueError(f"unknown fmt {fmt!r}")
        if x.is_complex():
            xr, xi = x.real, x.imag
        else:
            xr, xi = x, torch.zeros_like(x)
        (yr, yi), new_state = self.apply_split(state, xr, xi, rate, scale=scale)
        return torch.complex(yr, yi), new_state

    def apply_split(self, state: CicState, xr, xi, rate: float, scale: float = 1.0):
        """Planar apply: float32 planes [R*K] in, ((yr, yi) [K], state') out."""

        xr = _mixer._to_device(xr, self.device, torch.float32)
        xi = _mixer._to_device(xi, self.device, torch.float32)
        n = int(xr.shape[0])
        if n % self.factor:
            raise ValueError(f"input length {n} must be a multiple of factor {self.factor}")
        return self._apply_impl(state, xr, xi, _mixer._to_fp(rate), scale)

    def _apply_impl(self, state: CicState, xr, xi, rate_fp: int, scale: float):
        r, s = self.factor, self.BLOCK_S
        n = xr.shape[0]
        k_out = n // r
        dev = xr.device
        kp = -(-k_out // s) * s
        (yr, yi), mst = _mixer.mixer_apply_split(_mixer.MixerState(state.phase_fp, rate_fp),
                                                 xr, xi)
        # the carrier (-sin + i*cos) is the mixer's times i: (yr, yi) -> (-yi, yr);
        # row 0 holds the negated real plane, yi, and the gain negates it back
        # (exact in floating point; no negation pass, and autograd-safe).
        # ext = [history, mixed chunk], zero-padded to whole rows (the zeros
        # feed only the trimmed tail outputs), is built in one pass
        zeros = xr.new_zeros(r * kp - n)
        ext = torch.cat([-state.hist_re, yi, zeros, state.hist_im, yr, zeros]
                        ).view(2, r * kp + 2 * r)
        phase = mst.phase_fp
        if _grad._transforms_active():
            phase = _mixer.as_tensors(mst, dev).phase_fp
        new_state = CicState(
            phase_fp=phase,
            hist_re=-ext[0, n : n + 2 * r],
            hist_im=ext[1, n : n + 2 * r].clone(),
        )
        if kp == 0:
            return (xr.new_zeros(0), xr.new_zeros(0)), new_state
        # row i = ext[i*S*R : i*S*R + (S+2)*R], both planes: [2*kp/S, (S+2)R]
        rows = ext.unfold(1, (s + 2) * r, s * r).reshape(-1, (s + 2) * r)
        y = torch.matmul(rows, self._weight(dev))  # [2*kp/S, S], full fp32
        g = float(self.gain * np.float32(scale))
        y = y.reshape(2, kp)[:, :k_out] * self._signs(g, dev)
        return (y[0], y[1]), new_state


def cicddc_init(factor: int, device="cuda") -> Tuple[CicDDC, CicState]:
    """cicddc_init parity (pf_cic.h:65): returns (plan, fresh state)."""

    ddc = CicDDC(factor, device)
    return ddc, ddc.init_state()


def cicddc_apply(ddc: CicDDC, state: CicState, x, rate: float, fmt: str = "s16"):
    """cicddc_{s16,cs16,cu8}_c parity: returns (output, next_state)."""

    return ddc.apply(state, x, rate, fmt)
