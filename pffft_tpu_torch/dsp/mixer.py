"""NCO frequency-shift mixers (pf_mixer parity).

Counterpart of ``pffft_tpu/dsp/mixer.py``.  Every entry point computes

    out[n] = in[n] * exp(i * (2*pi*rate*n + phase0))

The production mixer is a 32-bit fixed-point integer NCO: sample k has the
phase ``phase_fp + k * rate_fp (mod 2^32)``, exact for any stream length,
then float32 cos/sin.  The phase arithmetic runs in int64 masked to 32
bits (PyTorch's uint32 is incomplete on CUDA); a chunk holds fewer than
2^31 samples, so ``k * rate_fp + phase_fp`` stays below 2^63.  The
streaming state (``MixerState``) is two Python ints, advanced mod 2^32 on
the host, or two int64 tensors on the device: a per-stream state for
``torch.func.vmap`` (a function transform carries tensors only, so a
state of ints comes out of a transformed call as tensors, :func:`as_tensors`).  The phase in [0, 2^32) converts to float32 with round to
nearest even, as the reference's uint32 conversion does, so the angles
agree bit for bit before cos/sin.

The ALGO A-J entry points are the reference's parity surface, each with
its own numerics (see the notes above them).  numpy input goes to
``device`` (default "cuda"); tensors stay where they are.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "MixerState", "mixer_init", "mixer_apply", "mixer_apply_split", "mixer_carrier", "Mixer",
    "state_from_arrays",
    "shift_math_cc", "shift_table_init", "shift_table_cc",
    "shift_addfast_init", "shift_addfast_cc",
    "shift_unroll_init", "shift_unroll_cc",
    "shift_limited_unroll_init", "shift_limited_unroll_cc",
    "shift_recursive_osc_init", "shift_recursive_osc_cc", "gen_recursive_osc_c",
    "have_sse_shift_mixer_impl",
]

_TWO32 = float(1 << 32)
_MASK = 0xFFFFFFFF
_PHASE_SCALE = np.float32(2.0 * np.pi / _TWO32)
# k * rate_fp + phase_fp < 2^63 for every k of a chunk shorter than this
_MAX_CHUNK = 1 << 31


def have_sse_shift_mixer_impl() -> bool:
    """Parity with pf_mixer.h:61; always true (the mixer is vectorized)."""

    return True


class MixerState(NamedTuple):
    """Streaming NCO state.

    phase_fp: fixed-point phase in [0, 2^32) (2^32 == one turn).
    rate_fp:  fixed-point frequency (cycles/sample * 2^32, wrapped).
    """

    phase_fp: Union[int, torch.Tensor]
    rate_fp: Union[int, torch.Tensor]


def _to_fp(cycles: float) -> int:
    """Wrap a real number of turns to 32-bit fixed point."""

    frac = float(cycles) % 1.0
    return int(round(frac * _TWO32)) & _MASK


def mixer_init(rate: float, starting_phase: float = 0.0) -> MixerState:
    """rate: frequency shift relative to the sample rate (can be negative);
    starting_phase: radians (pf_mixer convention)."""

    return MixerState(phase_fp=_to_fp(starting_phase / (2.0 * np.pi)), rate_fp=_to_fp(rate))


def state_from_arrays(phase_fp, rate_fp, device=None) -> MixerState:
    """The port's state from a reference ``MixerState`` as numpy: the stream
    carries on from there.  Scalars become ints; arrays (one state per
    stream, for ``torch.func.vmap``) int64 tensors on ``device`` (default
    "cuda")."""

    if np.ndim(phase_fp) == 0 and np.ndim(rate_fp) == 0:
        return MixerState(int(phase_fp) & _MASK, int(rate_fp) & _MASK)
    return MixerState(*(_to_device(np.asarray(v, np.int64) & _MASK, device, None)
                        for v in (phase_fp, rate_fp)))


def as_tensors(state: MixerState, device) -> MixerState:
    """``state`` with its int fields as int64 tensors on ``device``."""

    return MixerState(*(v if isinstance(v, torch.Tensor)
                        else torch.tensor(v, dtype=torch.int64, device=device) for v in state))


def _fp(v):
    return v if isinstance(v, torch.Tensor) else int(v)


def _advance(state: MixerState, n: int) -> MixerState:
    return MixerState((state.phase_fp + n * state.rate_fp) & _MASK, state.rate_fp)


def _to_device(x, device: Optional[str], dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` (None: its own): tensors stay on their
    device, numpy arrays go to ``device`` (default "cuda")."""

    if not isinstance(x, torch.Tensor):
        dev = torch.device(device or "cuda")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
        x = torch.from_numpy(np.require(x, requirements=("C", "W"))).to(dev)
    return x if dtype is None else x.to(dtype)


def nco_angles(phase_fp, rate_fp, n: int, device) -> torch.Tensor:
    """Angles [n] float32 of samples k = 0..n-1: the fixed-point phase
    (phase_fp + k*rate_fp) mod 2^32 in int64, rounded to float32, times
    2*pi/2^32 in float32.  phase_fp and rate_fp are ints or int64 tensors."""

    if n >= _MAX_CHUNK:
        raise ValueError(f"a chunk holds fewer than 2^31 samples; got {n}")
    k = torch.arange(n, dtype=torch.int64, device=device)
    ph = (k * _fp(rate_fp) + _fp(phase_fp)) & _MASK
    return ph.to(torch.float32) * float(_PHASE_SCALE)


def _nco_carrier(state: MixerState, n: int, device) -> torch.Tensor:
    """Carrier exp(i*(phase0 + 2*pi*rate*k)), k = 0..n-1, complex64."""

    ang = nco_angles(state.phase_fp, state.rate_fp, n, device)
    return torch.complex(torch.cos(ang), torch.sin(ang))


def mixer_apply(state: MixerState, x, *, device: Optional[str] = None
                ) -> Tuple[torch.Tensor, MixerState]:
    """Shift a complex stream: returns (x * carrier, next_state).

    x: [..., n] complex; every leading row gets the same carrier (the
    channels of a multichannel stream share the NCO)."""

    x = _to_device(x, device, torch.complex64)
    n = x.shape[-1]
    return x * _nco_carrier(state, n, x.device), _advance(state, n)


def mixer_apply_split(state: MixerState, x_re, x_im, *, device: Optional[str] = None):
    """Split-format (planar re/im) :func:`mixer_apply`: returns
    ((out_re, out_im), next_state)."""

    x_re = _to_device(x_re, device, torch.float32)
    x_im = _to_device(x_im, device, torch.float32)
    n = x_re.shape[-1]
    ang = nco_angles(state.phase_fp, state.rate_fp, n, x_re.device)
    cr, ci = torch.cos(ang), torch.sin(ang)
    out = (x_re * cr - x_im * ci, x_re * ci + x_im * cr)
    return out, _advance(state, n)


def mixer_carrier(state: MixerState, n: int, *, device: Optional[str] = None
                  ) -> Tuple[torch.Tensor, MixerState]:
    """Generate n carrier samples (pure NCO output) on ``device`` and
    advance."""

    return _nco_carrier(state, n, torch.device(device or "cuda")), _advance(state, n)


class Mixer:
    """Stateful convenience wrapper (carries MixerState across calls)."""

    def __init__(self, rate: float, starting_phase: float = 0.0, device="cuda"):
        self.state = mixer_init(rate, starting_phase)
        self.device = device

    def shift(self, x) -> torch.Tensor:
        out, self.state = mixer_apply(self.state, x, device=self.device)
        return out

    def carrier(self, n: int) -> torch.Tensor:
        out, self.state = mixer_carrier(self.state, n, device=self.device)
        return out

    @property
    def phase(self) -> float:
        """Current phase in radians [0, 2*pi) (the C return-value convention)."""

        return float(self.state.phase_fp) * 2.0 * np.pi / _TWO32


# ---------------------------------------------------------------------------
# ALGO A-J parity surface (pf_mixer.h:70-280), as the reference has it:
#
#   * ALGO A multiplies sample k by phase phi0 + k*D (D = 2*pi*rate);
#     ALGO C/D/E multiply sample k by phi0 + (k+1)*D (the reference
#     family's one-sample carrier offset).
#   * ALGO B is the intended table-quantized semantics (the upstream index
#     expression binds its cast before the multiply; not replicated).
#   * ALGO E renormalizes its phasor every 128 samples; C and D never do.
#   * ALGO I/J run the magic-circle recursion on 8 staggered lanes.
#
# The sequential carries (the per-block phasor of C/E, the recursion of
# I/J) are loops over blocks on the host in float32 numpy, the same f32
# operations as the reference's scans; the block-wide products run on the
# input's device.  They are the parity surface; the production mixer is
# mixer_apply's integer NCO.
# ---------------------------------------------------------------------------


def _wrap_pi(phase: float) -> float:
    while phase > np.pi:
        phase -= 2 * np.pi
    while phase < -np.pi:
        phase += 2 * np.pi
    return phase


def shift_math_cc(x, rate: float, starting_phase: float = 0.0, *,
                  device: Optional[str] = None):
    """ALGO A parity (pf_mixer.cpp:141-163): exact trig NCO, sample k at
    phase phi0 + 2*pi*rate*k.  Returns (output, next_phase_radians)."""

    out, st = mixer_apply(mixer_init(rate, starting_phase), x, device=device)
    return out, float(st.phase_fp) * 2.0 * np.pi / _TWO32


@dataclasses.dataclass
class ShiftTableData:
    """ALGO B state: quarter-wave sine table (pf_mixer.cpp:171-187)."""

    table_size: int


def shift_table_init(table_size: int = 65536) -> ShiftTableData:
    return ShiftTableData(table_size=table_size)


def shift_table_cc(x, rate: float, table_data: ShiftTableData, starting_phase: float = 0.0,
                   *, device: Optional[str] = None):
    """ALGO B (intended semantics): carrier trig quantized to a quarter-wave
    table of ``table_size`` entries per quadrant, with the table's cos-index
    mirror (T-1-i).  The carrier is built on the host in numpy."""

    x = _to_device(x, device, torch.complex64)
    t = int(table_data.table_size)
    n = x.shape[-1]
    delta = 2.0 * np.pi * float(rate)
    phase = (starting_phase + delta * np.arange(n, dtype=np.float64)) % (2.0 * np.pi)
    quadrant = np.floor(phase / (np.pi / 2.0)).astype(np.int64) % 4
    vphase = phase - quadrant * (np.pi / 2.0)
    idx = np.clip((vphase / (np.pi / 2.0) * t).astype(np.int64), 0, t - 1)
    s_tab = np.sin(idx / t * (np.pi / 2.0)).astype(np.float32)
    c_tab = np.sin((t - 1 - idx) / t * (np.pi / 2.0)).astype(np.float32)
    odd = (quadrant & 1).astype(bool)
    sinv = np.where(odd, c_tab, s_tab)
    cosv = np.where(odd, s_tab, c_tab)
    sinv = np.where(quadrant > 1, -sinv, sinv)
    cosv = np.where((quadrant > 0) & (quadrant < 3), -cosv, cosv)
    carrier = torch.from_numpy(np.asarray(cosv + 1j * sinv, dtype=np.complex64)).to(x.device)
    nxt = float((starting_phase + delta * n) % (2.0 * np.pi))
    return x * carrier, nxt


@dataclasses.dataclass
class ShiftAddfastData:
    """ALGO C state (pf_mixer.h:95-104): f32 rotators for 1..4 steps."""

    rate: float
    dcos: np.ndarray  # [4] cos((j+1)*D), f32
    dsin: np.ndarray


def shift_addfast_init(rate: float) -> ShiftAddfastData:
    d = 2.0 * np.pi * float(rate)
    j = np.arange(1, 5, dtype=np.float64)
    return ShiftAddfastData(rate=float(rate), dcos=np.cos(j * d).astype(np.float32),
                            dsin=np.sin(j * d).astype(np.float32))


def _blocked_phasor_carrier(n: int, start_c, start_s, dcos, dsin, block: int, renorm: bool,
                            device):
    """Carrier of the C/E family: within a block of ``block`` samples the
    phasor start is fixed and sample j uses start*rot[j]; the start
    advances by rot[block-1] each block (f32 products, the reference's
    drift), renormalized per block for ALGO E.  The starts are a float32
    loop over the blocks on the host; the block products run on
    ``device``.  Returns (vc, vs) [n] and the final start."""

    nb = n // block
    rot_c = np.asarray(dcos, np.float32)
    rot_s = np.asarray(dsin, np.float32)
    last_c, last_s = rot_c[-1], rot_s[-1]
    starts = np.empty((2, nb, 1), np.float32)
    c, s = np.float32(start_c), np.float32(start_s)
    for b in range(nb):
        starts[0, b, 0], starts[1, b, 0] = c, s
        c, s = c * last_c - s * last_s, s * last_c + c * last_s  # = this block's last sample
        if renorm:
            mag = np.sqrt(c * c + s * s)
            c, s = c / mag, s / mag
    sc, ss = torch.from_numpy(starts).to(device).unbind(0)
    rc, rs = (torch.from_numpy(r).to(device) for r in (rot_c, rot_s))
    vc = sc * rc - ss * rs
    vs = ss * rc + sc * rs
    return vc.reshape(-1), vs.reshape(-1), c, s


def shift_addfast_cc(x, d: ShiftAddfastData, starting_phase: float = 0.0, *,
                     device: Optional[str] = None):
    """ALGO C parity (pf_mixer.cpp:252-281): 4-step unrolled incremental
    phasor, no renormalization; sample k carries phase phi0 + (k+1)*D."""

    x = _to_device(x, device, torch.complex64)
    n = x.shape[-1]
    if n % 4:
        raise ValueError("ALGO C requires input_size % 4 == 0 (pf_mixer.cpp:254)")
    vc, vs, _, _ = _blocked_phasor_carrier(
        n, np.cos(starting_phase), np.sin(starting_phase), d.dcos, d.dsin, 4, False, x.device)
    out = x * torch.complex(vc, vs)
    return out, _wrap_pi(float(starting_phase + n * 2.0 * np.pi * d.rate))


@dataclasses.dataclass
class ShiftUnrollData:
    """ALGO D state (pf_mixer.h:113-124): full-length rotator table."""

    rate: float
    size: int
    dcos: np.ndarray  # [size] cos of wrapped (k+1)*D, f32
    dsin: np.ndarray


def shift_unroll_init(rate: float, size: int) -> ShiftUnrollData:
    d = 2.0 * np.pi * float(rate)
    ph = (np.arange(1, size + 1, dtype=np.float64) * d + np.pi) % (2 * np.pi) - np.pi
    return ShiftUnrollData(rate=float(rate), size=int(size),
                           dcos=np.cos(ph).astype(np.float32), dsin=np.sin(ph).astype(np.float32))


def shift_unroll_cc(x, d: ShiftUnrollData, starting_phase: float = 0.0, *,
                    device: Optional[str] = None):
    """ALGO D parity (pf_mixer.cpp:333-380): carrier = start phasor times
    the precomputed f32 rotator table (phase (k+1)*D, wrapped at init)."""

    x = _to_device(x, device, torch.complex64)
    n = x.shape[-1]
    if n > d.size:
        raise ValueError(f"ALGO D table holds {d.size} samples, got {n}")
    c0, s0 = float(np.float32(np.cos(starting_phase))), float(np.float32(np.sin(starting_phase)))
    rc = torch.from_numpy(d.dcos[:n]).to(x.device)
    rs = torch.from_numpy(d.dsin[:n]).to(x.device)
    out = x * torch.complex(c0 * rc - s0 * rs, s0 * rc + c0 * rs)
    return out, _wrap_pi(float(starting_phase + n * 2.0 * np.pi * d.rate))


_LIMITED_UNROLL_SIZE = 128  # PF_SHIFT_LIMITED_UNROLL_SIZE (pf_mixer.h:137)


class ShiftLimitedUnrollState:
    """ALGO E/F/G/H state (pf_mixer.h:140-152): 128-entry rotator table and
    an internal complex phasor renormalized once per 128-sample block."""

    def __init__(self, rate: float, starting_phase: float = 0.0):
        d = 2.0 * np.pi * float(rate)
        k = np.arange(1, _LIMITED_UNROLL_SIZE + 1, dtype=np.float64)
        ph = (k * d + np.pi) % (2 * np.pi) - np.pi
        self.dcos = np.cos(ph).astype(np.float32)
        self.dsin = np.sin(ph).astype(np.float32)
        self.phasor = (np.float32(np.cos(starting_phase)), np.float32(np.sin(starting_phase)))


def shift_limited_unroll_init(rate: float, starting_phase: float = 0.0
                              ) -> ShiftLimitedUnrollState:
    return ShiftLimitedUnrollState(rate, starting_phase)


def shift_limited_unroll_cc(x, d: ShiftLimitedUnrollState, *, device: Optional[str] = None):
    """ALGO E parity: blocked phasor carrier with per-block sqrt
    renormalization; the phase state is carried inside ``d`` (the C
    struct's complex_phase), the output alone is returned."""

    x = _to_device(x, device, torch.complex64)
    n = x.shape[-1]
    if n % _LIMITED_UNROLL_SIZE:
        raise ValueError(f"ALGO E processes multiples of {_LIMITED_UNROLL_SIZE} samples")
    c0, s0 = d.phasor
    vc, vs, fc, fs = _blocked_phasor_carrier(
        n, c0, s0, d.dcos, d.dsin, _LIMITED_UNROLL_SIZE, True, x.device)
    # C carry semantics: sample i uses the phasor BEFORE its update,
    # carrier[i] = start*rot[i-1] with carrier[0] = start
    start = x.new_tensor([complex(c0, s0)])
    out = x * torch.cat([start, torch.complex(vc[:-1], vs[:-1])])
    d.phasor = (np.float32(fc), np.float32(fs))
    return out


# F/G/H are the SSE table organizations of ALGO E (pf_mixer.cpp:560-631):
# the same semantics on a vector machine, so they share the implementation.
shift_limited_unroll_A_sse_init = shift_limited_unroll_init
shift_limited_unroll_B_sse_init = shift_limited_unroll_init
shift_limited_unroll_C_sse_init = shift_limited_unroll_init
shift_limited_unroll_A_sse_inp_c = shift_limited_unroll_cc
shift_limited_unroll_B_sse_inp_c = shift_limited_unroll_cc
shift_limited_unroll_C_sse_inp_c = shift_limited_unroll_cc


_RECURSIVE_SIMD_SZ = 8  # PF_SHIFT_RECURSIVE_SIMD_SZ (pf_mixer.h:237)


class ShiftRecursiveOscState:
    """ALGO I/J state (pf_mixer.h:234-280): 8 staggered QuadOsc lanes u/v
    plus the 8-step recursion constants k1 = tan(4*D), k2 = 2 k1/(1+k1^2)."""

    def __init__(self, rate: float = 0.0, starting_phase: float = 0.0):
        self.rate = float(rate)
        u = np.empty(_RECURSIVE_SIMD_SZ, np.float32)
        v = np.empty(_RECURSIVE_SIMD_SZ, np.float32)
        u[0] = np.cos(starting_phase)
        v[0] = np.sin(starting_phase)
        d = 2.0 * np.pi * float(rate)
        k1s = np.float32(np.tan(0.5 * d))
        k2s = np.float32(2 * k1s / (1 + k1s * k1s))
        for j in range(1, _RECURSIVE_SIMD_SZ):
            tmp = u[j - 1] - k1s * v[j - 1]
            v[j] = v[j - 1] + k2s * tmp
            u[j] = tmp - k1s * v[j]
        self.u = u
        self.v = v
        db = d * _RECURSIVE_SIMD_SZ
        db = (db + np.pi) % (2 * np.pi) - np.pi
        self.k1 = np.float32(np.tan(0.5 * db))
        self.k2 = np.float32(2 * self.k1 / (1 + self.k1 * self.k1))


def shift_recursive_osc_init(rate: float, starting_phase: float = 0.0
                             ) -> ShiftRecursiveOscState:
    return ShiftRecursiveOscState(rate, starting_phase)


def shift_recursive_osc_update_rate(rate: float, state: ShiftRecursiveOscState) -> None:
    """Re-derive the recursion constants at the current phase (the C
    update_rate semantics: lane 0 keeps its phasor)."""

    ph = float(np.arctan2(state.v[0], state.u[0]))
    fresh = ShiftRecursiveOscState(rate, ph)
    state.__dict__.update(fresh.__dict__)


def _fma(a, b, c) -> np.ndarray:
    """a*b + c rounded once to float32 (the product of two float32 values
    is exact in float64)."""

    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(
        np.float32)


def _recursive_osc_carrier(state: ShiftRecursiveOscState, nblocks: int, device):
    """The 8-lane recursion over ``nblocks`` steps, a float32 loop on the
    host: block b's samples are the lanes before step b.  Each update is a
    fused multiply-add, as the reference's compiled scan contracts it.
    Advances the state; returns the carrier [8*nblocks] complex64 on
    ``device``."""

    k1, k2 = np.float32(state.k1), np.float32(state.k2)
    u, v = np.asarray(state.u, np.float32), np.asarray(state.v, np.float32)
    out = np.empty((2, nblocks, _RECURSIVE_SIMD_SZ), np.float32)
    for b in range(nblocks):
        out[0, b], out[1, b] = u, v
        tmp = _fma(-k1, v, u)   # u - k1*v
        v = _fma(k2, tmp, v)    # v + k2*tmp
        u = _fma(-k1, v, tmp)   # tmp - k1*v
    state.u, state.v = u, v
    us, vs = torch.from_numpy(out.reshape(2, -1)).to(device).unbind(0)
    return torch.complex(us, vs)


def shift_recursive_osc_cc(x, state: ShiftRecursiveOscState, *, device: Optional[str] = None):
    """ALGO I parity: multiply by the 8-lane magic-circle oscillator; the
    recursion (not trig) generates the carrier, with the reference's f32
    drift."""

    x = _to_device(x, device, torch.complex64)
    n = x.shape[-1]
    if n % _RECURSIVE_SIMD_SZ:
        raise ValueError(f"ALGO I processes multiples of {_RECURSIVE_SIMD_SZ} samples")
    return x * _recursive_osc_carrier(state, n // _RECURSIVE_SIMD_SZ, x.device)


def gen_recursive_osc_c(n: int, state: ShiftRecursiveOscState, *,
                        device: Optional[str] = None) -> torch.Tensor:
    """Generate n oscillator samples (pf_mixer.h:257) via the recursion."""

    if n % _RECURSIVE_SIMD_SZ:
        raise ValueError(f"ALGO I generates multiples of {_RECURSIVE_SIMD_SZ} samples")
    return _recursive_osc_carrier(state, n // _RECURSIVE_SIMD_SZ, torch.device(device or "cuda"))


# J is the SSE 4-lane variant of I (pf_mixer.h:262-280): the same recursion.
shift_recursive_quadrature_osc_init = shift_recursive_osc_init
shift_recursive_quadrature_osc_cc = shift_recursive_osc_cc
