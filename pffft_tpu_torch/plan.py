"""Transform plans: size contract, factorization, twiddle tables.

Counterpart of ``pffft_tpu/plan.py`` for the PyTorch/CUDA port.  numpy
only: the planner never asks a backend which device it runs on.  The stage
policy is ``max_factor=5`` everywhere (the reference package's CPU policy),
so ``new_setup(n).factors`` equals ``pffft_tpu``'s under its CPU tests.

Twiddles follow the reference's native planner
(``pffft_tpu/runtime/native/planner.cc``): the exponent is reduced exactly
in integers, cos/sin are taken in long double, and the result is rounded
through float64 to the plan dtype.  The f32 tables therefore equal the
reference's native-planner tables bit for bit, and the port's own native
planner (``runtime/native/planner.cc``) gives the same tables.

All tables are stored with the FORWARD sign; backward transforms conjugate
them where they are used.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Optional, Tuple

import numpy as np

from .utils import profiling as _profiling

__all__ = [
    "Direction",
    "TransformKind",
    "FORWARD",
    "BACKWARD",
    "REAL",
    "COMPLEX",
    "StageTables",
    "Plan",
    "new_setup",
    "simd_size",
    "simd_arch",
    "min_fft_size",
    "is_valid_size",
    "nearest_transform_size",
    "next_power_of_two",
    "is_power_of_two",
    "decompose_smooth",
    "plan_factors",
    "save_plan",
    "load_plan",
    "plan_from_reference",
]


class Direction(enum.Enum):
    """Transform direction (pffft_direction_t parity)."""

    FORWARD = -1  # sign of the exponent: exp(-2i pi nk / N)
    BACKWARD = +1


class TransformKind(enum.Enum):
    """Transform kind (pffft_transform_t parity)."""

    REAL = "real"
    COMPLEX = "complex"


FORWARD = Direction.FORWARD
BACKWARD = Direction.BACKWARD
REAL = TransformKind.REAL
COMPLEX = TransformKind.COMPLEX

# The original library's SIMD width, kept as the unit of its size contract:
# complex N must be a multiple of 16, real N of 32, other factors 2, 3, 5.
_REFERENCE_SIMD_SZ = 4
_MAX_N = 1 << 26

# Default stage policy: radix <= 5 stages (140 dB carrier bound in f32).
DEFAULT_MAX_FACTOR = 5

# long double pi, the literal of the native planner
_PI_LD = np.longdouble("3.14159265358979323846264338327950288")


def simd_size() -> int:
    """pffft_simd_size parity: the original library's SIMD width (4), the
    unit of the size contract (complex N a multiple of 16, real of 32)."""

    return _REFERENCE_SIMD_SZ


def simd_arch() -> str:
    """pffft_simd_arch parity: the CUDA target the kernels are built for."""

    return "cuda-sm_90a"


def next_power_of_two(n: int) -> int:
    if n <= 0:
        return 1
    return 1 << (int(n - 1).bit_length())


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def min_fft_size(kind: TransformKind = COMPLEX) -> int:
    """Minimum supported N: 16 complex, 32 real."""

    kind = _coerce_kind(kind)
    base = _REFERENCE_SIMD_SZ * _REFERENCE_SIMD_SZ
    return 2 * base if kind == REAL else base


def _smooth_235_quotient(n: int) -> int:
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n


def is_valid_size(n: int, kind: TransformKind = COMPLEX) -> bool:
    """N is a positive multiple of min_fft_size, 2/3/5-smooth, <= 2^26."""

    kind = _coerce_kind(kind)
    m = min_fft_size(kind)
    if n <= 0 or n % m != 0 or n > _MAX_N:
        return False
    return _smooth_235_quotient(n // m) == 1


def nearest_transform_size(n: int, kind: TransformKind = COMPLEX, higher: bool = True) -> int:
    """Nearest valid size, searching up when ``higher`` else down."""

    kind = _coerce_kind(kind)
    m = min_fft_size(kind)
    if n < m:
        return m
    n = (n // m) * m if not higher else ((n + m - 1) // m) * m
    step = m if higher else -m
    while not is_valid_size(n, kind):
        n += step
        if n < m:
            return m
    return n


def _coerce_kind(kind) -> TransformKind:
    if isinstance(kind, TransformKind):
        return kind
    if isinstance(kind, str):
        return TransformKind(kind.lower())
    # the C enum's integer values: 0 = REAL, 1 = COMPLEX
    if isinstance(kind, int):
        return REAL if kind == 0 else COMPLEX
    raise TypeError(f"invalid transform kind: {kind!r}")


def _coerce_direction(direction) -> Direction:
    if isinstance(direction, Direction):
        return direction
    if isinstance(direction, str):
        s = direction.lower()
        if s in ("forward", "fwd"):
            return FORWARD
        if s in ("backward", "bwd", "inverse", "inv"):
            return BACKWARD
        raise ValueError(f"invalid direction: {direction!r}")
    # the C enum's integer values: 0 = FORWARD, 1 = BACKWARD
    if isinstance(direction, int):
        return FORWARD if direction == 0 else BACKWARD
    raise TypeError(f"invalid direction: {direction!r}")


# ---------------------------------------------------------------------------
# Factorization
# ---------------------------------------------------------------------------


def decompose_smooth(n: int) -> Tuple[int, ...]:
    """Prime factors of n from {2, 3, 5}, ascending; ValueError otherwise."""

    if n < 1:
        raise ValueError("n must be >= 1")
    out = []
    for p in (2, 3, 5):
        while n % p == 0:
            out.append(p)
            n //= p
    if n != 1:
        raise ValueError("n has prime factors other than 2, 3, 5")
    return tuple(out)


def plan_factors(n: int, max_factor: int = DEFAULT_MAX_FACTOR) -> Tuple[int, ...]:
    """Group the 2/3/5-smooth factorization of n into stage factors.

    Greedily builds balanced factors no larger than ``max_factor``; each
    returned factor is one Stockham stage.
    """

    if n == 1:
        return (1,)
    primes = sorted(decompose_smooth(n), reverse=True)
    k = 1
    while n ** (1.0 / k) > max_factor:
        k += 1
    while True:
        buckets = [1] * k
        ok = True
        for p in primes:
            for i in sorted(range(k), key=lambda i: buckets[i]):
                if buckets[i] * p <= max_factor:
                    buckets[i] *= p
                    break
            else:
                ok = False
                break
        if ok:
            return tuple(sorted((b for b in buckets if b > 1), reverse=True) or (1,))
        k += 1


# ---------------------------------------------------------------------------
# Twiddle tables
# ---------------------------------------------------------------------------


def _exp_table(e: np.ndarray, period: int, sign: int, dtype) -> np.ndarray:
    """exp(sign * 2i pi * e / period) for integer exponents e in [0, period).

    Long-double trig on the exactly reduced exponent, rounded to float64,
    then to ``dtype`` (the native planner's arithmetic, operation for
    operation).
    """

    step = np.longdouble(-2.0) * _PI_LD / np.longdouble(period)
    ang = step * e.astype(np.longdouble)
    m = np.cos(ang).astype(np.float64) + 1j * np.sin(ang).astype(np.float64)
    return (np.conj(m) if sign > 0 else m).astype(dtype)


def _dft_matrix(r: int, sign: int, dtype) -> np.ndarray:
    """Dense r x r DFT matrix W[i, t] = exp(sign * 2i pi * i * t / r)."""

    return _stage_twiddle(r, r, sign, dtype, period=r)


def _stage_twiddle(l: int, r: int, sign: int, dtype, period: int = 0) -> np.ndarray:
    """Stage twiddle T[k, i] = exp(sign * 2i pi * i * k / (l * r)), [l, r].

    Multiplies the input of the radix-r butterfly at the Stockham stage
    whose completed DFT length is l.  ``period`` (default l * r) replaces
    the denominator, as the DFT matrix needs.
    """

    period = period or l * r
    k = np.arange(l, dtype=np.int64)[:, None]
    i = np.arange(r, dtype=np.int64)[None, :]
    return _exp_table((k * i) % period, period, sign, dtype)


def _real_split_twiddle(n: int, sign: int, dtype) -> np.ndarray:
    """B[k] = exp(sign * 2i pi * k / N) for k = 0 .. N/2 - 1."""

    return _exp_table(np.arange(n // 2, dtype=np.int64), n, sign, dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class StageTables:
    """Constants of one Stockham stage.

    ``eq=False`` keeps identity hashing: device copies of the tables are
    cached per stage object.
    """

    r: int  # factor (butterfly size)
    l: int  # completed DFT length entering this stage
    m: int  # remaining span after this stage (N / (l*r))
    dft: np.ndarray  # [r, r] DFT matrix, forward sign
    twiddle: np.ndarray  # [l, r] stage twiddle, forward sign


@dataclasses.dataclass(frozen=True)
class Plan:
    """Read-only transform plan (PFFFT_Setup analog).

    For REAL kind the complex engine runs at length N/2 and
    ``real_twiddle`` holds the split-step twiddles.  ``local_split`` is
    kept for the reference's serialized layout; the port's planner never
    builds one (it needs a stage policy of ``max_factor >= 32``).
    """

    n: int
    kind: TransformKind
    dtype: np.dtype  # real scalar dtype (float32 / float64)
    cdtype: np.dtype  # complex dtype (complex64 / complex128)
    engine_n: int  # complex engine length (N for complex, N/2 for real)
    factors: Tuple[int, ...]
    stages: Tuple[StageTables, ...]
    real_twiddle: Optional[np.ndarray]  # [N/2] for REAL kind else None
    local_split: Optional[Tuple["Plan", "Plan", np.ndarray]] = None

    @staticmethod
    @functools.lru_cache(maxsize=256)
    def _cached(
        n: int,
        kind: TransformKind,
        dtype_str: str,
        max_factor: int,
        explicit_factors: Optional[Tuple[int, ...]] = None,
    ) -> "Plan":
        # a miss: its time goes to setup.seconds.plan
        with _profiling.setup("plan"):
            return Plan._make(n, kind, dtype_str, max_factor, explicit_factors)

    @staticmethod
    def _make(
        n: int,
        kind: TransformKind,
        dtype_str: str,
        max_factor: int,
        explicit_factors: Optional[Tuple[int, ...]],
    ) -> "Plan":
        dtype = np.dtype(dtype_str)
        if dtype == np.float32:
            cdtype = np.dtype(np.complex64)
        elif dtype == np.float64:
            cdtype = np.dtype(np.complex128)
        else:
            raise ValueError(f"unsupported dtype {dtype}; use float32 or float64")
        engine_n = n // 2 if kind == REAL else n
        real_tw = _real_split_twiddle(n, -1, cdtype) if kind == REAL else None
        if explicit_factors is not None:
            factors = explicit_factors
            prod = 1
            for f in factors:
                decompose_smooth(f)  # raises if not 2/3/5-smooth
                prod *= f
            if prod != engine_n:
                raise ValueError(
                    f"explicit factors {factors} multiply to {prod}, "
                    f"expected engine length {engine_n}"
                )
        else:
            factors = plan_factors(engine_n, max_factor=max_factor)
        stages = []
        l = 1
        m = engine_n
        for r in factors:
            m //= r
            stages.append(
                StageTables(
                    r=r,
                    l=l,
                    m=m,
                    dft=_dft_matrix(r, -1, cdtype),
                    twiddle=_stage_twiddle(l, r, -1, cdtype),
                )
            )
            l *= r
        return Plan(
            n=n,
            kind=kind,
            dtype=dtype,
            cdtype=cdtype,
            engine_n=engine_n,
            factors=tuple(factors),
            stages=tuple(stages),
            real_twiddle=real_tw,
        )

    @staticmethod
    def create(
        n: int,
        kind: TransformKind = COMPLEX,
        dtype="float32",
        *,
        max_factor=None,
        factors=None,
        strict: bool = True,
    ) -> "Plan":
        """Create a plan.

        ``strict=True`` enforces the size contract exactly (``is_valid_size(N)
        <=> Plan.create(N) succeeds``); ``strict=False`` accepts any
        2/3/5-smooth N >= 2.  ``factors`` pins the stage chain (a tuple
        multiplying to the engine length).
        """

        kind = _coerce_kind(kind)
        if max_factor is None:
            max_factor = DEFAULT_MAX_FACTOR
        if strict:
            if not is_valid_size(n, kind):
                raise ValueError(
                    f"invalid transform size N={n} for {kind.value} transform; "
                    f"N must be a multiple of {min_fft_size(kind)} with remaining "
                    f"factors 2, 3, 5 and N <= 2^26 "
                    f"(nearest valid: {nearest_transform_size(n, kind, True)})"
                )
        else:
            if n < 2 or (n % 2 != 0 and kind == REAL):
                raise ValueError(f"N={n} unsupported for {kind.value} transform")
            decompose_smooth(n)  # raises if not smooth
        ef = tuple(int(f) for f in factors) if factors is not None else None
        return Plan._cached(int(n), kind, np.dtype(dtype).name, int(max_factor), ef)

    @property
    def is_real(self) -> bool:
        return self.kind == REAL

    @property
    def spectrum_size(self) -> int:
        """Complex bins in the spectrum: N/2 packed for real, N for complex."""

        return self.n // 2 if self.is_real else self.n

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Plan(N={self.n}, {self.kind.value}, {self.dtype.name}, "
            f"factors={self.factors})"
        )

    def _signature(self) -> tuple:
        ls = None
        if self.local_split is not None:
            p1, p2, _ = self.local_split
            ls = (p1._signature(), p2._signature())
        return (self.n, self.kind, self.dtype.name, self.factors, ls)

    def __hash__(self) -> int:
        return hash(self._signature())

    def __eq__(self, other) -> bool:
        return isinstance(other, Plan) and self._signature() == other._signature()


# ---------------------------------------------------------------------------
# Serialization: the reference's npz layout (pffft_tpu.plan._plan_to_arrays)
# ---------------------------------------------------------------------------


def _plan_to_arrays(plan: Plan, prefix: str, out: dict) -> None:
    out[prefix + "meta"] = np.array(
        [plan.n, 0 if plan.kind == REAL else 1, plan.engine_n], dtype=np.int64
    )
    out[prefix + "dtype"] = np.array(plan.dtype.name)
    out[prefix + "factors"] = np.array(plan.factors, dtype=np.int64)
    for i, st in enumerate(plan.stages):
        sp = f"{prefix}s{i}_"
        out[sp + "rlm"] = np.array([st.r, st.l, st.m], dtype=np.int64)
        out[sp + "dft"] = st.dft
        out[sp + "tw"] = st.twiddle
    if plan.real_twiddle is not None:
        out[prefix + "real_tw"] = plan.real_twiddle
    if plan.local_split is not None:
        p1, p2, tw = plan.local_split
        out[prefix + "ls_tw"] = tw
        _plan_to_arrays(p1, prefix + "ls1_", out)
        _plan_to_arrays(p2, prefix + "ls2_", out)


def _plan_from_arrays(d, prefix: str) -> Plan:
    n, kind_i, engine_n = (int(v) for v in d[prefix + "meta"])
    kind = REAL if kind_i == 0 else COMPLEX
    dtype = np.dtype(str(d[prefix + "dtype"]))
    cdtype = np.dtype(np.complex64) if dtype == np.float32 else np.dtype(np.complex128)
    factors = tuple(int(v) for v in d[prefix + "factors"])
    stages = []
    i = 0
    while f"{prefix}s{i}_rlm" in d:
        r, l, m = (int(v) for v in d[f"{prefix}s{i}_rlm"])
        stages.append(
            StageTables(
                r=r, l=l, m=m,
                dft=np.array(d[f"{prefix}s{i}_dft"]),
                twiddle=np.array(d[f"{prefix}s{i}_tw"]),
            )
        )
        i += 1
    real_tw = np.array(d[prefix + "real_tw"]) if prefix + "real_tw" in d else None
    local_split = None
    if prefix + "ls_tw" in d:
        local_split = (
            _plan_from_arrays(d, prefix + "ls1_"),
            _plan_from_arrays(d, prefix + "ls2_"),
            np.array(d[prefix + "ls_tw"]),
        )
    return Plan(
        n=n,
        kind=kind,
        dtype=dtype,
        cdtype=cdtype,
        engine_n=engine_n,
        factors=factors,
        stages=tuple(stages),
        real_twiddle=real_tw,
        local_split=local_split,
    )


def plan_from_reference(arrays: dict) -> Plan:
    """Build a plan from the dict of numpy arrays that the reference
    package's ``_plan_to_arrays``/``save_plan`` write (prefix ``p_``).

    The tables are copied, not recomputed: the result computes with
    bit-identical constants."""

    return _plan_from_arrays(arrays, "p_")


def save_plan(plan: Plan, file) -> None:
    """Serialize a plan (all precomputed tables) to a .npz file/path."""

    arrays: dict = {}
    _plan_to_arrays(plan, "p_", arrays)
    np.savez(file, **arrays)


def load_plan(file) -> Plan:
    """Restore a plan saved by :func:`save_plan` (no table recompute)."""

    with np.load(file, allow_pickle=False) as d:
        return _plan_from_arrays(d, "p_")


def new_setup(n: int, kind=COMPLEX, dtype="float32", **kw) -> Plan:
    """pffft_new_setup parity constructor; raises ValueError on invalid N."""

    return Plan.create(n, kind, dtype, **kw)
