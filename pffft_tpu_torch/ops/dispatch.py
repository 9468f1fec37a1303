"""Engine dispatch for the complex time-major transform.

Counterpart of ``pffft_tpu/ops/dispatch.py``.  Engines, with the reference's
names beside them:

  * ``"stages"`` (reference ``"xla"``): the einsum stage engine,
    ``ops/split.cfft_stages_split_tmajor``, for shapes no kernel covers.
  * ``"chain"`` (reference ``"pallas"``): the single-pass Stockham chain
    kernel (``csrc/stockham_chain.cu``) on the derived thin plan.
  * ``"kern2"`` (reference ``"kern2"``): two passes for N = m*r past the
    chain's tile: the chain kernel on the free [m, r*B] view, then the
    combine kernel (``csrc/combine.cu``).

The default route follows coverage: the chain when it holds N, else kern2
with the largest chain-covered m, else the stage engine.  A measured
table keyed by (compute capability, N, time_major) overrides it; it
starts empty and is filled by :func:`record_engine` from measurements on
the card.  On the CPU the capability is the H100's (9, 0), so the tests
walk the routes the card takes.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import plan as _plan
from . import pallas_fft as _pk
from . import split as _split

__all__ = [
    "available_engines",
    "select_engine",
    "set_engine",
    "record_engine",
    "cfft_dispatch",
    "cfft_kern2_tmajor",
]

ENGINES = ("stages", "chain", "kern2")

_FORCED: Optional[str] = None

# (compute capability, N, time_major) -> engine, measured on the card.
_MEASURED_TABLE: dict = {}

_SM90 = (9, 0)


def capability(device: Optional[torch.device]) -> Tuple[int, int]:
    """Compute capability of a CUDA device; (9, 0) for the CPU."""

    if device is not None and torch.device(device).type == "cuda":
        return tuple(torch.cuda.get_device_capability(device))
    return _SM90


@functools.lru_cache(maxsize=64)
def _thin_plan(n: int) -> Optional[_plan.Plan]:
    """The chain kernel's plan for length n: the radix-16/8-first chain.

    The ordered spectrum does not depend on the factorization, so the
    chain may run its own plan for any caller plan of the same length."""

    factors = _pk.thin_factors(n, radix16=True)
    if factors is None:
        return None
    p = _plan.new_setup(n, _plan.COMPLEX, factors=factors, strict=False)
    return p if _pk.supported(p) else None


def _chain_plan(plan: _plan.Plan, device=None) -> Optional[_plan.Plan]:
    """The plan the chain engine runs (reference ``_pallas_plan``), or None
    when the plan is not complex f32 or the chain's tile cannot hold N."""

    if plan.dtype != np.float32 or plan.is_real:
        return None
    p = _thin_plan(plan.engine_n)
    if p is None:
        return None
    radices = [st.r for st in p.stages if st.r != 1]
    if _pk.chain_tile(p.engine_n, radices, device) is None:
        return None
    return p


@functools.lru_cache(maxsize=128)
def _build_ksplit(n: int, m: int, r: int):
    """(m_plan, last_stage) for the split n = m*r, or None.

    last_stage is the l=m, radix-r, m'=1 StageTables of the full-length
    plan with factors (thin_factors(m)..., r): its twiddle W_n^{c*k}
    finishes the transform after the length-m sub-transforms."""

    mplan = _thin_plan(m)
    if mplan is None:
        return None
    nplan = _plan.new_setup(n, _plan.COMPLEX, factors=mplan.factors + (r,),
                            strict=False)
    return mplan, [s for s in nplan.stages if s.r > 1][-1]


def _kern2_conf(n: int, device=None) -> Optional[Tuple[int, int]]:
    """(m, r) for the two-pass engine: the largest chain-covered m with
    r = n/m a radix of the combine kernel, or None."""

    for r in _pk.COMBINE_RADICES:
        if n % r:
            continue
        m = n // r
        mplan = _thin_plan(m)
        if mplan is None:
            continue
        radices = [st.r for st in mplan.stages if st.r != 1]
        if _pk.chain_tile(m, radices, device) is not None:
            return m, r
    return None


def cfft_kern2_tmajor(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                      backward: bool = False,
                      conf: Optional[Tuple[int, int]] = None):
    """Two-kernel-pass complex FFT, time-major planes [N, B].

    Unscaled, canonical order.  N = m*r: pass A runs the length-m chain
    kernel on the free [m, r*B] view (column (c, b) holds x[c::r]), pass B
    the combine kernel.  ``conf`` overrides the (m, r) split."""

    n, b = re.shape
    c = conf if conf is not None else _kern2_conf(n, re.device)
    if c is None:
        raise ValueError(f"no kern2 configuration for N={n}")
    built = _build_ksplit(n, *c)
    if built is None:
        raise ValueError(f"no kern2 build for N={n} (m,r)={c}")
    mplan, last = built
    m, r = mplan.engine_n, last.r
    ar, ai = _pk.cfft_chain_tmajor(
        mplan, re.reshape(m, r * b), im.reshape(m, r * b), backward=backward)
    return _pk.cfft_combine_tmajor(
        last, ar.reshape(n, b), ai.reshape(n, b), backward=backward)


def available_engines(plan: _plan.Plan, batch: int, time_major: bool = True,
                      device=None) -> Tuple[str, ...]:
    """Engines that can run ``plan`` on time-major planes [N, batch]."""

    if not time_major:
        return ()
    out = ["stages"] if plan.local_split is None else []
    if _chain_plan(plan, device) is not None:
        out.append("chain")
    if (plan.dtype == np.float32 and not plan.is_real
            and _kern2_conf(plan.engine_n, device) is not None):
        out.append("kern2")
    return tuple(out)


def set_engine(name: Optional[str]) -> None:
    """Force an engine for every call ('stages', 'chain', 'kern2', or None)."""

    global _FORCED
    if name is not None and name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}")
    _FORCED = name


def record_engine(cap: Tuple[int, int], n: int, engine: str,
                  time_major: bool = True) -> None:
    """Record a measured engine choice for (compute capability, N)."""

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    _MEASURED_TABLE[(tuple(cap), int(n), bool(time_major))] = engine


def select_engine(plan: _plan.Plan, batch: int, time_major: bool = True,
                  device=None) -> str:
    avail = available_engines(plan, batch, time_major, device)
    if _FORCED is not None:
        if _FORCED not in avail:
            raise ValueError(
                f"forced engine {_FORCED!r} unavailable for plan {plan} "
                f"(batch={batch}, time_major={time_major}); available: {avail}"
            )
        return _FORCED
    measured = _MEASURED_TABLE.get(
        (capability(device), plan.engine_n, bool(time_major)))
    if measured is not None and measured in avail:
        return measured
    for engine in ("chain", "kern2", "stages"):
        if engine in avail:
            return engine
    raise ValueError(f"no engine runs plan {plan} (time_major={time_major})")


def cfft_dispatch(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                  backward: bool = False, time_major: bool = True):
    """Complex FFT of planes [N, B] through the selected engine."""

    if not time_major:
        raise NotImplementedError(
            "batch-major planes are not ported yet (ROADMAP.md A4)")
    engine = select_engine(plan, re.shape[-1], True, re.device)
    if engine == "chain":
        return _pk.cfft_chain_tmajor(_chain_plan(plan, re.device), re, im,
                                     backward=backward)
    if engine == "kern2":
        return cfft_kern2_tmajor(plan, re, im, backward=backward)
    return _split.cfft_stages_split_tmajor(
        re, im, plan.stages, backward=backward, ordered=True)
