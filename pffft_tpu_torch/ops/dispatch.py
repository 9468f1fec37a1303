"""Engine dispatch for the time-major transforms.

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

A REAL plan's transform runs the same engines at its engine length
H = N/2, chosen by the same rules from a table of its own
(:func:`record_engine_real`): real and complex route state never mix.
The engine picks the real route (the routes below):

  * ``"chain"``: the fused real kernel, one pass per direction;
  * ``"kern2"``: forward the packed-input chain on kern2's wide view, the
    combine, then the split kernel; backward the split kernel, then kern2;
  * ``"stages"``: the pack view and the stage engine, with the split
    kernel, which covers any H.

FastConv's overlap-save block pipeline has routes of its own
(:func:`conv_route_mode`): ``"fused"``, the spectral-conv kernel
(``csrc/conv_fused.cu``) where the chain's tile holds nfft, else
``"tmajor"``, the routed forward transform, a multiply by the filter
spectrum and the routed backward transform.  Its measured table,
keyed by (compute capability, nfft), starts empty too.
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
    "record_engine_real",
    "cfft_dispatch",
    "cfft_kern2_tmajor",
    "cfft_kern2_tmajor_packed",
    "fused_real_fwd_route",
    "fused_real_bwd_route",
    "packed_fwd_route",
    "real_split_kernel_route",
    "CONV_ROUTES",
    "record_conv_route",
    "conv_route_mode",
    "conv_kernel_choice",
]

ENGINES = ("stages", "chain", "kern2")

_FORCED: Optional[str] = None

# (compute capability, N, time_major) -> engine, measured on the card: one
# table for complex plans, one for real plans (keyed by the engine length).
_MEASURED_TABLE: dict = {}
_MEASURED_TABLE_REAL: dict = {}

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
    when the plan is not f32 or the chain's tile cannot hold its engine
    length (N, or N/2 for a real plan)."""

    if plan.dtype != np.float32:
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


def _kern2_build(n: int, device, conf: Optional[Tuple[int, int]]):
    """(m_plan, last_stage) of the two-pass engine for length n, with the
    (m, r) split ``conf`` or the default one."""

    c = conf if conf is not None else _kern2_conf(n, device)
    if c is None:
        raise ValueError(f"no kern2 configuration for N={n}")
    built = _build_ksplit(n, *c)
    if built is None:
        raise ValueError(f"no kern2 build for N={n} (m,r)={c}")
    return built


def cfft_kern2_tmajor(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                      backward: bool = False,
                      conf: Optional[Tuple[int, int]] = None):
    """Two-kernel-pass complex FFT, time-major planes [N, B].

    Unscaled, canonical order.  N = m*r: pass A runs the length-m chain
    kernel on the free [m, r*B] view (column (c, b) holds x[c::r]), pass B
    the combine kernel.  ``conf`` overrides the (m, r) split."""

    n, b = re.shape
    mplan, last = _kern2_build(n, re.device, conf)
    m, r = mplan.engine_n, last.r
    ar, ai = _pk.cfft_chain_tmajor(
        mplan, re.reshape(m, r * b), im.reshape(m, r * b), backward=backward)
    return _pk.cfft_combine_tmajor(
        last, ar.reshape(n, b), ai.reshape(n, b), backward=backward)


def cfft_kern2_tmajor_packed(plan: _plan.Plan, y: torch.Tensor, *,
                             conf: Optional[Tuple[int, int]] = None):
    """Two-kernel-pass forward FFT of a PACKED time-major buffer y [N, 2B]
    (the real forward's free ``x.reshape(H, 2B)``: columns :B re, B: im).

    Pass A is the packed-input chain on the free wide view [m, r*2B], whose
    slab c holds z[c::r], so the planar pack never exists; pass B is the
    combine.  Unscaled, canonical order."""

    n = plan.engine_n
    mplan, last = _kern2_build(n, y.device, conf)
    m, r = mplan.engine_n, last.r
    b = y.shape[1] // 2
    ar, ai = _pk.cfft_chain_tmajor_packed(mplan, y.reshape(m, r * 2 * b), slabs=r)
    return _pk.cfft_combine_tmajor(last, ar.reshape(n, b), ai.reshape(n, b))


def available_engines(plan: _plan.Plan, batch: int, time_major: bool = True,
                      device=None) -> Tuple[str, ...]:
    """Engines that can run ``plan`` on time-major planes [N, batch]."""

    if not time_major:
        return ()
    out = ["stages"] if plan.local_split is None else []
    if _chain_plan(plan, device) is not None:
        out.append("chain")
    if plan.dtype == np.float32 and _kern2_conf(plan.engine_n, device) is not None:
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
    """Record a measured engine choice for complex plans at (compute
    capability, N)."""

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    _MEASURED_TABLE[(tuple(cap), int(n), bool(time_major))] = engine


def record_engine_real(cap: Tuple[int, int], n: int, engine: str,
                       time_major: bool = True) -> None:
    """Record a measured engine choice for real plans at (compute
    capability, engine length n = N/2).  Complex plans never read it."""

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    _MEASURED_TABLE_REAL[(tuple(cap), int(n), bool(time_major))] = engine


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
    table = _MEASURED_TABLE_REAL if plan.is_real else _MEASURED_TABLE
    measured = table.get((capability(device), plan.engine_n, bool(time_major)))
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


# ---------------------------------------------------------------------------
# Routes of the real transform (reference ``fused_real_fwd_route`` etc.)
# ---------------------------------------------------------------------------


def _real_f32(plan: _plan.Plan) -> bool:
    return plan.is_real and plan.dtype == np.float32


def fused_real_fwd_route(plan: _plan.Plan, batch: int, device=None):
    """Callable y [H, 2B] -> packed spectrum planes [H, B] x2 through the
    fused real kernel when the real plan's engine is the chain, else None."""

    if not _real_f32(plan) or select_engine(plan, batch, True, device) != "chain":
        return None
    cplan = _chain_plan(plan, device)
    return lambda y: _pk.rfft_chain_tmajor_fused(
        cplan, y, _split.real_split_twiddle(plan, y.device))


def fused_real_bwd_route(plan: _plan.Plan, batch: int, device=None):
    """Callable (sr, si) -> the planar pre-interleave pair through the
    fused real kernel when the real plan's engine is the chain, else None."""

    if not _real_f32(plan) or select_engine(plan, batch, True, device) != "chain":
        return None
    cplan = _chain_plan(plan, device)
    return lambda sr, si: _pk.rfft_bwd_chain_tmajor_fused(
        cplan, sr, si, _split.real_split_twiddle(plan, sr.device))


def packed_fwd_route(plan: _plan.Plan, batch: int, device=None):
    """Callable y [H, 2B] -> the planar length-H spectrum pair through
    :func:`cfft_kern2_tmajor_packed` when the real plan's engine is kern2,
    else None (the chain is served by the fused route, the stage engine
    reads the pack's views)."""

    if not _real_f32(plan) or select_engine(plan, batch, True, device) != "kern2":
        return None
    return lambda y: cfft_kern2_tmajor_packed(plan, y)


def real_split_kernel_route(plan: _plan.Plan, backward: bool):
    """Callable (zr, zi) -> the split step through the split kernel for a
    real f32 plan (the kernel covers any H and B), else None."""

    if not _real_f32(plan):
        return None
    return lambda zr, zi: _pk.real_split_tmajor(
        zr, zi, _split.real_split_twiddle(plan, zr.device), backward=backward)


# ---------------------------------------------------------------------------
# Routes of the overlap-save block pipeline (reference ``conv_route_mode``)
# ---------------------------------------------------------------------------

CONV_ROUTES = ("fused", "tmajor")

# (compute capability, nfft) -> route, measured on the card.
_CONV_TABLE: dict = {}


def record_conv_route(cap: Tuple[int, int], nfft: int, route: str) -> None:
    """Record a measured FastConv route ('fused' or 'tmajor') at (compute
    capability, nfft)."""

    if route not in CONV_ROUTES:
        raise ValueError(f"unknown conv route {route!r}; expected one of {CONV_ROUTES}")
    _CONV_TABLE[(tuple(cap), int(nfft))] = route


def conv_route_mode(nfft: int, force: Optional[str] = None,
                    device=None) -> Optional[str]:
    """'fused' | 'tmajor' | None: which block pipeline FastConv runs at
    this block length.

    ``force`` ('fused' or 'tmajor') overrides the rest; a forced 'fused'
    where the kernel's tile cannot hold nfft raises ValueError.  Else an
    engine forced with :func:`set_engine` other than the chain keeps the
    fused kernel (which runs the chain) out; else the measured table; else
    coverage: 'fused' where the chain's tile holds nfft, 'tmajor' where
    some engine runs it, None otherwise."""

    fused_ok = conv_kernel_choice(nfft, 1, device) is not None
    if force is not None:
        if force not in CONV_ROUTES:
            raise ValueError(f"unknown conv route {force!r}; expected one of {CONV_ROUTES}")
        if force == "fused" and not fused_ok:
            raise ValueError(f"the fused conv kernel's tile cannot hold nfft={nfft}")
        return force
    plan = _plan.new_setup(nfft, _plan.COMPLEX, strict=False)
    tmajor_ok = bool(available_engines(plan, 1, True, device))
    if _FORCED not in (None, "chain"):
        fused_ok = False
    measured = _CONV_TABLE.get((capability(device), int(nfft)))
    if measured == "fused" and fused_ok or measured == "tmajor" and tmajor_ok:
        return measured
    if fused_ok:
        return "fused"
    return "tmajor" if tmajor_ok else None


def conv_kernel_choice(nfft: int, cols: int,
                       device=None) -> Optional[Tuple[_plan.Plan, int]]:
    """(chain plan, tile columns) of the fused spectral-conv kernel over
    ``cols`` columns of length ``nfft``, or None where the chain's tile
    cannot hold nfft.

    The tile is the chain's (``chain_tile``).  The TPU's tile-waste rule
    does not apply: the kernel masks the ragged last tile."""

    if cols < 1:
        return None
    plan = _chain_plan(_plan.new_setup(nfft, _plan.COMPLEX, strict=False), device)
    if plan is None:
        return None
    radices = [st.r for st in plan.stages if st.r != 1]
    return plan, _pk.chain_tile(nfft, radices, device)
