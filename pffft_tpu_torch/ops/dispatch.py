"""Engine dispatch for the transforms, time-major and batch-major.

Counterpart of ``pffft_tpu/ops/dispatch.py``.  Engines of time-major
planes [N, B], with the reference's names beside them:

  * ``"stages"`` (reference ``"xla"``): the einsum stage engine,
    ``ops/split.cfft_stages_split_tmajor``, for shapes no kernel covers.
  * ``"chain"`` (reference ``"pallas"``): the single-pass Stockham chain
    kernel (``csrc/stockham_chain.cu``) on the derived thin plan.
  * ``"kern2"`` (reference ``"kern2"``): two passes for N = m*r past the
    chain's tile: the chain kernel on the free [m, r*B] view, then the
    combine kernel (``csrc/combine.cu``).

A route is decided from what the call shows: the plan's dtype and engine
length, the layout and the device's compute capability (on the CPU the
H100's (9, 0), so the tests walk the routes the card takes).  The default
follows coverage: the chain when it holds N, else kern2 with the largest
chain-covered m, else the stage engine.  Float64 plans run the stage
engine in either layout: every kernel is f32.  Two overrides sit on top:
:func:`set_engine` forces an engine for every call, and
:func:`record_engine` holds the winner of ``tune.tune_engine``'s race on
the card for a complex plan at (compute capability, N, layout).

B10, the in-kernel ksplit (``csrc/ksplit2.cu``,
:func:`cfft_ksplit2_tmajor`): kern2's function in one pass, run by a
thread-block cluster whose blocks hold the slabs' length-m transforms and
combine them through distributed shared memory (:func:`ksplit2_tile`
plans it).  No route picks it, as in the reference; it is entered
directly.

Engines of batch-major planes [..., N] (reference ``time_major=False``):

  * ``"fused2"``: the fused two-stage kernel (``csrc/fused2.cu``, B9) on
    whole rows, where its tile holds N (N <= 16384).  Its arithmetic is
    the thin chain whatever the plan, so an ordered call runs it on any
    plan; it stores an internal order itself only for the caller's own
    two-stage plan (:func:`_kernel_stores_internal`).
  * ``"tmajor"``: ``pallas_fft.cfft_pallas``, a transpose each way around
    the time-major dispatcher (chain or kern2, as :func:`select_engine`
    picks for time-major planes).
  * ``"stages"``: the batch-major stage engine,
    ``ops/split.cfft_plan_split``.

The default follows coverage: "fused2", else "tmajor", else "stages".
The reference's ``batch % 64`` gate on "fused2" is not carried over: the
kernel masks a ragged last tile.  A real plan's batch-major transform
runs the length-H complex transform through these engines, then the
batch-major split kernel (``csrc/real_split_bmajor.cu``, B6,
:func:`real_split_bmajor_route`), which covers any H and B.

A REAL plan's transform runs the same engines at its engine length
H = N/2, chosen by coverage (or :func:`set_engine`) alone: a record for a
complex plan never moves a real one.  The engine picks the real route
(the routes below):

  * ``"chain"``: the fused real kernel, one pass per direction;
  * ``"kern2"``: forward the packed-input chain on kern2's wide view, the
    combine, then the split kernel; backward the split kernel, then kern2;
  * ``"stages"``: the pack view and the stage engine, with the split
    kernel, which covers any H.

FastConv's overlap-save block pipeline has routes of its own
(:func:`conv_route_mode`): ``"fused"``, the spectral-conv kernel
(``csrc/conv_fused.cu``) where the map it launches holds nfft (the stream
map's rows up to 16384, the column map's tile, the chain's, up to 2048),
else ``"tmajor"``, the routed forward transform, a multiply by the filter
spectrum and the routed backward transform.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import plan as _plan
from ..utils import profiling as _profiling
from . import _build
from . import _grad
from . import conv_kernel as _ck
from . import fused_stage as _fs
from . import pallas_fft as _pk
from . import real_kernel as _rk
from . import split as _split
from . import stages as _stages

__all__ = [
    "available_engines",
    "select_engine",
    "set_engine",
    "record_engine",
    "cfft_dispatch",
    "cfft_kern2_tmajor",
    "cfft_kern2_tmajor_packed",
    "cfft_ksplit2_tmajor",
    "ksplit2_tmajor_plain",
    "ksplit2_tile",
    "ksplit2_occupancy",
    "Ksplit2Tile",
    "fused_real_fwd_route",
    "fused_real_bwd_route",
    "packed_fwd_route",
    "real_split_kernel_route",
    "real_split_bmajor_route",
    "CONV_ROUTES",
    "conv_route_mode",
    "conv_kernel_choice",
]

ENGINES = ("stages", "chain", "kern2")            # time-major planes
BMAJOR_ENGINES = ("fused2", "tmajor", "stages")    # batch-major planes
# engines per layout (time_major key), and the order coverage tries them in
_LAYOUT_ENGINES = {True: ENGINES, False: BMAJOR_ENGINES}
_COVERAGE = {True: ("chain", "kern2", "stages"), False: BMAJOR_ENGINES}

_FORCED: Optional[str] = None

# (compute capability, N, time_major) -> engine: tune.tune_engine's winner
# on the card, for complex plans.
_MEASURED_TABLE: dict = {}

_SM90 = (9, 0)


def capability(device: Optional[torch.device]) -> Tuple[int, int]:
    """Compute capability of a CUDA device; (9, 0) for the CPU."""

    if device is not None and torch.device(device).type == "cuda":
        return tuple(torch.cuda.get_device_capability(device))
    return _SM90


# The chain kernel's plan for length n (the radix-16/8-first chain).
_thin_plan = _pk.thin_plan


def _chain_plan(plan: _plan.Plan, device=None) -> Optional[_plan.Plan]:
    """The plan the chain engine runs (reference ``_pallas_plan``), or None
    when the plan is not f32 or the chain's tile cannot hold its engine
    length (N, or N/2 for a real plan)."""

    if plan.dtype != np.float32:
        return None
    p = _thin_plan(plan.engine_n)
    if p is None or not _chain_covers(p, device):
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


def _chain_covers(plan: _plan.Plan, device=None) -> bool:
    """Whether the chain kernel's tile holds ``plan``'s engine length."""

    radices = [st.r for st in plan.stages if st.r != 1]
    return _pk.chain_tile(plan.engine_n, radices, device) is not None


def _check_conf(what: str, n: int, m: int, r: int) -> None:
    if m * r != n:
        raise ValueError(f"{what} conf {m}*{r} != {n}")


def _kern2_conf(n: int, device=None) -> Optional[Tuple[int, int]]:
    """(m, r) for the two-pass engine: the largest chain-covered m with
    r = n/m a radix of the combine kernel, else None."""

    for r in _pk.COMBINE_RADICES:
        if n % r or n // r < 2:
            continue
        m = n // r
        mplan = _thin_plan(m)
        if mplan is not None and _chain_covers(mplan, device):
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


# ---------------------------------------------------------------------------
# B10, the in-kernel ksplit (reference ``cfft_ksplit2_tmajor``)
# ---------------------------------------------------------------------------


# B10's cluster: at most 16 blocks (a non-portable size on sm_90), each
# holding at most 32 values a thread (csrc/ksplit2.cu kElems) over at most
# CORE_MAX_THREADS threads; the batch columns a cluster tries first.
KSPLIT2_MAX_CLUSTER = 16
_KSPLIT2_ELEMS = 32
_KSPLIT2_TB = (8, 4, 2, 1)


class Ksplit2Tile(NamedTuple):
    """B10's launch shape for one (m, r) split (``ksplit2_tile``)."""

    tb: int             # batch columns per cluster
    cluster: int        # blocks per cluster; divides r
    slabs: int          # slabs per block, r // cluster
    threads: int        # threads per block
    shift: int          # tile padding: one float2 every 2**shift rows
    smem: int           # bytes of shared memory per block
    blocks_per_sm: int  # by the planner's arithmetic (pallas_fft.core_blocks_per_sm)


def ksplit2_tile(mplan: _plan.Plan, r: int, device=None, *, tb: Optional[int] = None,
                 cluster: Optional[int] = None) -> Optional[Ksplit2Tile]:
    """B10's launch shape for N = m*r, or None where no cluster of at most
    16 blocks holds it.

    A block holds ``slabs`` = r / cluster slabs of m rows by tb columns:
    at most 32 values a thread on 512 threads (16384 values), in one
    padded float2 tile per slab within the card's shared memory per
    block.  tb is the first of 8, 4, 2, 1 (or the caller's ``tb``) for
    which some cluster size fits, and the cluster the smallest divisor of
    r (or the caller's ``cluster``) that does: at m = 2048, tb = 8 with
    one slab a block for r <= 16 (cluster = r), tb = 4 with two slabs a
    block at r = 32."""

    m = mplan.engine_n
    radices = [st.r for st in mplan.stages if st.r != 1]
    shift = 3 if 8 in radices else 4
    sizes = [c for c in range(1, KSPLIT2_MAX_CLUSTER + 1) if r % c == 0]
    for t in (tb,) if tb is not None else _KSPLIT2_TB:
        for cs in (cluster,) if cluster is not None else sizes:
            if t < 1 or cs not in sizes:
                continue
            spb = r // cs
            threads = -(-(spb * m * t) // (32 * _KSPLIT2_ELEMS)) * 32
            smem = spb * (_pk.core_pad(m - 1, shift) + 1) * t * 8
            if threads <= _pk.CORE_MAX_THREADS and smem <= _pk.smem_per_block(device):
                return Ksplit2Tile(t, cs, spb, threads, shift, smem,
                                   _pk.core_blocks_per_sm(threads, smem))
    return None


def ksplit2_occupancy(mplan: _plan.Plan, r: int, tile: Ksplit2Tile,
                      device: torch.device) -> Tuple[int, int]:
    """(clusters the card holds at once, blocks per SM) of B10 at ``tile``,
    from the card's occupancy calculator (registers as ptxas gave them)."""

    lib, fn = _pk._kernel("pf_ksplit2_occupancy", f"ksplit2_r{r}")
    out = (ctypes.c_int * 2)()
    err = fn(mplan.engine_n, tile.tb, tile.cluster, tile.threads, tile.shift,
             device.index or 0, out)
    _build.check(lib, err, f"ksplit2 kernel occupancy (m={mplan.engine_n}, r={r})")
    return out[0], out[1]


def ksplit2_tmajor_plain(mplan: _plan.Plan, last, re, im, *, backward: bool = False):
    """Plain PyTorch version of B10: the chain's plain version on the free
    [m, r*B] view, then the combine's."""

    n, b = re.shape
    m, r = mplan.engine_n, last.r
    ar, ai = _pk.chain_tmajor_plain(mplan, re.reshape(m, r * b), im.reshape(m, r * b),
                                    backward=backward)
    return _pk.combine_tmajor_plain(last, ar.reshape(n, b), ai.reshape(n, b),
                                    backward=backward)


def cfft_ksplit2_tmajor(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                        backward: bool = False,
                        conf: Optional[Tuple[int, int]] = None,
                        tb: Optional[int] = None, cluster: Optional[int] = None):
    """One-pass complex FFT of time-major planes [N, B] through B10
    (``csrc/ksplit2.cu``): a cluster per tb batch columns, its blocks
    running the slabs' length-m transforms and the twiddled radix-r
    combine.

    Unscaled, canonical order.  ``conf`` is the (m, r) split, by default
    (2048, N // 2048) as in the reference; ``tb`` (batch columns per
    cluster) and ``cluster`` (blocks per cluster) override
    :func:`ksplit2_tile`'s choice.  ValueError when m*r != N, when r is
    not a combine radix, or when no cluster of at most 16 blocks holds the
    split (at the given tb and cluster).  The inputs are not modified.
    Differentiable (:class:`_Cfft`): the backward runs B10 in the other
    direction."""

    if _grad.needed(re, im):
        return _Cfft.apply(re, im, plan, backward, True, True, (conf, tb, cluster))
    return _cfft_ksplit2(plan, re, im, backward, conf, tb, cluster)


def _cfft_ksplit2(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, backward: bool,
                  conf: Optional[Tuple[int, int]], tb: Optional[int],
                  cluster: Optional[int]):
    n = plan.engine_n
    m, r = conf if conf is not None else (2048, n // 2048)
    _check_conf("ksplit2", n, m, r)
    if r not in _pk.COMBINE_RADICES:
        raise ValueError(f"ksplit2 radix {r} not in {_pk.COMBINE_RADICES}")
    rows, b = _pk._planes(re, im)
    if rows != n:
        raise ValueError(f"data length {rows} != plan engine length {n}")
    built = _build_ksplit(n, m, r)
    if built is None:
        raise ValueError(f"no ksplit2 build for N={n} (m={m}, r={r})")
    mplan, last = built
    tile = ksplit2_tile(mplan, r, re.device, tb=tb, cluster=cluster)
    if tile is None:
        raise ValueError(
            f"N={n} (m={m}, r={r}, tb={tb}, cluster={cluster}): no cluster of at most "
            f"{KSPLIT2_MAX_CLUSTER} blocks holds B10's tile (a block holds at most "
            f"{_pk.CORE_MAX_THREADS * _KSPLIT2_ELEMS} values in "
            f"{_pk.smem_per_block(re.device)} bytes of shared memory)")
    if re.device.type == "cpu":
        return ksplit2_tmajor_plain(mplan, last, re, im, backward=backward)
    _pk._check_cuda(re, im)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return ore, oim
    with _profiling.span("launch", "cfft_ksplit2_tmajor"):
        lib, fn = _pk._kernel("pf_ksplit2_tmajor", f"ksplit2_r{r}")
        tw, desc, count = _pk._core_tables(tuple(mplan.stages), re.device)
        twc = _pk._core_tables((last,), re.device)[0]
        err = fn(re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(), tw.data_ptr(),
                 desc, count, twc.data_ptr(), n, r, b, tile.tb, tile.cluster, tile.threads,
                 tile.shift, int(backward), re.device.index or 0, _pk._stream(re))
        _build.check(lib, err, f"ksplit2 kernel (N={n}, (m, r)=({m}, {r}), B={b}, "
                               f"tb={tile.tb}, cluster={tile.cluster})")
    cfft_ksplit2_tmajor.launches += 1
    return ore, oim


cfft_ksplit2_tmajor.launches = 0


def _fused2_covers(plan: _plan.Plan, device=None) -> bool:
    """Whether the "fused2" engine runs ``plan``: f32, with an engine
    length the kernel's tile holds."""

    return plan.dtype == np.float32 and _fs.fused2_tile(plan.engine_n, device) is not None


def _kernel_stores_internal(plan: _plan.Plan) -> bool:
    """Whether B9 stores ``plan``'s internal order itself: the caller's
    own complex two-stage plan.  Other internal-order calls reorder the
    ordered result."""

    return not plan.is_real and _fs.supported(plan)


def _tmajor_engines(plan: _plan.Plan, batch: int, device=None) -> Tuple[str, ...]:
    out = ["stages"] if plan.local_split is None else []
    if _chain_plan(plan, device) is not None:
        out.append("chain")
    if plan.dtype == np.float32 and _kern2_conf(plan.engine_n, device) is not None:
        out.append("kern2")
    return tuple(out)


def available_engines(plan: _plan.Plan, batch: int, time_major: bool = True,
                      device=None) -> Tuple[str, ...]:
    """Engines that can run ``plan`` on time-major planes [N, batch], or
    on batch-major planes [batch, N] when ``time_major`` is False."""

    if time_major:
        return _tmajor_engines(plan, batch, device)
    out = ["stages"]
    if _fused2_covers(plan, device):
        out.append("fused2")
    if {"chain", "kern2"} & set(_tmajor_engines(plan, batch, device)):
        out.append("tmajor")
    return tuple(out)


def set_engine(name: Optional[str]) -> None:
    """Force an engine for every call (one of :data:`ENGINES`, or None).

    A forced engine that cannot run a call raises ValueError there: the
    time-major engines serve no batch-major call, and the reverse."""

    global _FORCED
    if name is not None and name not in ENGINES + BMAJOR_ENGINES:
        raise ValueError(f"unknown engine {name!r}")
    _FORCED = name


def record_engine(cap: Tuple[int, int], n: int, engine: str,
                  time_major: bool = True) -> None:
    """Record an engine measured fastest (``tune.tune_engine``'s race) for
    complex plans at (compute capability, N, layout)."""

    if engine not in ENGINES + BMAJOR_ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine not in _LAYOUT_ENGINES[time_major]:
        raise ValueError(f"engine {engine!r} does not serve "
                         f"{'time' if time_major else 'batch'}-major planes")
    _MEASURED_TABLE[(tuple(cap), int(n), bool(time_major))] = engine


def _choose(plan: _plan.Plan, batch: int, time_major: bool, device,
            avail: Tuple[str, ...]) -> str:
    """The engine recorded for a complex plan at (compute capability, N,
    layout) where it can run the call, else the first of the layout's
    coverage order in ``avail``."""

    if not plan.is_real:
        measured = _MEASURED_TABLE.get((capability(device), plan.engine_n, bool(time_major)))
        if measured in avail:
            return measured
    for engine in _COVERAGE[time_major]:
        if engine in avail:
            return engine
    raise ValueError(f"no engine runs plan {plan} (time_major={time_major})")


@_profiling.decision
def select_engine(plan: _plan.Plan, batch: int, time_major: bool = True,
                  device=None) -> str:
    """The engine that runs ``plan`` on [N, batch] (or [batch, N]) planes
    on ``device``: the one :func:`set_engine` forced, else
    :func:`_choose`'s."""

    avail = available_engines(plan, batch, time_major, device)
    if _FORCED is not None:
        if _FORCED not in avail:
            raise ValueError(
                f"forced engine {_FORCED!r} unavailable for plan {plan} "
                f"(batch={batch}, time_major={time_major}); available: {avail}"
            )
        return _FORCED
    return _choose(plan, batch, time_major, device, avail)


def _cfft_bmajor(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                 backward: bool, ordered: bool):
    """Complex FFT of batch-major planes [..., N] (see :func:`cfft_dispatch`)."""

    lead, n = re.shape[:-1], re.shape[-1]
    batch = re.numel() // n if n else 0
    engine = select_engine(plan, batch, False, re.device)
    if engine == "stages":
        return _split.cfft_plan_split(plan, re, im, backward=backward, ordered=ordered)
    re2, im2 = re.reshape(-1, n), im.reshape(-1, n)
    in_kernel = False  # the kernel stored the internal order itself
    if engine == "fused2":
        in_kernel = not ordered and _kernel_stores_internal(plan)
        rr, ri = _fs.cfft_fused2(plan, re2, im2, backward=backward, ordered=not in_kernel)
    else:
        # "tmajor": the time-major route the dispatcher picks for [N, batch]
        tm = _choose(plan, batch, True, re.device, _tmajor_engines(plan, batch, re.device))
        rr, ri = _pk.cfft_pallas(
            plan, re2, im2, backward=backward,
            tmajor=lambda r, i: _cfft_tmajor(plan, r, i, backward=backward, engine=tm))
    if not ordered and not in_kernel:
        rr = _stages.reorder_spectrum(rr, plan.factors, to_canonical=False)
        ri = _stages.reorder_spectrum(ri, plan.factors, to_canonical=False)
    return rr.reshape(*lead, n), ri.reshape(*lead, n)


def cfft_dispatch(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                  backward: bool = False, time_major: bool = True,
                  ordered: bool = True):
    """Complex FFT through the selected engine: time-major planes [N, B],
    or batch-major planes [..., N] when ``time_major`` is False.

    Unscaled.  ``ordered=False`` (batch-major only) writes a forward
    spectrum in the plan's internal order (``stages.reorder_spectrum``);
    a backward input is always in canonical order.  Differentiable with
    respect to both planes (:class:`_Cfft`), in either layout and on every
    engine."""

    if _grad.needed(re, im):
        return _Cfft.apply(re, im, plan, backward, time_major, ordered or backward, None)
    return _cfft_dispatch(plan, re, im, backward=backward, time_major=time_major,
                          ordered=ordered)


def _cfft_dispatch(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                   backward: bool, time_major: bool, ordered: bool):
    if not time_major:
        return _cfft_bmajor(plan, re, im, backward=backward, ordered=ordered or backward)
    if not ordered:
        raise ValueError("time-major transforms are ordered")
    engine = select_engine(plan, re.shape[-1], True, re.device)
    return _cfft_tmajor(plan, re, im, backward=backward, engine=engine)


def _cfft_tmajor(plan: _plan.Plan, re: torch.Tensor, im: torch.Tensor, *,
                 backward: bool, engine: str):
    if engine == "chain":
        return _pk.cfft_chain_tmajor(_chain_plan(plan, re.device), re, im,
                                     backward=backward)
    if engine == "kern2":
        return cfft_kern2_tmajor(plan, re, im, backward=backward)
    return _split.cfft_stages_split_tmajor(
        re, im, plan.stages, backward=backward, ordered=True)


class _Cfft(torch.autograd.Function):
    """Function 1: the complex transform of :func:`cfft_dispatch` (either
    layout, every engine) or of B10 (:func:`cfft_ksplit2_tmajor`), as a map
    of the real planes.

    The adjoint of the unscaled DFT of one direction is the unscaled DFT
    of the other, so the backward is the same call in the other direction
    on the gradient planes, in the same layout.  A forward into the plan's
    internal order is the permutation P of the DFT; its adjoint reorders
    the gradient to canonical order first (P^T = P^-1).  ``ksplit2`` is
    None for the dispatcher, else B10's (conf, tb, cluster)."""

    @staticmethod
    def forward(re, im, plan, backward, time_major, ordered, ksplit2):
        if ksplit2 is not None:
            return _cfft_ksplit2(plan, re, im, backward, *ksplit2)
        return _cfft_dispatch(plan, re, im, backward=backward, time_major=time_major,
                              ordered=ordered)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.call = inputs[2:]

    @staticmethod
    def backward(ctx, gr, gi):
        plan, backward, time_major, ordered, ksplit2 = ctx.call
        gr, gi = gr.contiguous(), gi.contiguous()
        if not ordered:
            gr = _stages.reorder_spectrum(gr, plan.factors, to_canonical=True)
            gi = _stages.reorder_spectrum(gi, plan.factors, to_canonical=True)
        xr, xi = _cfft_call(gr, gi, plan, not backward, time_major, True, ksplit2)
        return xr, xi, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, re, im, *call):
        # the mapped dimension joins the batch: time-major planes [N, V, B]
        # run as [N, V*B], batch-major ones as a leading dimension
        time_major = call[2]
        re, im = (_grad.batched(t, d, info.batch_size, 1 if time_major else 0)
                  for t, d in zip((re, im), in_dims))
        if not time_major:
            return _cfft_call(re.contiguous(), im.contiguous(), *call), (0, 0)
        n, v, b = re.shape
        out = _cfft_call(re.reshape(n, v * b), im.reshape(n, v * b), *call)
        return tuple(t.view(n, v, b) for t in out), (1, 1)


def _cfft_call(re, im, plan, backward, time_major, ordered, ksplit2):
    """The public entry point of a :class:`_Cfft` call, which enters the
    Function again where a transform around it needs one."""

    if ksplit2 is not None:
        conf, tb, cluster = ksplit2
        return cfft_ksplit2_tmajor(plan, re, im, backward=backward, conf=conf, tb=tb,
                                   cluster=cluster)
    return cfft_dispatch(plan, re, im, backward=backward, time_major=time_major,
                         ordered=ordered)


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
    """Callable (sr, si) -> the real [N, B] signal through the fused real
    kernel, which writes it directly (no interleave copy), when the real
    plan's engine is the chain, else None."""

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


def real_split_bmajor_route(plan: _plan.Plan, backward: bool):
    """Callable (zr, zi) [..., H] -> the split step through the batch-major
    split kernel for a real f32 plan (the kernel covers any H and B), else
    None."""

    if not _real_f32(plan):
        return None

    def run(zr, zi):
        lead, h = zr.shape[:-1], zr.shape[-1]
        tw = _split.real_split_twiddle(plan, zr.device)
        sr, si = _rk.real_split(zr.reshape(-1, h), zi.reshape(-1, h), tw, backward=backward)
        return sr.reshape(*lead, h), si.reshape(*lead, h)

    return run


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


@_profiling.decision
def conv_route_mode(nfft: int, force: Optional[str] = None, device=None,
                    stream: bool = False) -> Optional[str]:
    """'fused' | 'tmajor' | None: which block pipeline FastConv runs at
    this block length.

    ``stream`` names the map the fused route launches: the stream map
    (``conv_kernel.zconv_stream``, FastConv's streams), whose rows
    (``conv_kernel.stream_tile``) hold nfft up to 16384, else the column
    map (``conv_kernel.zconv_tmajor``, the column pipeline), whose tile is
    the chain's (:func:`conv_kernel_choice`, nfft up to 2048).

    ``force`` ('fused' or 'tmajor') overrides the rest; a forced 'fused'
    where that map cannot hold nfft raises ValueError.  Else an engine
    forced with :func:`set_engine` other than the chain keeps the fused
    kernel (which runs the chain) out; else coverage: 'fused' where the
    map holds nfft, 'tmajor' where some engine runs it, None otherwise."""

    if stream:
        fused_ok = _ck.stream_tile(nfft, device) is not None
    else:
        fused_ok = conv_kernel_choice(nfft, 1, device) is not None
    if force is not None:
        if force not in CONV_ROUTES:
            raise ValueError(f"unknown conv route {force!r}; expected one of {CONV_ROUTES}")
        if force == "fused" and not fused_ok:
            raise ValueError(f"the fused conv kernel's {'stream' if stream else 'column'} "
                             f"map cannot hold nfft={nfft}")
        return force
    if fused_ok and _FORCED in (None, "chain"):
        return "fused"
    plan = _plan.new_setup(nfft, _plan.COMPLEX, strict=False)
    return "tmajor" if available_engines(plan, 1, True, device) else None


@_profiling.decision
def conv_kernel_choice(nfft: int, cols: int,
                       device=None) -> Optional[Tuple[_plan.Plan, _pk.ChainCoreTile]]:
    """(chain plan, column launch shape) of the fused spectral-conv kernel
    over ``cols`` columns of length ``nfft``, or None where the chain's
    coverage does not hold nfft.

    The shape is ``conv_kernel.column_tile``'s (B1's planner); the
    coverage stays the chain's (``chain_tile``).  The TPU's tile-waste rule
    does not apply: the kernel masks the ragged last tile."""

    if cols < 1:
        return None
    plan = _chain_plan(_plan.new_setup(nfft, _plan.COMPLEX, strict=False), device)
    if plan is None:
        return None
    return plan, _ck.column_tile(plan, device)
