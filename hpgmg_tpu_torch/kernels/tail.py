"""K4: the coarse-ladder ("tail") of the fv4 V-cycle: its halves, each in
one launch over every tail level (counterparts of
hpgmg_tpu/kernels/tail.py:_down_kernel, entered through tail_down_call,
and _up_kernel, entered through tail_up_call), or the whole V-subtree in
one launch (K4c, the counterpart of _v_kernel, entered through
tail_v_call).

The tail is the run of levels with TAIL_MIN_DIM <= dim <= TAIL_MAX_DIM
starting at a V-cycle's root, never including the bottom level. Below
32^3 a level's work is a few microseconds of device time against ~20
launches, each costing more host time than that; K4 does a whole descent
or climb in one launch of one thread-block cluster, whose blocks hold the
level being smoothed in their shared memory, each a slab of its i-planes
(``csrc/tail.cu``):

* ``tail_down``: per level, ``nsweeps`` GSRB half-sweeps (from the given
  iterate on the first level, from zero below), then the restricted
  residual that is the next level's rhs (mg.c:1135-1150);
* ``tail_up``: per level from the coarsest, the v2 interpolation of the
  solution below added to the pre-smoothed iterate, then ``nsweeps``
  half-sweeps (mg.c:1152-1158);
* ``tail_v``: ``tail_down``, the DIRECT bottom solve ``bottom_ainv @ r``
  on the level right below the span, then ``tail_up`` (mg.c:1135-1164
  whole), when that level is the bottom.

Dirichlet levels only: the tail kernels synthesize the quartic Dirichlet
ghosts in the kernel body. CUDA tensors launch the kernels; CPU tensors
take the plain versions, the same steps through K1's plain version and
``ops/transfer_fv.py:interp_v2``. On a bfloat16 tail (K4a and K4b; K4c
needs the DIRECT bottom, which has no bfloat16 build) each step computes
in float32 and rounds its result to bf16 once, as its own launch would:
each half-sweep, each pre-smoothed iterate, each restricted residual, and
the interpolated iterate e + interp_v2(u) of the climb. The kernels' bf16
launches count in ``bf16_launches``.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import List, Sequence, Tuple

import torch

from hpgmg_tpu_torch.core.config import BC, Smoother, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels.stencils import (_check, _stream, check_dirichlet,
                                              cluster_error, compute_dtype, dtype_suffix,
                                              fv4_stencil_plain)
from hpgmg_tpu_torch.ops.transfer_fv import interp_v2

# V-cycles route their tail levels through K4; False keeps the level-by-level
# recursion (for A/B timing).
TAIL_FUSE = True
TAIL_MAX_DIM = 32  # levels with dim <= this fuse
TAIL_MIN_DIM = 8   # quartic ghosts need 4 cells, the v2 coarse grid 2
MAX_TAIL = 6       # levels per launch (csrc/tail.cu:kMaxTail)
# Shared memory a block may use (csrc/cluster.cuh:kMaxClusterSmem).
MAX_SMEM = 232448
# A tail span right above the DIRECT bottom runs as one K4c launch
# (tail_v) instead of K4a + the bottom matvec + K4b; False keeps the three.
# Measured on an H100 (700 W; bench/profile.py --ab, fv4 512^3 f32, two
# runs in turns on/off/off/on; PERF.md): a V-cycle from 16^3 takes
# 0.083-0.114 against 0.127-0.187 ms on the device, from 32^3 0.210-0.233
# against 0.198-0.243 ms; the F-cycle chain 55.69-60.02 against
# 56.09-57.17 ms per solve, its 512^3 level setting the pace. The JAX
# package's default (False) is a TPU one.
TAIL_ONE_LAUNCH = True


def tail_smem(n0: int, itemsize: int) -> int:
    """Bytes of shared memory a K4 block takes for a tail whose first
    level is n0^3 (csrc/tail.cu:tail_smem), of values of ``itemsize``
    bytes, the compute type's (a bf16 tail's buffers hold float32): two
    buffers of its slab's
    planes (ceil(n0 / 16), 16 the blocks of K4's cluster,
    csrc/tail.cu:kTailCluster, rounded up to even) and four halo planes,
    each (n0+4)^2 values rounded up to 4."""
    planes = -(-n0 // 16)
    planes += planes & 1
    return 2 * (planes + 4) * ((((n0 + 4) ** 2) + 3) & ~3) * itemsize


def _fusible(lv: Level) -> bool:
    return (TAIL_MIN_DIM <= lv.dim <= TAIL_MAX_DIM and lv.dim % 2 == 0
            and lv.kdinv is not None and lv.part is None)


def tail_span(levels: Sequence[Level], lev: int) -> int:
    """Number of consecutive fusible levels from ``lev``, never the bottom
    level (it has no level below to restrict to)."""
    span = 0
    for lv in levels[lev:-1]:
        if not _fusible(lv) or span == MAX_TAIL:
            break
        span += 1
    return span


def use_tail(op, cfg: SolverConfig, levels: Sequence[Level], lev: int) -> bool:
    """Whether the V-cycle at ``levels[lev]`` runs its tail through K4:
    fv4, Dirichlet, GSRB with an even half-sweep count, a non-empty span,
    and no active process grid (parallel/mesh.py: off under a mesh, as in
    hpgmg_tpu/kernels/tail.py:450-453; a decomposed level is never in a
    span)."""
    from hpgmg_tpu_torch.parallel.mesh import get_active_mesh

    return (TAIL_FUSE and op.name == "fv4" and cfg.bc == BC.DIRICHLET
            and get_active_mesh() is None
            and cfg.smoother == Smoother.GSRB
            and cfg.resolved_num_smooths(op) >= 1
            and not (cfg.helmholtz and levels[lev].alpha is None)
            and tail_span(levels, lev) >= 1)


def _check_tail(tail: Sequence[Level], cfg: SolverConfig, nsweeps: int,
                tensors: Sequence[Tuple[str, torch.Tensor, tuple]]):
    _check_levels(tail, cfg, nsweeps)
    _check_tensors(tail, tensors)


def _check_levels(tail: Sequence[Level], cfg: SolverConfig, nsweeps: int):
    check_dirichlet(cfg, "the tail kernels (K4)")
    if not 1 <= len(tail) <= MAX_TAIL:
        raise ValueError(f"the tail kernels take 1..{MAX_TAIL} levels, got {len(tail)}")
    if nsweeps < 2 or nsweeps % 2:
        raise ValueError(f"the tail kernels take an even nsweeps >= 2, got {nsweeps}")
    for i, lv in enumerate(tail):
        if lv.kdinv is None:
            raise ValueError(f"tail level {lv.dim}^3 has no kdinv")
        if lv.dim < TAIL_MIN_DIM or lv.dim % 2 or (i and 2 * lv.dim != tail[i - 1].dim):
            raise ValueError(f"tail dims {[t.dim for t in tail]} do not halve "
                             f"from an even dim >= {TAIL_MIN_DIM}")
        probe = lv.kdinv[0]  # any tensor of the level's shape, dtype, device
        _check(lv, probe, cfg, "gsrb", probe, lv.kdinv)


def _check_tensors(tail: Sequence[Level], tensors: Sequence[Tuple[str, torch.Tensor, tuple]]):
    dev, dt = tail[0].device, tail[0].dtype
    for name, t, shape in tensors:
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}; "
                             f"want {shape} {dt} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _sweeps(lv: Level, x, rhs, cfg: SolverConfig, nsweeps: int):
    for s in range(nsweeps):
        x = fv4_stencil_plain(lv, x, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[s & 1])
    return x


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def tail_down_plain(tail: Sequence[Level], e, rhs, cfg: SolverConfig,
                    nsweeps: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The plain version of K4's descent. Returns (pre-smoothed iterate per
    level, restricted residual per level = the rhs of the level below)."""
    _check_tail(tail, cfg, nsweeps, [("e", e, tail[0].shape),
                                     ("rhs", rhs, tail[0].shape)])
    tail_down_plain.calls += 1
    es, rhss = [], []
    x = e
    for lv in tail:
        x = _sweeps(lv, x, rhs, cfg, nsweeps)
        es.append(x)
        rhs = fv4_stencil_plain(lv, x, cfg, "fres", rhs=rhs)
        rhss.append(rhs)
        x = torch.zeros_like(rhs)
    return es, rhss


tail_down_plain.calls = 0


def _up_tensors(tail, es, rhss, u_bot):
    d = tail[-1].dim // 2
    return ([(f"es[{i}]", e, lv.shape) for i, (lv, e) in enumerate(zip(tail, es))]
            + [(f"rhss[{i}]", r, lv.shape) for i, (lv, r) in enumerate(zip(tail, rhss))]
            + [("u_bot", u_bot, (d, d, d))])


def tail_up_plain(tail: Sequence[Level], es, rhss, u_bot, cfg: SolverConfig,
                  nsweeps: int) -> torch.Tensor:
    """The plain version of K4's climb. ``es`` and ``rhss`` are each tail
    level's pre-smoothed iterate and rhs; returns the first level's
    post-smoothed solution."""
    if len(es) != len(tail) or len(rhss) != len(tail):
        raise ValueError("tail_up wants one iterate and one rhs per level")
    _check_tail(tail, cfg, nsweeps, _up_tensors(tail, es, rhss, u_bot))
    tail_up_plain.calls += 1
    u = u_bot
    ct = compute_dtype(u.dtype)
    for lv, e, rhs in reversed(list(zip(tail, es, rhss))):
        x = interp_v2(u.to(ct), 1.0, e.to(ct), cfg.bc).to(u.dtype)
        u = _sweeps(lv, x, rhs, cfg, nsweeps)
    return u


tail_up_plain.calls = 0


def _check_bottom(tail: Sequence[Level], bottom: Level):
    d = tail[-1].dim // 2
    a = bottom.bottom_ainv
    if bottom.dim != d or a is None or tuple(a.shape) != (d ** 3, d ** 3):
        raise ValueError(f"tail_v wants the {d}^3 bottom level below the span "
                         f"with its ({d ** 3}, {d ** 3}) bottom_ainv")
    if a.dtype != tail[0].dtype or a.device != tail[0].device or not a.is_contiguous():
        raise ValueError(f"bottom_ainv is {a.dtype} on {a.device}; want a contiguous "
                         f"{tail[0].dtype} tensor on {tail[0].device}")


def tail_v_plain(tail: Sequence[Level], bottom: Level, e, rhs,
                 cfg: SolverConfig, nsweeps: int) -> torch.Tensor:
    """The plain version of K4c: the plain descent, the DIRECT bottom
    matvec on ``bottom`` (the level right below the span), the plain
    climb. Returns the first level's post-smoothed solution."""
    _check_tail(tail, cfg, nsweeps, [("e", e, tail[0].shape),
                                     ("rhs", rhs, tail[0].shape)])
    _check_bottom(tail, bottom)
    tail_v_plain.calls += 1
    es, rhss = tail_down_plain(tail, e, rhs, cfg, nsweeps)
    u_bot = (bottom.bottom_ainv @ rhss[-1].reshape(-1)).reshape(bottom.shape)
    return tail_up_plain(tail, es, [rhs] + rhss[:-1], u_bot, cfg, nsweeps)


tail_v_plain.calls = 0


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _plan(kind: str, tail, cfg, nsweeps, bottom=None) -> SimpleNamespace:
    """The unchanging part of a K4 launch, checked: the levels' pointers,
    dims and scales and the shared-memory plan. Kept with the tail's first
    level (``Level.plan``); it holds the other levels and the config its
    key names by id. Checking the levels on every call cost more host time
    than a 16^3 tail's device time."""
    key = (kind, tuple(map(id, tail[1:])), id(bottom), id(cfg), nsweeps)
    return tail[0].plan(key, lambda: _make_plan(kind, tail, cfg, nsweeps, bottom))


def _make_plan(kind: str, tail, cfg, nsweeps, bottom) -> SimpleNamespace:
    _check_levels(tail, cfg, nsweeps)
    if bottom is not None:
        _check_bottom(tail, bottom)
    n0, dt = tail[0].dim, tail[0].dtype
    # K4c's DIRECT bottom has no bfloat16 build, so neither has K4c
    suffix = dtype_suffix(dt, f"K4 ({kind})", (torch.float32, torch.float64) if kind == "v"
                          else (torch.float32, torch.float64, torch.bfloat16))
    smem = tail_smem(n0, compute_dtype(dt).itemsize)
    if smem > MAX_SMEM:
        raise ValueError(f"K4 takes no {n0}^3 {dt} tail: {smem} bytes of shared "
                         f"memory a block (at most {MAX_SMEM})")
    ptrs = []
    for lv in tail:
        alpha = lv.alpha if cfg.helmholtz else None
        # rhs, e and res (the last three) are the call's
        ptrs += [lv.beta_i.data_ptr(), lv.beta_j.data_ptr(), lv.beta_k.data_ptr(),
                 None if alpha is None else alpha.data_ptr(),
                 lv.kdinv[0].data_ptr(), lv.kdinv[1].data_ptr(), None, None, None]
    nlev = len(tail)
    return SimpleNamespace(
        held=(tuple(tail[1:]), bottom, cfg), smem=smem, ptrs=ptrs,
        dims=(ctypes.c_int * nlev)(*[lv.dim for lv in tail]),
        scales=(ctypes.c_double * nlev)(*[-cfg.b * lv.h2inv for lv in tail]),
        name=f"hpgmg_tail_{kind}_{suffix}", bf16=suffix == "bf16",
        a=float(cfg.a), nsweeps=nsweeps)


def _launch(plan: SimpleNamespace, kind: str, per_level, src, extra=()):
    """Call the plan's C entry with ``per_level``: (rhs, e, res) per level,
    ``src`` the starting iterate or the solution below, ``extra`` the
    bottom operands of the one-launch V-cycle. Raises on a cluster the card
    cannot schedule."""
    from hpgmg_tpu_torch.kernels.build import library

    ptrs = list(plan.ptrs)
    for l, (rhs, e, res) in enumerate(per_level):
        ptrs[9 * l + 6:9 * l + 9] = rhs.data_ptr(), e.data_ptr(), res.data_ptr()
    with torch.cuda.device(src.device):
        rc = getattr(library(), plan.name)(
            (ctypes.c_void_p * len(ptrs))(*ptrs), plan.dims, plan.scales, len(per_level),
            plan.nsweeps, plan.a, src.data_ptr(), *[t.data_ptr() for t in extra],
            _stream(src))
    if rc != 0:
        raise cluster_error(rc, f"the tail {kind} kernel (K4)", plan.smem)


def tail_down_cuda(tail: Sequence[Level], e, rhs, cfg: SolverConfig,
                   nsweeps: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Launch K4's descent (``csrc/tail.cu:tail_down_kernel``)."""
    plan = _plan("down", tail, cfg, nsweeps)
    _check_tensors(tail, [("e", e, tail[0].shape), ("rhs", rhs, tail[0].shape)])
    if not e.is_cuda:
        raise ValueError(f"tail_down_cuda wants CUDA tensors, got {e.device}")
    es = [torch.empty(lv.shape, dtype=e.dtype, device=e.device) for lv in tail]
    rhss = [torch.empty((lv.dim // 2,) * 3, dtype=e.dtype, device=e.device)
            for lv in tail]
    _launch(plan, "down", list(zip([rhs] + rhss[:-1], es, rhss)), e)
    if plan.bf16:
        tail_down_cuda.bf16_launches += 1
    else:
        tail_down_cuda.launches += 1
    return es, rhss


tail_down_cuda.launches = 0
tail_down_cuda.bf16_launches = 0


def tail_up_cuda(tail: Sequence[Level], es, rhss, u_bot, cfg: SolverConfig,
                 nsweeps: int) -> torch.Tensor:
    """Launch K4's climb (``csrc/tail.cu:tail_up_kernel``)."""
    if len(es) != len(tail) or len(rhss) != len(tail):
        raise ValueError("tail_up wants one iterate and one rhs per level")
    plan = _plan("up", tail, cfg, nsweeps)
    _check_tensors(tail, _up_tensors(tail, es, rhss, u_bot))
    if not u_bot.is_cuda:
        raise ValueError(f"tail_up_cuda wants CUDA tensors, got {u_bot.device}")
    outs = [torch.empty(lv.shape, dtype=u_bot.dtype, device=u_bot.device)
            for lv in tail]
    _launch(plan, "up", list(zip(rhss, es, outs)), u_bot)
    if plan.bf16:
        tail_up_cuda.bf16_launches += 1
    else:
        tail_up_cuda.launches += 1
    return outs[0]


tail_up_cuda.launches = 0
tail_up_cuda.bf16_launches = 0


def tail_v_cuda(tail: Sequence[Level], bottom: Level, e, rhs, cfg: SolverConfig,
                nsweeps: int) -> torch.Tensor:
    """Launch K4c (``csrc/tail.cu:tail_v_kernel``): the descent, the bottom
    matvec and the climb in one launch of one cluster. The climb writes
    each level's solution over its pre-smoothed iterate, so the first
    level's iterate buffer is the result."""
    plan = _plan("v", tail, cfg, nsweeps, bottom)
    _check_tensors(tail, [("e", e, tail[0].shape), ("rhs", rhs, tail[0].shape)])
    if not e.is_cuda:
        raise ValueError(f"tail_v_cuda wants CUDA tensors, got {e.device}")
    es = [torch.empty(lv.shape, dtype=e.dtype, device=e.device) for lv in tail]
    rhss = [torch.empty((lv.dim // 2,) * 3, dtype=e.dtype, device=e.device)
            for lv in tail]
    u_bot = torch.empty(bottom.shape, dtype=e.dtype, device=e.device)
    _launch(plan, "v", list(zip([rhs] + rhss[:-1], es, rhss)), e,
            extra=(bottom.bottom_ainv, u_bot))
    tail_v_cuda.launches += 1
    return es[0]


tail_v_cuda.launches = 0


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------

def tail_down(tail: Sequence[Level], e, rhs, cfg: SolverConfig, nsweeps: int):
    """K4's descent: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if e.is_cuda:
        return tail_down_cuda(tail, e, rhs, cfg, nsweeps)
    if e.device.type == "cpu":
        return tail_down_plain(tail, e, rhs, cfg, nsweeps)
    raise ValueError(f"tail_down has no kernel for device {e.device}")


def tail_up(tail: Sequence[Level], es, rhss, u_bot, cfg: SolverConfig,
            nsweeps: int):
    """K4's climb: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if u_bot.is_cuda:
        return tail_up_cuda(tail, es, rhss, u_bot, cfg, nsweeps)
    if u_bot.device.type == "cpu":
        return tail_up_plain(tail, es, rhss, u_bot, cfg, nsweeps)
    raise ValueError(f"tail_up has no kernel for device {u_bot.device}")


def tail_v(tail: Sequence[Level], bottom: Level, e, rhs, cfg: SolverConfig,
           nsweeps: int):
    """K4c, the V-subtree under a tail root over the DIRECT bottom: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if e.is_cuda:
        return tail_v_cuda(tail, bottom, e, rhs, cfg, nsweeps)
    if e.device.type == "cpu":
        return tail_v_plain(tail, bottom, e, rhs, cfg, nsweeps)
    raise ValueError(f"tail_v has no kernel for device {e.device}")
