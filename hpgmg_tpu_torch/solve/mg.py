"""Multigrid cycles (counterpart of hpgmg_tpu/solve/mg.py; mg.c:1135-1607):
V-cycle, MGSolve, FMGSolve, the iterated F-cycle FMGSolve2 and its
compensated double-f32 variant, MGPCG, and the Richardson analysis.

Everything runs eagerly. ``fmg_solve`` and ``mg_solve_fixed`` enqueue
their whole solve without a device sync (an iterative bottom solver, if
chosen, syncs once per iteration); ``mg_solve``, ``fmg_solve2``,
``fmg_solve2_dd`` and ``mgpcg`` read one value on the host per cycle or
iteration, for their early exit.

``vcycle`` and ``fmg_solve`` also run in the timed mode of the
reference's MGPrintTiming (mg.c:54-163): given a ``timers`` dict, each
phase of the cycle (smooth, residual, restriction, interpolation,
interpolation_f, bottom) runs between two device syncs and adds its
wall-clock seconds to ``timers[(level, phase)]`` (``_phase``). Without
``timers`` each phase runs under ``utils.profiler.scope("mg.L{lev}.
{phase}")``, a named range inside a ``trace`` and nothing outside one.

On a hierarchy cut for a process grid (parallel/mesh.py:shard_hierarchy)
every rank runs the same cycle on its blocks: a decomposed level's fields
are local, its reductions all-reduced (``level.part``); the restriction
stays local (K3 on the block) and is gathered where the next level is
held otherwise (``redistribute``, at the first replicated level going
down), and the interpolation reads the coarse block's halo
(ops/transfer.py:interpolate).
"""

from __future__ import annotations

import time
from typing import List, Tuple

import torch

from hpgmg_tpu_torch.core import blas
from hpgmg_tpu_torch.core.config import BC, BottomSolver, CycleType, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import Hierarchy
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels import tail as _tail
from hpgmg_tpu_torch.kernels.tail import tail_down, tail_span, tail_up, tail_v, use_tail
from hpgmg_tpu_torch.ops.base import OperatorSuite, get_suite
from hpgmg_tpu_torch.ops.transfer import get_interpolation, restrict_cell
from hpgmg_tpu_torch.parallel.mesh import redistribute
from hpgmg_tpu_torch.solve.bottom import bottom_solve
from hpgmg_tpu_torch.solve.smoothers import smooth
from hpgmg_tpu_torch.utils.profiler import scope


def _must_subtract_mean(cfg: SolverConfig) -> bool:
    """Periodic pure Poisson has the constants as null space (mg.c:1008-1018)."""
    return cfg.bc == BC.PERIODIC and not cfg.helmholtz


def _half(part):
    """The Part a local restriction of a block of ``part`` leaves."""
    return None if part is None else part.coarsen()


def _sync(x: torch.Tensor):
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _phase(timers, lev: int, name: str, fn, x: torch.Tensor):
    """Run one cycle phase ``fn()``, whose input ``x`` says its device.
    Untimed (``timers`` is None): under the named range
    ``mg.L{lev}.{name}``. Timed (``timers`` a dict): between a sync of the
    device before it and one after it, adding the wall-clock seconds to
    ``timers[(lev, name)]``: the reference's per-level accumulators
    (level.h:162-196), read in solve order."""
    if timers is None:
        with scope(f"mg.L{lev}.{name}"):
            return fn()
    _sync(x)
    t0 = time.perf_counter()
    out = fn()
    _sync(x)
    timers[(lev, name)] = timers.get((lev, name), 0.0) + time.perf_counter() - t0
    return out


def vcycle(op: OperatorSuite, levels: List[Level], lev: int, e, rhs,
           cfg: SolverConfig, timers=None):
    """One V-cycle from level ``lev`` down to the bottom (MGVCycle,
    mg.c:1135): smooth, residual+restriction, recurse, interpolate (+=),
    smooth; the bottom level runs the bottom solver, and the tail levels
    (dims <= 32 above the bottom) run through K4. The timed mode
    (``timers``, see ``_phase``) takes no tail and runs the residual and
    the restriction as two phases."""
    level = levels[lev]
    if lev == len(levels) - 1:
        return _phase(timers, lev, "bottom",
                      lambda: bottom_solve(op, level, e, rhs, cfg,
                                           _must_subtract_mean(cfg)), rhs)
    if timers is None and use_tail(op, cfg, levels, lev):
        with scope(f"mg.L{lev}.tail"):
            return _tail_vcycle(op, levels, lev, e, rhs, cfg)
    e = _phase(timers, lev, "smooth", lambda: smooth(op, level, e, rhs, cfg), e)
    coarse = levels[lev + 1]
    if timers is None:
        with scope(f"mg.L{lev}.res+restrict"):
            rhs_c = redistribute(op.restrict_residual(level, e, rhs, cfg),
                                 _half(level.part), coarse.part)
    else:
        t = _phase(timers, lev, "residual", lambda: op.residual(level, e, rhs, cfg), e)
        rhs_c = _phase(timers, lev, "restriction",
                       lambda: redistribute(restrict_cell(t), _half(level.part),
                                            coarse.part), t)
    e_c = vcycle(op, levels, lev + 1, torch.zeros_like(rhs_c), rhs_c, cfg, timers)
    interp = get_interpolation(op.interpolation_vcycle)
    e = _phase(timers, lev, "interpolation",
               lambda: interp(e_c, 1.0, e, cfg.bc, coarse=coarse.part, fine=level.part),
               e_c)
    return _phase(timers, lev, "smooth", lambda: smooth(op, level, e, rhs, cfg), e)


def _tail_vcycle(op: OperatorSuite, levels: List[Level], lev: int, e, rhs,
                 cfg: SolverConfig):
    """The V-cycle from a tail root: K4's descent over the tail span, the
    ordinary recursion below it (the bottom solve), K4's climb; or, with
    ``tail.TAIL_ONE_LAUNCH`` and the DIRECT bottom right below the span,
    all three in one launch (K4c, hpgmg_tpu/kernels/tail.py:483-487)."""
    span = tail_span(levels, lev)
    tail = levels[lev:lev + span]
    below = levels[lev + span]
    nsweeps = 2 * cfg.resolved_num_smooths(op)
    if (_tail.TAIL_ONE_LAUNCH and lev + span == len(levels) - 1
            and cfg.bottom == BottomSolver.DIRECT and below.bottom_ainv is not None):
        return tail_v(tail, below, e, rhs, cfg, nsweeps)
    es, rhss = tail_down(tail, e, rhs, cfg, nsweeps)
    e_below = vcycle(op, levels, lev + span, torch.zeros_like(rhss[-1]),
                     rhss[-1], cfg)
    return tail_up(tail, es, [rhs] + rhss[:-1], e_below, cfg, nsweeps)


def _cycle_norm(op, level, u, f, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Post-cycle true-residual max norm (mg.c:1208-1213), u made mean-free
    first where the operator is singular. Returns (u, norm)."""
    if _must_subtract_mean(cfg):
        u = u - blas.mean(u, cfg.reduce_dtype, level.part)
    return u, blas.norm(op.residual(level, u, f, cfg), level.part)


def mg_solve(op: OperatorSuite, hier: Hierarchy, f, cfg: SolverConfig,
             u0=None, verbose: bool = False):
    """MGSolve (mg.c:1168-1233): V-cycles until ||r||/||F|| < rtol, one
    host sync per cycle. Returns (u, per-cycle relative residuals)."""
    levels = hier.levels
    u = torch.zeros_like(f) if u0 is None else u0
    norm_f = float(blas.norm(f, levels[0].part))
    history = []
    for v in range(cfg.max_vcycles):
        u, norm_r = _cycle_norm(op, levels[0], vcycle(op, levels, 0, u, f, cfg),
                                f, cfg)
        norm_r = float(norm_r)
        rel = norm_r / norm_f if norm_f != 0.0 else norm_r
        history.append(rel)
        if verbose:
            print(f"v-cycle={v + 1:2d}  norm={norm_r:1.15e}  rel={rel:1.15e}")
        if rel < cfg.rtol:
            break
    return u, history


def mg_solve_fixed(op: OperatorSuite, hier: Hierarchy, f, cfg: SolverConfig,
                   num_cycles: int, u0=None):
    """MGSolve with a fixed V-cycle count and no host sync. Returns
    (u, stacked relative residual norms)."""
    levels = hier.levels
    u = torch.zeros_like(f) if u0 is None else u0
    norm_f = blas.norm(f, levels[0].part)
    rels = []
    for _ in range(num_cycles):
        u, norm_r = _cycle_norm(op, levels[0], vcycle(op, levels, 0, u, f, cfg),
                                f, cfg)
        rels.append(norm_r / norm_f)
    return u, torch.stack(rels)


def fmg_solve(op: OperatorSuite, hier: Hierarchy, f, cfg: SolverConfig,
              u0=None, timers=None):
    """FMGSolve (mg.c:1237-1344): one F-cycle. Restrict F to every level,
    solve the coarsest, then per level a high-order interpolation and a
    V-cycle up to the finest. Returns (u, norm_r, norm_f), the norms as
    0-d tensors; u is mean-free where the operator is singular.
    ``timers``: the timed mode's per-level accumulator dict (``_phase``)."""
    levels = hier.levels
    norm_f = blas.norm(f, levels[0].part)

    rhs = [f]  # restrict the rhs down the whole ladder (mg.c:1274-1278)
    for lev in range(len(levels) - 1):
        t = rhs[-1]
        rhs.append(_phase(timers, lev, "restriction",
                          lambda: redistribute(restrict_cell(t), _half(levels[lev].part),
                                               levels[lev + 1].part), t))

    bot = len(levels) - 1  # coarsest-grid solve (mg.c:1283-1287)
    if bot == 0 and u0 is not None:
        u = u0
    else:
        u = torch.zeros_like(rhs[bot])
    u = _phase(timers, bot, "bottom",
               lambda: bottom_solve(op, levels[bot], u, rhs[bot], cfg,
                                    _must_subtract_mean(cfg)), rhs[bot])

    interp_f = get_interpolation(op.interpolation_fcycle)
    for lev in range(bot - 1, -1, -1):
        # prescale 0: overwrite (mg.c:1295)
        u = _phase(timers, lev, "interpolation_f",
                   lambda: interp_f(u, 0.0, None, cfg.bc, coarse=levels[lev + 1].part,
                                    fine=levels[lev].part), u)
        u = vcycle(op, levels, lev, u, rhs[lev], cfg, timers)
    for _ in range(cfg.post_f_vcycles):  # trailing V-cycles, a fixed count
        u = vcycle(op, levels, 0, u, f, cfg, timers)
    u, norm_r = _cycle_norm(op, levels[0], u, f, cfg)
    return u, norm_r, norm_f


def fmg_solve2(op: OperatorSuite, hier: Hierarchy, f, cfg: SolverConfig,
               u0=None, max_fcycles: int = 20, verbose: bool = False):
    """FMGSolve2 (mg.c:1348-1495): iterated F-cycles in residual-correction
    form: r = f - A u, solve A e = r with one F-cycle, u += e, until
    ||f - A u|| / ||f|| < rtol. Returns (u, per-F-cycle relative
    residuals)."""
    lv0 = hier.levels[0]
    u = torch.zeros_like(f) if u0 is None else u0
    norm_f = float(blas.norm(f, lv0.part))
    history = []
    for fc in range(max_fcycles):
        e, _, _ = fmg_solve(op, hier, op.residual(lv0, u, f, cfg), cfg)
        u = u + e
        if _must_subtract_mean(cfg):
            u = u - blas.mean(u, cfg.reduce_dtype, lv0.part)
        norm_r = float(blas.norm(op.residual(lv0, u, f, cfg), lv0.part))
        history.append(norm_r / norm_f)
        if verbose:
            print(f"f-cycle={fc + 1:2d}  norm={norm_r:1.15e}  rel={history[-1]:1.15e}")
        if history[-1] < cfg.rtol:
            break
    return u, history


def fmg_solve2_dd(op: OperatorSuite, hier: Hierarchy, f, cfg: SolverConfig,
                  max_fcycles: int = 20, verbose: bool = False):
    """FMGSolve2 with a compensated fine-level iterate: the solution is
    the unevaluated sum u_hi + u_lo of two tensors of the solve dtype
    (Dekker/Knuth two-sum accumulation), so in f32 the representation
    noise of u no longer floors the residual at ~5e-4 (the h^-2-scaled
    stencil amplifies it); every apply, transfer and smooth stays in the
    solve dtype on the kernels:

        r   = (f - A u_hi) - A u_lo      (linearity; two applies)
        e   = FMG(r)                     (one F-cycle)
        u   = two_sum(u_hi, u_lo + e)    (exact-error accumulation)

    Returns (u_hi, u_lo, per-F-cycle relative residuals)."""
    lv0 = hier.levels[0]
    u_hi = torch.zeros_like(f)
    u_lo = torch.zeros_like(f)
    part = lv0.part
    norm_f = float(blas.norm(f, part))
    history = []
    for fc in range(max_fcycles):
        # residual of the unevaluated sum: the big cancellation first
        r = op.residual(lv0, u_hi, f, cfg) - op.apply_op(lv0, u_lo, cfg)
        e, _, _ = fmg_solve(op, hier, r, cfg)
        # two-sum: (u_hi, u_lo) <- fl(u_hi + t) and its exact error, as
        # separate operations in this order
        t = u_lo + e
        s = u_hi + t
        err = (u_hi - s) + t
        if _must_subtract_mean(cfg):
            s = s - (blas.mean(s, cfg.reduce_dtype, part)
                     + blas.mean(err, cfg.reduce_dtype, part))
        u_hi, u_lo = s, err
        norm_r = float(blas.norm(op.residual(lv0, u_hi, f, cfg)
                                 - op.apply_op(lv0, u_lo, cfg), part))
        history.append(norm_r / norm_f)
        if verbose:
            print(f"f-cycle={fc + 1:2d}  norm={norm_r:1.15e}  rel={history[-1]:1.15e}")
        if history[-1] < cfg.rtol:
            break
    return u_hi, u_lo, history


def mgpcg(op: OperatorSuite, hier: Hierarchy, f, cfg: SolverConfig,
          max_iters: int = 20, verbose: bool = False):
    """MGPCG (mg.c:1500-1607): CG preconditioned by one V-cycle (Saad
    Alg 9.1), the true residual recomputed every iteration for the
    convergence test (mg.c:1578-1585), relative to the initial residual.
    Returns (x, per-iteration relative true residuals)."""
    levels = hier.levels
    lv0, rd = levels[0], cfg.reduce_dtype
    part = lv0.part
    msm = _must_subtract_mean(cfg)

    def precond(r):
        return vcycle(op, levels, 0, torch.zeros_like(r), r, cfg)

    x = torch.zeros_like(f)
    r = op.residual(lv0, x, f, cfg)
    if msm:
        r = r - blas.mean(r, rd, part)
    z = precond(r)
    r_dot_z = blas.dot(r, z, rd, part)
    norm_r0 = float(blas.norm(r, part))
    p = z
    history = []
    for j in range(max_iters):
        ap = op.apply_op(lv0, p, cfg)
        alpha = r_dot_z / blas.dot(ap, p, rd, part)
        x = x + alpha * p
        r = r - alpha * ap
        if msm:
            r = r - blas.mean(r, rd, part)
        norm_true = float(blas.norm(op.residual(lv0, x, f, cfg), part))
        z = precond(r)
        r_dot_z_new = blas.dot(r, z, rd, part)
        p = z + (r_dot_z_new / r_dot_z) * p
        r_dot_z = r_dot_z_new
        history.append(norm_true / norm_r0)
        if verbose:
            print(f"iter={j + 1:3d}  norm={norm_true:1.15e}  rel={history[-1]:1.15e}")
        if history[-1] < cfg.rtol:
            break
    return x, history


def richardson_error(op: OperatorSuite, u_h, u_2h, u_4h,
                     parts=(None, None, None)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Richardson order from solves at h, 2h, 4h (mg.c:1113-1131), each
    held as its ``parts`` entry says (None: the whole field).
    Returns (||u2h - R uh||_max, log2(||u4h - R u2h|| / ||u2h - R uh||))."""
    p_h, p_2h, p_4h = parts
    e_h = blas.norm(u_2h - redistribute(restrict_cell(u_h), _half(p_h), p_2h), p_2h)
    e_2h = blas.norm(u_4h - redistribute(restrict_cell(u_2h), _half(p_2h), p_4h), p_4h)
    return e_h, torch.log2(e_2h / e_h)


class MGSolver:
    """Binds an operator suite, a config and a hierarchy."""

    def __init__(self, hier: Hierarchy, cfg: SolverConfig):
        self.hier = hier
        self.cfg = cfg
        self.op = get_suite(cfg.op)

    def solve(self, f, u0=None, verbose: bool = False):
        if self.cfg.cycle == CycleType.F:
            u, norm_r, norm_f = fmg_solve(self.op, self.hier, f, self.cfg)
            nr = float(norm_r)
            rel = nr / float(norm_f)
            if verbose:
                print(f"f-cycle     norm={nr:1.15e}  rel={rel:1.15e}")
            return u, [rel]
        return mg_solve(self.op, self.hier, f, self.cfg, u0=u0, verbose=verbose)
