"""Multigrid cycles (counterpart of hpgmg_tpu/solve/mg.py; mg.c:1135-1344):
V-cycle, MGSolve, FMGSolve and the Richardson analysis.

Everything runs eagerly. Only ``mg_solve`` reads a value on the host (once
per cycle, for its early exit); ``fmg_solve`` and ``mg_solve_fixed``
enqueue their whole solve without a device sync (the BiCGStab bottom, if
chosen, syncs once per iteration).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from hpgmg_tpu_torch.core import blas
from hpgmg_tpu_torch.core.config import CycleType, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import Hierarchy
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels.tail import tail_down, tail_span, tail_up, use_tail
from hpgmg_tpu_torch.ops.base import OperatorSuite, get_suite
from hpgmg_tpu_torch.ops.transfer import get_interpolation, restrict_cell
from hpgmg_tpu_torch.solve.bottom import bottom_solve
from hpgmg_tpu_torch.solve.smoothers import smooth


def vcycle(op: OperatorSuite, levels: List[Level], lev: int, e, rhs,
           cfg: SolverConfig):
    """One V-cycle from level ``lev`` down to the bottom (MGVCycle,
    mg.c:1135): smooth, residual+restriction, recurse, interpolate (+=),
    smooth; the bottom level runs the bottom solver, and the tail levels
    (dims <= 32 above the bottom) run through K4."""
    level = levels[lev]
    if lev == len(levels) - 1:
        return bottom_solve(op, level, e, rhs, cfg)
    if use_tail(op, cfg, levels, lev):
        return _tail_vcycle(op, levels, lev, e, rhs, cfg)
    e = smooth(op, level, e, rhs, cfg)
    rhs_c = op.restrict_residual(level, e, rhs, cfg)
    e_c = vcycle(op, levels, lev + 1, torch.zeros_like(rhs_c), rhs_c, cfg)
    interp = get_interpolation(op.interpolation_vcycle)
    e = interp(e_c, 1.0, e, cfg.bc)
    return smooth(op, level, e, rhs, cfg)


def _tail_vcycle(op: OperatorSuite, levels: List[Level], lev: int, e, rhs,
                 cfg: SolverConfig):
    """The V-cycle from a tail root: K4's descent over the tail span, the
    ordinary recursion below it (the bottom solve), K4's climb."""
    span = tail_span(levels, lev)
    tail = levels[lev:lev + span]
    nsweeps = 2 * cfg.resolved_num_smooths(op)
    es, rhss = tail_down(tail, e, rhs, cfg, nsweeps)
    e_below = vcycle(op, levels, lev + span, torch.zeros_like(rhss[-1]),
                     rhss[-1], cfg)
    return tail_up(tail, es, [rhs] + rhss[:-1], e_below, cfg, nsweeps)


def _cycle_norm(op, level, u, f, cfg) -> torch.Tensor:
    """Post-cycle true-residual max norm (mg.c:1208-1213)."""
    return blas.norm(op.residual(level, u, f, cfg))


def mg_solve(op: OperatorSuite, hier: Hierarchy, f, cfg: SolverConfig,
             u0=None, verbose: bool = False):
    """MGSolve (mg.c:1168-1233): V-cycles until ||r||/||F|| < rtol, one
    host sync per cycle. Returns (u, per-cycle relative residuals)."""
    levels = hier.levels
    u = torch.zeros_like(f) if u0 is None else u0
    norm_f = float(blas.norm(f))
    history = []
    for v in range(cfg.max_vcycles):
        u = vcycle(op, levels, 0, u, f, cfg)
        norm_r = float(_cycle_norm(op, levels[0], u, f, cfg))
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
    norm_f = blas.norm(f)
    rels = []
    for _ in range(num_cycles):
        u = vcycle(op, levels, 0, u, f, cfg)
        rels.append(_cycle_norm(op, levels[0], u, f, cfg) / norm_f)
    return u, torch.stack(rels)


def fmg_solve(op: OperatorSuite, hier: Hierarchy, f, cfg: SolverConfig,
              u0=None):
    """FMGSolve (mg.c:1237-1344): one F-cycle. Restrict F to every level,
    solve the coarsest, then per level a high-order interpolation and a
    V-cycle up to the finest. Returns (u, norm_r, norm_f), the norms as
    0-d tensors."""
    levels = hier.levels
    norm_f = blas.norm(f)

    rhs = [f]  # restrict the rhs down the whole ladder (mg.c:1274-1278)
    for _ in range(len(levels) - 1):
        rhs.append(restrict_cell(rhs[-1]))

    bot = len(levels) - 1  # coarsest-grid solve (mg.c:1283-1287)
    if bot == 0 and u0 is not None:
        u = u0
    else:
        u = torch.zeros_like(rhs[bot])
    u = bottom_solve(op, levels[bot], u, rhs[bot], cfg)

    interp_f = get_interpolation(op.interpolation_fcycle)
    for lev in range(bot - 1, -1, -1):
        u = interp_f(u, 0.0, None, cfg.bc)  # prescale 0: overwrite (mg.c:1295)
        u = vcycle(op, levels, lev, u, rhs[lev], cfg)
    return u, _cycle_norm(op, levels[0], u, f, cfg), norm_f


def richardson_error(op: OperatorSuite, u_h, u_2h,
                     u_4h) -> Tuple[torch.Tensor, torch.Tensor]:
    """Richardson order from solves at h, 2h, 4h (mg.c:1113-1131).
    Returns (||u2h - R uh||_max, log2(||u4h - R u2h|| / ||u2h - R uh||))."""
    e_h = blas.norm(u_2h - restrict_cell(u_h))
    e_2h = blas.norm(u_4h - restrict_cell(u_2h))
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
