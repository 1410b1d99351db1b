"""Coarse-grid (bottom) solvers (counterpart of hpgmg_tpu/solve/bottom.py):
the DIRECT dense inverse, diagonally-preconditioned BiCGStab and CG,
smooth-until-converged, and the s-step CABiCGStab and CACG
(``solve/ca_krylov.py``).

The iterative solvers keep their convergence and breakdown flags as
tensors and read them on the host once per iteration (one device sync per
iteration of the bottom solve), where the JAX package runs a
``lax.while_loop``; each break path keeps the iterate the reference exits
with.

The bottom level of a hierarchy cut for a process grid is normally
replicated (every rank solves it whole). Where it is decomposed
(``level.part``), DIRECT gathers the rhs, applies the inverse and keeps
this rank's block; BiCGStab, CG and smooth-until-converged all-reduce
their dots and norms, and CABiCGStab and CACG their Gram matrices, so
every rank takes the same branches (the JAX package runs every bottom on
a sharded level through GSPMD).
"""

from __future__ import annotations

import torch

from hpgmg_tpu_torch.core import blas
from hpgmg_tpu_torch.core.config import BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.level import Level


def bottom_solve(op, level: Level, x, rhs, cfg: SolverConfig,
                 must_subtract_mean: bool = False):
    """Dispatch (IterativeSolver, solvers.c:17-88). ``must_subtract_mean``
    projects out the constant null space of the periodic pure-Poisson
    operator: DIRECT from the rhs and from the result, BiCGStab from every
    residual update (bicgstab.c:32-35, 58-61, 81-84)."""
    if cfg.bottom == BottomSolver.DIRECT:
        if level.bottom_ainv is None:
            raise ValueError("DIRECT bottom needs build_hierarchy to "
                             "precompute the inverse")
        from hpgmg_tpu_torch.parallel.mesh import redistribute

        r = redistribute(_subtract_mean(rhs, must_subtract_mean, cfg, level.part),
                         level.part, None)
        out = (level.bottom_ainv @ r.reshape(-1)).reshape((level.dim,) * 3)
        return redistribute(_subtract_mean(out, must_subtract_mean, cfg), None,
                            level.part)
    if cfg.bottom == BottomSolver.BICGSTAB:
        return bicgstab(op, level, x, rhs, cfg, must_subtract_mean)
    if cfg.bottom == BottomSolver.CG:
        return cg(op, level, x, rhs, cfg, must_subtract_mean)
    if cfg.bottom == BottomSolver.CABICGSTAB:
        from hpgmg_tpu_torch.solve.ca_krylov import cabicgstab

        return cabicgstab(op, level, x, rhs, cfg, must_subtract_mean)
    if cfg.bottom == BottomSolver.CACG:
        from hpgmg_tpu_torch.solve.ca_krylov import cacg

        return cacg(op, level, x, rhs, cfg, must_subtract_mean)
    if cfg.bottom == BottomSolver.SMOOTH:
        return smooth_until_converged(op, level, x, rhs, cfg, must_subtract_mean)
    raise ValueError(f"unknown bottom solver {cfg.bottom}")


def _subtract_mean(u, enabled: bool, cfg: SolverConfig, part=None):
    return u - blas.mean(u, cfg.reduce_dtype, part) if enabled else u


def bicgstab(op, level: Level, x, rhs, cfg: SolverConfig,
             must_subtract_mean: bool = False):
    """Diagonally-preconditioned BiCGStab (Saad Alg 7.7; bicgstab.c:14-97)."""
    msm, rd, part = must_subtract_mean, cfg.reduce_dtype, level.part
    r0 = _subtract_mean(op.residual(level, x, rhs, cfg), msm, cfg, part)
    r, p = r0, r0
    r_dot_r0 = blas.dot(r, r0, rd, part)
    norm_r0 = blas.norm(r0, part)
    target = cfg.bottom_rtol * norm_r0
    done = bool((r_dot_r0 == 0.0) | (norm_r0 == 0.0))

    j = 0
    while j < cfg.bottom_max_iters and not done:
        q = level.dinv * p  # diagonal preconditioner (bicgstab.c:46)
        ap = op.apply_op(level, q, cfg)
        ap_dot_r0 = blas.dot(ap, r0, rd, part)
        # pivot breakdown: break BEFORE updating x (bicgstab.c:52-54)
        alpha = r_dot_r0 / ap_dot_r0
        # ~isfinite, not isinf: in f32 a converged residual gives 0/0 = NaN
        fail_pivot = (ap_dot_r0 == 0.0) | ~torch.isfinite(alpha)

        x1 = x + alpha * q
        t = r - alpha * ap  # intermediate residual "s" in the reference
        t = _subtract_mean(t, msm, cfg, part)
        norm_t = blas.norm(t, part)
        conv_half = (norm_t == 0.0) | (norm_t < target)

        th = level.dinv * t
        at = op.apply_op(level, th, cfg)
        at_dot_at = blas.dot(at, at, rd, part)
        at_dot_t = blas.dot(at, t, rd, part)
        conv_half = conv_half | (at_dot_at == 0.0)  # bicgstab.c:74
        omega = at_dot_t / at_dot_at
        # stabilization breakdown: break after x1, before x2 (bicgstab.c:76-77)
        fail_omega = (omega == 0.0) | ~torch.isfinite(omega)

        x2 = x1 + omega * th
        r2 = _subtract_mean(t - omega * at, msm, cfg, part)
        norm_r2 = blas.norm(r2, part)
        conv_full = (norm_r2 == 0.0) | (norm_r2 < target)
        r_dot_r0_new = blas.dot(r2, r0, rd, part)
        beta = (r_dot_r0_new / r_dot_r0) * (alpha / omega)
        # Lanczos breakdown / non-finite beta: break after x2 (bicgstab.c:90-92)
        fail_late = (r_dot_r0_new == 0.0) | ~torch.isfinite(beta)
        p2 = r2 + beta * (p - omega * ap)

        keep_half = conv_half | fail_omega
        hold = keep_half | fail_pivot
        x = torch.where(fail_pivot, x, torch.where(keep_half, x1, x2))
        r = torch.where(hold, t, r2)
        p = torch.where(hold, p, p2)
        r_dot_r0 = torch.where(hold, r_dot_r0, r_dot_r0_new)
        j += 1
        done = bool(fail_pivot | fail_omega | fail_late | conv_half | conv_full)
    return x


def cg(op, level: Level, x, rhs, cfg: SolverConfig,
       must_subtract_mean: bool = False):
    """Diagonally-preconditioned CG (solvers/cg.c). A breakdown (pAp = 0,
    or a non-finite alpha: 0/0 in f32 once converged) keeps the
    pre-update iterate, like the reference's break before the update."""
    msm, rd, part = must_subtract_mean, cfg.reduce_dtype, level.part
    r = _subtract_mean(op.residual(level, x, rhs, cfg), msm, cfg, part)
    norm_r0 = blas.norm(r, part)
    target = cfg.bottom_rtol * norm_r0
    p = level.dinv * r
    rtz = blas.dot(r, p, rd, part)
    done = bool(norm_r0 == 0.0)

    j = 0
    while j < cfg.bottom_max_iters and not done:
        ap = op.apply_op(level, p, cfg)
        pap = blas.dot(p, ap, rd, part)
        alpha = rtz / pap
        ok = (pap != 0.0) & torch.isfinite(alpha)
        x = torch.where(ok, x + alpha * p, x)
        r = _subtract_mean(torch.where(ok, r - alpha * ap, r), msm, cfg, part)
        nr = blas.norm(r, part)
        z = level.dinv * r
        rtz_new = blas.dot(r, z, rd, part)
        p = z + (rtz_new / rtz) * p
        rtz = rtz_new
        j += 1
        done = bool(~ok | (nr < target) | (nr == 0.0))
    return x


def smooth_until_converged(op, level: Level, x, rhs, cfg: SolverConfig,
                           must_subtract_mean: bool = False):
    """The fallback bottom solve (solvers.c:17-88, its ``#else`` branch):
    smooth until ||r|| <= bottom_rtol * ||r0||, at most bottom_max_iters
    smoother calls."""
    from hpgmg_tpu_torch.solve.smoothers import smooth

    msm, part = must_subtract_mean, level.part
    norm_r = blas.norm(_subtract_mean(op.residual(level, x, rhs, cfg), msm, cfg, part), part)
    target = cfg.bottom_rtol * norm_r
    j = 0
    while j < cfg.bottom_max_iters and bool(norm_r > target):
        x = smooth(op, level, x, rhs, cfg)
        norm_r = blas.norm(_subtract_mean(op.residual(level, x, rhs, cfg), msm, cfg, part),
                           part)
        j += 1
    return x
