"""Coarse-grid (bottom) solvers (counterpart of hpgmg_tpu/solve/bottom.py):
the DIRECT dense inverse and diagonally-preconditioned BiCGStab. The other
bottom solvers raise NotImplementedError.
"""

from __future__ import annotations

import torch

from hpgmg_tpu_torch.core import blas
from hpgmg_tpu_torch.core.config import BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.level import Level


def bottom_solve(op, level: Level, x, rhs, cfg: SolverConfig):
    """Dispatch (IterativeSolver, solvers.c:17-88)."""
    if cfg.bottom == BottomSolver.DIRECT:
        if level.bottom_ainv is None:
            raise ValueError("DIRECT bottom needs build_hierarchy to "
                             "precompute the inverse")
        return (level.bottom_ainv @ rhs.reshape(-1)).reshape(level.shape)
    if cfg.bottom == BottomSolver.BICGSTAB:
        return bicgstab(op, level, x, rhs, cfg)
    raise NotImplementedError(f"bottom solver {cfg.bottom} is not ported yet")


def bicgstab(op, level: Level, x, rhs, cfg: SolverConfig):
    """Diagonally-preconditioned BiCGStab (Saad Alg 7.7; bicgstab.c:14-97).

    The convergence and the breakdown flags are tensors; the loop reads
    them on the host once per iteration (one device sync per iteration of
    the bottom solve). Each break path keeps the iterate the reference
    exits with.
    """
    r0 = op.residual(level, x, rhs, cfg)
    r, p = r0, r0
    r_dot_r0 = blas.dot(r, r0)
    norm_r0 = blas.norm(r0)
    target = cfg.bottom_rtol * norm_r0
    done = bool((r_dot_r0 == 0.0) | (norm_r0 == 0.0))

    j = 0
    while j < cfg.bottom_max_iters and not done:
        q = level.dinv * p  # diagonal preconditioner (bicgstab.c:46)
        ap = op.apply_op(level, q, cfg)
        ap_dot_r0 = blas.dot(ap, r0)
        # pivot breakdown: break BEFORE updating x (bicgstab.c:52-54)
        alpha = r_dot_r0 / ap_dot_r0
        # ~isfinite, not isinf: in f32 a converged residual gives 0/0 = NaN
        fail_pivot = (ap_dot_r0 == 0.0) | ~torch.isfinite(alpha)

        x1 = x + alpha * q
        t = r - alpha * ap  # intermediate residual "s" in the reference
        norm_t = blas.norm(t)
        conv_half = (norm_t == 0.0) | (norm_t < target)

        th = level.dinv * t
        at = op.apply_op(level, th, cfg)
        at_dot_at = blas.dot(at, at)
        at_dot_t = blas.dot(at, t)
        conv_half = conv_half | (at_dot_at == 0.0)  # bicgstab.c:74
        omega = at_dot_t / at_dot_at
        # stabilization breakdown: break after x1, before x2 (bicgstab.c:76-77)
        fail_omega = (omega == 0.0) | ~torch.isfinite(omega)

        x2 = x1 + omega * th
        r2 = t - omega * at
        norm_r2 = blas.norm(r2)
        conv_full = (norm_r2 == 0.0) | (norm_r2 < target)
        r_dot_r0_new = blas.dot(r2, r0)
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
