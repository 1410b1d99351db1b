"""Multigrid hierarchy construction (counterpart of
hpgmg_tpu/core/hierarchy.py; MGBuild, mg.c:842-1108).

The ladder is the list of level dims. Coefficients are restricted level to
level (cell restriction for alpha, face restriction for the betas), then
the suite's ``rebuild_operator`` derives Dinv / L1inv / lambda_max per
level (fv4 extends its betas tangentially there; the radius-1 suites keep
the face arrays as restricted). With the DIRECT bottom, the coarsest
operator is assembled from identity probes (each one a K1, K5, K7a or K7b
apply on CUDA) and inverted densely: pseudo-inverted where it is singular
(periodic pure Poisson, whose null space is the constants).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from hpgmg_tpu_torch.core.config import BC, BottomSolver, Smoother, SolverConfig
from hpgmg_tpu_torch.core.level import Level


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    levels: List[Level]  # finest first


def level_dims(fine_dim: int, min_coarse_dim: int) -> List[int]:
    """The coarsening ladder: halve while even and above the floor."""
    dims = [fine_dim]
    while dims[-1] % 2 == 0 and dims[-1] // 2 >= min_coarse_dim:
        dims.append(dims[-1] // 2)
    return dims


def direct_bottom_inverse(op, bot: Level, cfg: SolverConfig) -> torch.Tensor:
    """Dense inverse of the bottom operator, assembled column by column
    from identity probes (apply of e_c forms column c). The periodic
    pure-Poisson operator is singular: it gets the pseudo-inverse, with
    the JAX package's cutoff (``jnp.linalg.pinv``: singular values at or
    below 10 * m * eps of the largest are dropped; torch's default is
    m * eps)."""
    m = bot.ncells
    if bot.dtype == torch.bfloat16:
        raise ValueError(
            "the DIRECT bottom cannot be built in bfloat16: torch.linalg has no "
            "bfloat16 inverse, and the JAX package's build_hierarchy fails alike "
            "(its LAPACK inverse raises 'Unsupported dtype bfloat16'); pick an "
            "iterative bottom solver (the JAX CLI's default is bicgstab)")
    if m > 16 ** 3:
        raise ValueError(
            f"DIRECT bottom solver wants a tiny coarsest grid, got {bot.dim}^3;"
            " raise min_coarse_dim or pick an iterative bottom solver")
    eye = torch.eye(m, dtype=bot.dtype, device=bot.device).reshape(m, *bot.shape)
    cols = torch.empty((m, m), dtype=bot.dtype, device=bot.device)
    for c in range(m):
        cols[c] = op.apply_op(bot, eye[c], cfg).reshape(m)
    if cfg.bc == BC.PERIODIC and not cfg.helmholtz:
        ainv = torch.linalg.pinv(cols.t(), rtol=10.0 * m * torch.finfo(bot.dtype).eps)
    else:
        ainv = torch.linalg.inv(cols.t())
    # row-major, as K4c reads it (CUDA's linalg may return column-major)
    return ainv.contiguous()


def build_hierarchy(beta_i: torch.Tensor, beta_j: torch.Tensor,
                    beta_k: torch.Tensor, cfg: SolverConfig,
                    alpha: Optional[torch.Tensor] = None,
                    h: Optional[float] = None) -> Hierarchy:
    """Build all levels from fine-level face coefficients (beta_i:
    (n+1, n, n)) on their device; ``alpha`` is cell-centered (ones when
    ``cfg.helmholtz`` and none is given). ``h`` defaults to 1/n."""
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.ops.transfer import (restrict_cell, restrict_face_i,
                                              restrict_face_j, restrict_face_k)

    op = get_suite(cfg.op)
    n = beta_i.shape[1]
    if tuple(beta_i.shape) != (n + 1, n, n):
        raise ValueError(f"beta_i has shape {tuple(beta_i.shape)}")
    if beta_i.dtype != cfg.dtype:
        raise TypeError(f"coefficients are {beta_i.dtype}, cfg wants {cfg.dtype}")
    if h is None:
        h = 1.0 / n
    if cfg.helmholtz and alpha is None:
        alpha = torch.ones((n, n, n), dtype=cfg.dtype, device=beta_i.device)

    levels: List[Level] = []
    for depth, dim in enumerate(level_dims(n, cfg.min_coarse_dim)):
        if depth > 0:
            beta_i = restrict_face_i(beta_i)
            beta_j = restrict_face_j(beta_j)
            beta_k = restrict_face_k(beta_k)
            if alpha is not None:
                alpha = restrict_cell(alpha)
        lv = Level(dim=dim, h=h * (2 ** depth), depth=depth, beta_i=beta_i,
                   beta_j=beta_j, beta_k=beta_k, alpha=alpha)
        levels.append(op.rebuild_operator(lv, cfg))

    if cfg.bottom == BottomSolver.DIRECT:
        levels[-1] = dataclasses.replace(
            levels[-1], bottom_ainv=direct_bottom_inverse(op, levels[-1], cfg))
    return Hierarchy(levels=levels)


def slim_hierarchy(hier: Hierarchy, cfg: SolverConfig) -> Hierarchy:
    """Drop per-level fields the configured solve never reads (at 512^3
    each n^3 f32 field is 512 MB): ``l1inv`` unless the smoother is
    L1-Jacobi, and with GSRB the plain ``dinv`` on every level above the
    bottom (GSRB reads the parity-folded ``kdinv``; the Krylov bottom
    solvers precondition with the bottom level's ``dinv``), and with GSRB
    the ``kdinv`` pair of a level carrying the BF16C views (its half-sweeps
    read their bf16 copies; hpgmg_tpu/core/hierarchy.py:190-199)."""
    last = len(hier.levels) - 1
    new_levels = []
    for i, lv in enumerate(hier.levels):
        kw = {}
        if cfg.smoother != Smoother.L1JACOBI:
            kw["l1inv"] = None
        if cfg.smoother == Smoother.GSRB and i < last:
            kw["dinv"] = None
            if lv.kb16 is not None:
                # BF16C: the half-sweeps read the bf16 kdinv copies; the
                # float32 pair is dead (1 GB at 512^3)
                kw["kdinv"] = None
        new_levels.append(dataclasses.replace(lv, **kw))
    return Hierarchy(levels=new_levels)
