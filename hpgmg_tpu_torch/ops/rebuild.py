"""Operator-agnostic ("black box") rebuild of Dinv / L1inv / lambda_max
(counterpart of hpgmg_tpu/ops/rebuild.py; reference rebuild.c:47-209).

The operator, boundary conditions included, is probed with colors^3
coloring vectors: the diagonal is the probe's response at its own
support, the Gershgorin row sum the response elsewhere. colors must exceed
the coupling distance (4 for the fv4 stencil with quartic BCs).
"""

from __future__ import annotations

import dataclasses

import torch

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level


def color_vector(n: int, colors: int, ic: int, jc: int, kc: int,
                 dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """1.0 where ((i+ic)%colors, (j+jc)%colors, (k+kc)%colors) == 0
    (misc.c:441-472); contiguous (n, n, n)."""
    idx = torch.arange(n, device=device)

    def axis_mask(c):
        return ((idx + c) % colors == 0).to(dtype)

    mi, mj, mk = axis_mask(ic), axis_mask(jc), axis_mask(kc)
    return (mi.view(n, 1, 1) * mj.view(1, n, 1) * mk.view(1, 1, n)).contiguous()


def rebuild_blackbox(op, level: Level, cfg: SolverConfig,
                     colors: int) -> Level:
    n = level.dim
    colors = min(colors, n)
    dtype, device = level.dtype, level.device
    aii = torch.zeros(level.shape, dtype=dtype, device=device)
    sum_abs = torch.zeros(level.shape, dtype=dtype, device=device)
    for c in range(colors ** 3):
        x = color_vector(n, colors, c % colors, (c // colors) % colors,
                         c // (colors * colors), dtype, device)
        ax = op.apply_op(level, x, cfg)
        aii = aii + x * ax
        sum_abs = sum_abs + torch.abs((1.0 - x) * ax)

    # failure guard (rebuild.c:164-167)
    fallback = cfg.a + cfg.b * level.h2inv
    aii = torch.where(aii == 0.0, torch.full_like(aii, fallback), aii)

    lam = torch.max((aii + sum_abs) / aii)
    l1inv = torch.where(aii >= 1.5 * sum_abs, 1.0 / aii,
                        1.0 / (aii + 0.5 * sum_abs))
    return dataclasses.replace(level, dinv=1.0 / aii, l1inv=l1inv,
                               lambda_max=lam)
