"""Smoothers (counterpart of hpgmg_tpu/solve/smoothers.py). Only GSRB is
ported; the others raise NotImplementedError.

GSRB is the GSRB_FP masked-update formulation (gsrb.c:78-87): each
half-sweep computes x + mask * dinv * (rhs - A x) over the whole level into
a new tensor, so every cell reads the old iterate, as the reference's
ping-pong through VECTOR_TEMP does.
"""

from __future__ import annotations

from hpgmg_tpu_torch.core.config import Smoother, SolverConfig
from hpgmg_tpu_torch.core.level import Level


def smooth(op, level: Level, x, rhs, cfg: SolverConfig):
    if cfg.smoother == Smoother.GSRB:
        return gsrb(op, level, x, rhs, cfg)
    raise NotImplementedError(f"smoother {cfg.smoother} is not ported yet")


def gsrb(op, level: Level, x, rhs, cfg: SolverConfig):
    """2*num_smooths red/black half-sweeps (gsrb.c:24-132). Sweep s
    updates the cells with (i+j+k) % 2 == s % 2, starting with parity 0;
    the suite may fuse pairs of them (fv4: K2)."""
    return op.gsrb_smooth(level, x, rhs, cfg, 2 * cfg.resolved_num_smooths(op))
