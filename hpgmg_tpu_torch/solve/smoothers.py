"""Smoothers (counterpart of hpgmg_tpu/solve/smoothers.py): GSRB,
Chebyshev, weighted Jacobi, L1-Jacobi and SymGS.

GSRB is the GSRB_FP masked-update formulation (gsrb.c:78-87): each
half-sweep computes x + mask * dinv * (rhs - A x) over the whole level into
a new tensor, so every cell reads the old iterate, as the reference's
ping-pong through VECTOR_TEMP does. The other smoothers take one residual
``rhs - A x`` per sweep from the suite (a K1, K1s, K5 or K7 launch on CUDA)
and update elementwise; none of them reads a value on the host.
"""

from __future__ import annotations

import torch

from hpgmg_tpu_torch.core.config import Smoother, SolverConfig
from hpgmg_tpu_torch.core.level import Level

# half-sweep parities of one SymGS smooth: forward (red, black), then
# backward (black, red) (operators.test/symgs.c)
SYMGS_PARITIES = (0, 1, 1, 0)


def smooth(op, level: Level, x, rhs, cfg: SolverConfig):
    kind = cfg.smoother
    if kind == Smoother.GSRB:
        return gsrb(op, level, x, rhs, cfg)
    if kind == Smoother.CHEBYSHEV:
        return chebyshev(op, level, x, rhs, cfg)
    if kind == Smoother.JACOBI:
        return jacobi(op, level, x, rhs, cfg)
    if kind == Smoother.L1JACOBI:
        return l1_jacobi(op, level, x, rhs, cfg)
    if kind == Smoother.SYMGS:
        return symgs(op, level, x, rhs, cfg)
    raise ValueError(f"unknown smoother {kind}")


def gsrb(op, level: Level, x, rhs, cfg: SolverConfig):
    """2*num_smooths red/black half-sweeps (gsrb.c:24-132). Sweep s
    updates the cells with (i+j+k) % 2 == s % 2, starting with parity 0;
    the suite may fuse pairs of them (fv4: K2; radius-1: K6)."""
    return op.gsrb_smooth(level, x, rhs, cfg, 2 * cfg.resolved_num_smooths(op))


def _need(level: Level, field: str, smoother: str):
    t = getattr(level, field)
    if t is None:
        raise ValueError(f"{smoother} reads level.{field}, which this level lacks "
                         "(slim_hierarchy drops it for other smoothers)")
    return t


def jacobi(op, level: Level, x, rhs, cfg: SolverConfig,
           weight: float = 2.0 / 3.0):
    """Weighted Jacobi, omega = 2/3 (jacobi.c:14)."""
    dinv = _need(level, "dinv", "Jacobi")
    for _ in range(cfg.resolved_num_smooths(op)):
        x = x + weight * dinv * op.residual(level, x, rhs, cfg)
    return x


def l1_jacobi(op, level: Level, x, rhs, cfg: SolverConfig):
    """L1-Jacobi: unweighted Jacobi with the L1 row-sum diagonal
    (operators.test/l1jacobi.c; weights from Baker et al. eq 6.5)."""
    l1inv = _need(level, "l1inv", "L1-Jacobi")
    for _ in range(cfg.resolved_num_smooths(op)):
        x = x + l1inv * op.residual(level, x, rhs, cfg)
    return x


def symgs(op, level: Level, x, rhs, cfg: SolverConfig):
    """Symmetric red-black GS: per smooth, four half-sweeps of parities
    (0, 1, 1, 0), each one ``op.gsrb_sweep`` (never the fused full sweeps
    of ``gsrb_smooth``: K2 and K6 pair red then black only)."""
    for _ in range(cfg.resolved_num_smooths(op)):
        for parity in SYMGS_PARITIES:
            x = op.gsrb_sweep(level, x, rhs, cfg, parity)
    return x


def chebyshev_coefficients(lambda_max: torch.Tensor, degree: int):
    """The (c1, c2) ladder of the degree-``degree`` Chebyshev smoother on
    the spectral interval [0.125 beta, beta], beta = lambda_max
    (chebyshev.c:22-60): two (degree,) tensors on lambda_max's device,
    computed there (no host sync)."""
    beta = 1.0 * lambda_max
    alpha = 0.125 * beta
    theta = 0.5 * (beta + alpha)
    delta = 0.5 * (beta - alpha)
    sigma = theta / delta
    rho = 1.0 / sigma
    c1 = [torch.zeros_like(rho)]  # c1[0] = 0: the first step has no history
    c2 = [1.0 / theta]
    for _ in range(1, degree):
        rho_prev = rho
        rho = 1.0 / (2.0 * sigma - rho_prev)
        c1.append(rho * rho_prev)
        c2.append(rho * 2.0 / delta)
    return torch.stack(c1), torch.stack(c2)


def chebyshev(op, level: Level, x, rhs, cfg: SolverConfig):
    """Degree-d Chebyshev polynomial smoother (chebyshev.c:8-100): the
    three-term recurrence x_{s+1} = x_s + c1 (x_s - x_{s-1})
    + c2 dinv (rhs - A x_s), d * num_smooths steps. lambda_max is a 0-d
    tensor and the ladder stays on its device."""
    degree = cfg.resolved_chebyshev_degree(op)
    num = cfg.resolved_num_smooths(op)
    if (degree * num) % 2:
        raise ValueError(f"CHEBYSHEV_DEGREE*NUM_SMOOTHS must be even, got "
                         f"{degree}*{num}")
    dinv = _need(level, "dinv", "Chebyshev")
    c1, c2 = chebyshev_coefficients(_need(level, "lambda_max", "Chebyshev"), degree)
    x_prev = x
    for s in range(degree * num):
        d = s % degree
        x_next = x + c1[d] * (x - x_prev) + c2[d] * dinv * op.residual(level, x, rhs, cfg)
        x_prev, x = x, x_next
    return x
