"""Smooth sine manufactured problem (counterpart of
hpgmg_tpu/problems/sine.py; reference operators/problem.sine.c): u is a
sum of sin^13 products at two frequencies (2 pi and 6 pi), beta the tanh
of problem.p6, pointwise cell-centered initialization with the analytic u.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from hpgmg_tpu_torch.problems.p6 import ProblemP6, _init_pointwise


def evaluate_u_sine(x, y, z):
    """u and derivatives: sum of sin^p products at c = 2 pi and 6 pi
    (problem.sine.c:42-70), p = 13."""
    p = 13.0
    u = ux = uy = uz = uxx = uyy = uzz = 0.0
    for c in (2.0 * math.pi, 6.0 * math.pi):
        sx, sy, sz = torch.sin(c * x), torch.sin(c * y), torch.sin(c * z)
        cx, cy, cz = torch.cos(c * x), torch.cos(c * y), torch.cos(c * z)
        u = u + sx**p * sy**p * sz**p
        ux = ux + c * p * cx * sx**(p - 1) * sy**p * sz**p
        uy = uy + c * p * cy * sy**(p - 1) * sx**p * sz**p
        uz = uz + c * p * cz * sz**(p - 1) * sx**p * sy**p
        uxx = uxx + c * c * p * ((p - 1) * sx**(p - 2) * cx * cx - sx**p) \
            * sy**p * sz**p
        uyy = uyy + c * c * p * ((p - 1) * sy**(p - 2) * cy * cy - sy**p) \
            * sx**p * sz**p
        uzz = uzz + c * c * p * ((p - 1) * sz**(p - 2) * cz * cz - sz**p) \
            * sx**p * sy**p
    return u, ux, uy, uz, uxx, uyy, uzz


def init_problem_sine(n: int, dtype: torch.dtype, device: torch.device,
                      a: float = 0.0, b: float = 1.0, helmholtz: bool = False,
                      h: Optional[float] = None) -> ProblemP6:
    """Coefficients, rhs and analytic solution at n^3 cells
    (problem.sine.c:74-115; the same anatomy as problem.p6)."""
    return _init_pointwise(evaluate_u_sine, n, dtype, device, a, b,
                           helmholtz, 1.0 / n if h is None else h)
