"""Pointwise manufactured problem with a quartic analytic solution
(counterpart of hpgmg_tpu/problems/p4.py; reference
operators/problem.p4.c): u(x,y,z) = X(x) Y(y) Z(z) with
X(w) = w^4 - 2w^3 + w^2 (-1/30 for periodic), beta as problem.p6, and
f = a*alpha*u - b*(grad beta . grad u + beta*laplacian(u)) at cell centers
(problem.p4.c:112-114). The evaluation protocol is problems/p6.py's.
"""

from __future__ import annotations

from typing import Optional

import torch

from hpgmg_tpu_torch.problems.p6 import ProblemP6, _init_pointwise, _separable_u


def _poly_u4(w):
    """X(w), X'(w), X''(w) for the degree-4 polynomial (problem.p4.c:48-58)."""
    u = w**4 - 2.0 * w**3 + w**2
    du = 4.0 * w**3 - 6.0 * w**2 + 2.0 * w
    ddu = 12.0 * w**2 - 12.0 * w + 2.0
    return u, du, ddu


def evaluate_u(x, y, z, periodic: bool):
    """u and its first/second partials (problem.p4.c:39-66)."""
    return _separable_u(_poly_u4, -1.0 / 30.0 if periodic else 0.0, x, y, z)


def init_problem_p4(n: int, dtype: torch.dtype, device: torch.device,
                    periodic: bool = False, a: float = 1.0, b: float = 1.0,
                    helmholtz: bool = False,
                    h: Optional[float] = None) -> ProblemP6:
    """Coefficients, rhs and analytic solution at n^3 cells
    (initialize_problem, problem.p4.c:69-135)."""
    return _init_pointwise(lambda x, y, z: evaluate_u(x, y, z, periodic), n,
                           dtype, device, a, b, helmholtz,
                           1.0 / n if h is None else h)
