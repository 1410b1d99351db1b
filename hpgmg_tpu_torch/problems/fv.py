"""Cell-averaged benchmark problem (counterpart of hpgmg_tpu/problems/fv.py;
reference operators/problem.fv.c), used by the fv4 suite:

* beta = 1 + 0.25 sin(2 pi x) sin(2 pi y) sin(2 pi z) at face centers, with
  the (h^2/24) tangential second-derivative correction to face averages;
* F = sin^7(2 pi x) sin^7(2 pi y) sin^7(2 pi z) with the (h^2/24)
  Laplacian correction to cell averages.

No analytic solution ships with it: correctness comes from Richardson
analysis across resolutions (mg.c:1113).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


def _beta(x, y, z, h, ncorr):
    """Face-averaged beta (problem.fv.c:9-26) with ``ncorr`` tangential
    (h^2/24) d2B corrections."""
    b, a = 0.25, 2.0 * math.pi
    sx, sy, sz = torch.sin(a * x), torch.sin(a * y), torch.sin(a * z)
    B = 1.0 + b * sx * sy * sz
    # every pure second derivative of the product is -a^2 * (the product)
    d2 = -a * a * b * sx * sy * sz
    return B + (h * h / 24.0) * d2 * ncorr


def _forcing(x, y, z, h):
    """Cell-averaged F (problem.fv.c:72-87)."""
    a, p = 2.0 * math.pi, 7.0
    sx, sy, sz = torch.sin(a * x), torch.sin(a * y), torch.sin(a * z)
    cx, cy, cz = torch.cos(a * x), torch.cos(a * y), torch.cos(a * z)
    F = sx**p * sy**p * sz**p
    base = -a * a * p * F
    fxx = base + a * a * p * (p - 1.0) * sx**(p - 2.0) * sy**p * sz**p * cx * cx
    fyy = base + a * a * p * (p - 1.0) * sx**p * sy**(p - 2.0) * sz**p * cy * cy
    fzz = base + a * a * p * (p - 1.0) * sx**p * sy**p * sz**(p - 2.0) * cz * cz
    return F + (h * h / 24.0) * (fxx + fyy + fzz)


class ProblemFV(NamedTuple):
    beta_i: torch.Tensor  # (n+1, n, n)
    beta_j: torch.Tensor  # (n, n+1, n)
    beta_k: torch.Tensor  # (n, n, n+1)
    alpha: torch.Tensor  # (n, n, n) ones
    f: torch.Tensor  # (n, n, n)


def init_problem_fv(n: int, dtype: torch.dtype, device: torch.device,
                    h: Optional[float] = None) -> ProblemFV:
    """The problem at n^3 cells, computed in ``dtype`` on ``device``; every
    field is contiguous."""
    if h is None:
        h = 1.0 / n

    def centers(count, axis, offset=0.5):
        c = (torch.arange(count, dtype=dtype, device=device) + offset) * h
        shape = [1, 1, 1]
        shape[axis] = count
        return c.reshape(shape)

    xc, yc, zc = centers(n, 0), centers(n, 1), centers(n, 2)
    xf, yf, zf = (centers(n + 1, 0, 0.0), centers(n + 1, 1, 0.0),
                  centers(n + 1, 2, 0.0))

    def full(t, shape):
        return t.expand(shape).contiguous()

    return ProblemFV(
        beta_i=full(_beta(xf, yc, zc, h, 2), (n + 1, n, n)),
        beta_j=full(_beta(xc, yf, zc, h, 2), (n, n + 1, n)),
        beta_k=full(_beta(xc, yc, zf, h, 2), (n, n, n + 1)),
        alpha=torch.ones((n, n, n), dtype=dtype, device=device),
        f=full(_forcing(xc, yc, zc, h), (n, n, n)),
    )
