"""Pointwise manufactured problem with an analytic solution (counterpart
of hpgmg_tpu/problems/p6.py; reference operators/problem.p6.c), the
default problem of the fv7pt and 27pt suites:

* u(x,y,z) = X(x) Y(y) Z(z) with X(w) = 2w^6 - 6w^5 + 5w^4 - w^2 (+1/21
  for periodic so integrals vanish), continuous through u'''' so both
  Dirichlet and periodic BCs hold exactly (problem.p6.c:39-75);
* beta(x,y,z) = c1 + c2*tanh(c3*(r - 0.25)), a sharp spherical transition
  from 1 to 10 about the domain center (problem.p6.c:6-35);
* f = a*alpha*u - b*(grad beta . grad u + beta*laplacian(u)) at cell
  centers (problem.p6.c:119-121).

``_init_pointwise`` is shared with problems/p4.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hpgmg_tpu_torch.kernels.stencils import compute_dtype


def _poly_u(w):
    """X(w), X'(w), X''(w) for the degree-6 polynomial (problem.p6.c:58-67)."""
    u = 2.0 * w**6 - 6.0 * w**5 + 5.0 * w**4 - w**2
    du = 12.0 * w**5 - 30.0 * w**4 + 20.0 * w**3 - 2.0 * w
    ddu = 60.0 * w**4 - 120.0 * w**3 + 60.0 * w**2 - 2.0
    return u, du, ddu


def _separable_u(poly, shift, x, y, z):
    """u = X Y Z and its first and second partials from the 1D polynomial."""
    X, Xx, Xxx = poly(x)
    Y, Yy, Yyy = poly(y)
    Z, Zz, Zzz = poly(z)
    X, Y, Z = X + shift, Y + shift, Z + shift
    return (X * Y * Z, Xx * Y * Z, X * Yy * Z, X * Y * Zz,
            Xxx * Y * Z, X * Yyy * Z, X * Y * Zzz)


def evaluate_u(x, y, z, periodic: bool):
    """u and its first/second partials (problem.p6.c:39-75)."""
    return _separable_u(_poly_u, 1.0 / 21.0 if periodic else 0.0, x, y, z)


def evaluate_beta(x, y, z):
    """beta and its gradient (problem.p6.c:6-35)."""
    bmin, bmax, c3 = 1.0, 10.0, 10.0
    c2 = (bmax - bmin) / 2.0
    c1 = (bmax + bmin) / 2.0
    dx, dy, dz = x - 0.5, y - 0.5, z - 0.5
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    t = torch.tanh(c3 * (r - 0.25))
    b = c1 + c2 * t
    # d/dx tanh(c3 (r - 1/4)) = c3 (1 - t^2) * x/r
    sech2 = 1.0 - t * t
    inv_r = torch.where(r > 0, 1.0 / torch.clamp(r, min=1e-300),
                        torch.zeros_like(r))
    bx = c2 * c3 * dx * inv_r * sech2
    by = c2 * c3 * dy * inv_r * sech2
    bz = c2 * c3 * dz * inv_r * sech2
    return b, bx, by, bz


class ProblemP6(NamedTuple):
    beta_i: torch.Tensor  # (n+1, n, n)
    beta_j: torch.Tensor  # (n, n+1, n)
    beta_k: torch.Tensor  # (n, n, n+1)
    alpha: torch.Tensor  # (n, n, n) ones
    f: torch.Tensor  # (n, n, n) rhs
    u_true: torch.Tensor  # (n, n, n) analytic solution at cell centers


def init_problem_p6(n: int, dtype: torch.dtype, device: torch.device,
                    periodic: bool = False, a: float = 1.0, b: float = 1.0,
                    helmholtz: bool = False,
                    h: Optional[float] = None) -> ProblemP6:
    """Coefficients, rhs and analytic solution at n^3 cells, computed in
    ``dtype`` on ``device`` (initialize_problem, problem.p6.c:79-135: beta_i
    at the i-faces (x - h/2, y, z), and so on)."""
    return _init_pointwise(lambda x, y, z: evaluate_u(x, y, z, periodic), n,
                           dtype, device, a, b, helmholtz,
                           1.0 / n if h is None else h)


def _coords(n: int, h: float, dtype, device):
    """Cell-center rows (x, y, z) and face rows (xf, yf, zf), each shaped
    to broadcast along its axis."""
    def row(count, axis, shift):
        c = (torch.arange(count, dtype=dtype, device=device) + 0.5) * h - shift
        shape = [1, 1, 1]
        shape[axis] = count
        return c.reshape(shape)

    centers = tuple(row(n, a, 0.0) for a in range(3))
    faces = tuple(row(n + 1, a, 0.5 * h) for a in range(3))  # h*i
    return centers, faces


def _init_pointwise(eval_u, n, dtype, device, a, b, helmholtz,
                    h) -> ProblemP6:
    """The shared pointwise initializer: ``eval_u(x, y, z)`` supplies the
    manufactured solution; beta and the face/cell evaluation protocol are
    those of problem.p6.c and problem.p4.c. Every field is contiguous. A
    bfloat16 problem is computed in float32 and each field rounded once."""
    (xc, yc, zc), (xf, yf, zf) = _coords(n, h, compute_dtype(dtype), device)

    def full(t, shape):
        return t.expand(shape).to(dtype).contiguous()

    beta_i = full(evaluate_beta(xf, yc, zc)[0], (n + 1, n, n))
    beta_j = full(evaluate_beta(xc, yf, zc)[0], (n, n + 1, n))
    beta_k = full(evaluate_beta(xc, yc, zf)[0], (n, n, n + 1))
    bcc, bx, by, bz = evaluate_beta(xc, yc, zc)
    u, ux, uy, uz, uxx, uyy, uzz = eval_u(xc, yc, zc)
    alpha = torch.ones((n, n, n), dtype=dtype, device=device)
    f = -b * ((bx * ux + by * uy + bz * uz) + bcc * (uxx + uyy + uzz))
    if helmholtz:
        f = a * alpha * u + f
    return ProblemP6(beta_i=beta_i, beta_j=beta_j, beta_k=beta_k, alpha=alpha,
                     f=full(f, (n, n, n)), u_true=full(u, (n, n, n)))
