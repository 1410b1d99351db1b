"""Volume-averaged ghost fills (counterpart of hpgmg_tpu/ops/bc_fv.py;
reference operators/boundary_fv.c).

Each BC is a separable per-axis extension: pass 1 extends i from the
interior, pass 2 extends j reading the i-extended field (the reference's
16-point edge stencils), pass 3 extends k (its 64-point corners). The 1D
ghost stencils on the first interior cells x1..x4:

* v1 (1 ghost): g1 = -x1
* v2 (1 ghost): g1 = -5/2 x1 + 1/2 x2; deeper ghosts zeroed
* v4 (2 ghosts): g1 = (-77 x1 + 43 x2 - 17 x3 + 3 x4)/12,
  g2 = (-505 x1 + 335 x2 - 145 x3 + 27 x4)/12; v2 below 4 cells

Periodic BCs wrap every axis instead, whatever the order.

Also the tangential extension of the face coefficients that the fv4
mixed-derivative terms read: extrapolated (extrapolate_betas,
boundary_fv.c:573-681), or wrapped under periodic BCs.
"""

from __future__ import annotations

import torch

from hpgmg_tpu_torch.core.config import BC
from hpgmg_tpu_torch.ops.bc import _wrap_axis, ghost_fill_periodic


def _take(x: torch.Tensor, axis: int, idx: int) -> torch.Tensor:
    return x.narrow(axis, idx, 1)


def _extend_axis_v1(x, axis, radius):
    n = x.shape[axis]
    g1_lo = -_take(x, axis, 0)
    g1_hi = -_take(x, axis, n - 1)
    zero = torch.zeros_like(g1_lo)
    lo = [zero] * (radius - 1) + [g1_lo]
    hi = [g1_hi] + [zero] * (radius - 1)
    return torch.cat(lo + [x] + hi, dim=axis)


def _extend_axis_v2(x, axis, radius):
    n = x.shape[axis]
    if n < 2:
        return _extend_axis_v1(x, axis, radius)
    g1_lo = -2.5 * _take(x, axis, 0) + 0.5 * _take(x, axis, 1)
    g1_hi = -2.5 * _take(x, axis, n - 1) + 0.5 * _take(x, axis, n - 2)
    zero = torch.zeros_like(g1_lo)
    lo = [zero] * (radius - 1) + [g1_lo]
    hi = [g1_hi] + [zero] * (radius - 1)
    return torch.cat(lo + [x] + hi, dim=axis)


def _extend_axis_v4(x, axis, radius):
    n = x.shape[axis]
    if n < 4:
        return _extend_axis_v2(x, axis, radius)
    if radius < 2:
        raise ValueError("v4 BCs need two ghost layers (boundary_fv.c:267)")
    c = 1.0 / 12.0

    def stencil(i0, i1, i2, i3):
        x1, x2 = _take(x, axis, i0), _take(x, axis, i1)
        x3, x4 = _take(x, axis, i2), _take(x, axis, i3)
        g_near = c * (-77.0 * x1 + 43.0 * x2 - 17.0 * x3 + 3.0 * x4)
        g_far = c * (-505.0 * x1 + 335.0 * x2 - 145.0 * x3 + 27.0 * x4)
        return g_near, g_far

    n1_lo, f1_lo = stencil(0, 1, 2, 3)
    n1_hi, f1_hi = stencil(n - 1, n - 2, n - 3, n - 4)
    zero = torch.zeros_like(n1_lo)
    lo = [zero] * (radius - 2) + [f1_lo, n1_lo]
    hi = [n1_hi, f1_hi] + [zero] * (radius - 2)
    return torch.cat(lo + [x] + hi, dim=axis)


_EXTENDERS = {1: _extend_axis_v1, 2: _extend_axis_v2, 4: _extend_axis_v4}


def ghost_fill_fv(x: torch.Tensor, bc: BC, order: int,
                  radius: int) -> torch.Tensor:
    """Fill ``radius`` ghost layers with the order-``order``
    volume-averaged Dirichlet extrapolation, or the periodic wrap."""
    if bc == BC.PERIODIC:
        return ghost_fill_periodic(x, radius)
    ext = _EXTENDERS[order]
    for axis in range(3):
        x = ext(x, axis, radius)
    return x


def _extrapolate_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Extend one tangential axis by a single ghost layer with the highest
    extrapolation order the extent supports: quintic (5,-10,10,-5,1;
    boundary_fv.c:651), cubic (4,-6,4,-1; :662) or linear (2,-1; :673)."""
    n = x.shape[axis]

    def tap(idxs, coeffs):
        lo = sum(c * _take(x, axis, i) for i, c in zip(idxs, coeffs))
        hi = sum(c * _take(x, axis, n - 1 - i) for i, c in zip(idxs, coeffs))
        return lo, hi

    if n >= 5:
        lo, hi = tap(range(5), (5.0, -10.0, 10.0, -5.0, 1.0))
    elif n >= 4:
        lo, hi = tap(range(4), (4.0, -6.0, 4.0, -1.0))
    else:
        lo, hi = tap(range(2), (2.0, -1.0))
    return torch.cat([lo, x, hi], dim=axis)


def extend_beta_tangential(beta: torch.Tensor, face_axis: int,
                           bc: BC) -> torch.Tensor:
    """Extend a face-centered coefficient array by one ghost layer along
    its two tangential axes (the fv4 mixed-derivative terms read beta at
    j+-1 / k+-1, outside the domain for boundary cells): extrapolated, or
    wrapped under periodic BCs."""
    for axis in range(3):
        if axis != face_axis:
            beta = (_wrap_axis(beta, axis, 1) if bc == BC.PERIODIC
                    else _extrapolate_axis(beta, axis))
    return beta
