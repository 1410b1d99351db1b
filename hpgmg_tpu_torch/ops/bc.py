"""Cell-centered Dirichlet ghost fills (counterpart of hpgmg_tpu/ops/bc.py;
reference operators/boundary_fd.c), for the fv7pt and 27pt suites.

Each fill is a separable per-axis extension, i then j then k, every pass
reading the field the previous one extended, so the edge and corner ghosts
are the tensor product of the 1D stencils (the reference's fused
face/edge/corner tables):

* linear (apply_BCs_p1, boundary_fd.c:6-92): odd reflection,
  ghost_{-1-m} = -x_m, so faces get -1, edges +1, corners -1;
* quadratic (apply_BCs_p2, boundary_fd.c:130-143): g1 = -2 x1 + x2 / 3,
  deeper ghosts zeroed; the linear fill below 2 cells.

Homogeneous Dirichlet only: periodic BCs are not ported yet and raise.
"""

from __future__ import annotations

import torch

from hpgmg_tpu_torch.core.config import BC


def _check_bc(bc: BC):
    if bc == BC.PERIODIC:
        raise NotImplementedError("periodic BCs are not ported yet")


def _reflect_odd_axis(x: torch.Tensor, axis: int, radius: int) -> torch.Tensor:
    """Pad one axis with cell-centered odd reflection: ghost_{-1-m} = -x_m."""
    n = x.shape[axis]
    lo = -torch.flip(x.narrow(axis, 0, radius), dims=(axis,))
    hi = -torch.flip(x.narrow(axis, n - radius, radius), dims=(axis,))
    return torch.cat([lo, x, hi], dim=axis)


def _quadratic_fd_axis(x: torch.Tensor, axis: int, radius: int) -> torch.Tensor:
    """apply_BCs_p2 1D stencil: ghost = -2*x1 + (1/3)*x2; deeper ghosts
    zeroed."""
    n = x.shape[axis]
    g_lo = -2.0 * x.narrow(axis, 0, 1) + (1.0 / 3.0) * x.narrow(axis, 1, 1)
    g_hi = -2.0 * x.narrow(axis, n - 1, 1) + (1.0 / 3.0) * x.narrow(axis, n - 2, 1)
    zero = torch.zeros_like(g_lo)
    lo = [zero] * (radius - 1) + [g_lo]
    hi = [g_hi] + [zero] * (radius - 1)
    return torch.cat(lo + [x] + hi, dim=axis)


def ghost_fill_linear(x: torch.Tensor, bc: BC, radius: int = 1) -> torch.Tensor:
    """``radius`` ghost layers around a cell-centered field by odd
    reflection (exchange_boundary + apply_BCs_p1)."""
    _check_bc(bc)
    for axis in range(3):
        x = _reflect_odd_axis(x, axis, radius)
    return x


def ghost_fill_quadratic_fd(x: torch.Tensor, bc: BC,
                            radius: int = 1) -> torch.Tensor:
    """Cell-centered quadratic Dirichlet ghosts (apply_BCs_p2), applied
    i -> j -> k so that edge and corner ghosts are the tensor product of
    the 1D stencil (boundary_fd.c:144-199)."""
    _check_bc(bc)
    if min(x.shape) < 2:
        return ghost_fill_linear(x, bc, radius)
    for axis in range(3):
        x = _quadratic_fd_axis(x, axis, radius)
    return x
