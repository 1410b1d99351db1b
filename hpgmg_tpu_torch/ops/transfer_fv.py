"""Higher-order interpolations: v2, v4 (volume-averaged) and p2
(cell-centered) (counterpart of hpgmg_tpu/ops/transfer_fv.py; reference
interpolation_v2.c / _v4.c / _p2.c).

Each first fills the coarse ghosts with its matching BC (v2 with
apply_BCs_v2, v4 with apply_BCs_v4, p2 with apply_BCs_p2), then applies a
separable 1D stencil per axis with mirror-symmetric child pairs:

* v2: 3-tap (1/8, 1, -1/8) (interpolation_v2.c:55-57)
* p2: 3-tap (5/32, 30/32, -3/32) (interpolation_p2.c:91-93)
* v4: 5-tap (-3/128, 22/128, 1, -22/128, 3/128) (interpolation_v4.c:47-56)
"""

from __future__ import annotations

import torch

from hpgmg_tpu_torch.core.config import BC
from hpgmg_tpu_torch.ops import transfer
from hpgmg_tpu_torch.ops.bc import _quadratic_fd_axis
from hpgmg_tpu_torch.ops.bc_fv import _extend_axis_v2, _extend_axis_v4
from hpgmg_tpu_torch.ops.transfer import coarse_extent, interp_matrix, interpolate


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int):
    out = torch.stack([even, odd], dim=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _interp_axis_3tap(x, axis: int, w_back: float, w_c: float, w_fwd: float):
    """even child of coarse cell I: w_back*c[I-1] + w_c*c[I] + w_fwd*c[I+1];
    odd child mirrored. ``x`` is ghost-padded by 1 on ``axis``."""
    n = x.shape[axis]
    lo, mid, hi = (x.narrow(axis, s, n - 2) for s in range(3))
    even = w_back * lo + w_c * mid + w_fwd * hi
    odd = w_fwd * lo + w_c * mid + w_back * hi
    return _interleave(even, odd, axis)


def _interp_axis_5tap(x, axis: int, w2: float, w1: float):
    """even child: w2*c[I-2] + w1*c[I-1] + c[I] - w1*c[I+1] - w2*c[I+2];
    odd child mirrored. ``x`` is ghost-padded by 2 on ``axis``."""
    n = x.shape[axis]
    v = [x.narrow(axis, s, n - 4) for s in range(5)]
    even = w2 * v[0] + w1 * v[1] + v[2] - w1 * v[3] - w2 * v[4]
    odd = -w2 * v[0] - w1 * v[1] + v[2] + w1 * v[3] + w2 * v[4]
    return _interleave(even, odd, axis)


def _sep_interp(xc, prescale_f, xf, bc, extend, radius, tap, coarse, fine):
    W = interp_matrix(coarse_extent(xc, coarse), xc.dtype, xc.device, bc, extend, radius,
                      tap)
    return interpolate(W, radius, xc, prescale_f, xf, bc, coarse, fine)


def interp_v2(xc: torch.Tensor, prescale_f: float, xf, bc: BC, coarse=None,
              fine=None) -> torch.Tensor:
    """Volume-averaged quadratic: fine = prescale_f * fine + P(coarse)."""
    def tap(x, axis):
        return _interp_axis_3tap(x, axis, 1.0 / 8.0, 1.0, -1.0 / 8.0)

    return _sep_interp(xc, prescale_f, xf, bc, _extend_axis_v2, 1, tap, coarse, fine)


def interp_p2(xc: torch.Tensor, prescale_f: float, xf, bc: BC, coarse=None,
              fine=None) -> torch.Tensor:
    """Cell-centered piecewise-quadratic: fine = prescale_f * fine +
    P(coarse)."""
    def tap(x, axis):
        return _interp_axis_3tap(x, axis, 5.0 / 32.0, 30.0 / 32.0, -3.0 / 32.0)

    return _sep_interp(xc, prescale_f, xf, bc, _quadratic_fd_axis, 1, tap, coarse, fine)


def interp_v4(xc: torch.Tensor, prescale_f: float, xf, bc: BC, coarse=None,
              fine=None) -> torch.Tensor:
    """Volume-averaged quartic: fine = prescale_f * fine + P(coarse)."""
    def tap(x, axis):
        return _interp_axis_5tap(x, axis, -3.0 / 128.0, 22.0 / 128.0)

    return _sep_interp(xc, prescale_f, xf, bc, _extend_axis_v4, 2, tap, coarse, fine)


transfer._INTERP.setdefault("v2", interp_v2)
transfer._INTERP.setdefault("p2", interp_p2)
transfer._INTERP.setdefault("v4", interp_v4)
