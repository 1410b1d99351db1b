"""Inter-level transfers (counterpart of hpgmg_tpu/ops/transfer.py;
reference operators/restriction.c and interpolation_*.c).

Restriction of cell fields goes through K3 (``kernels/restrict.py``) on
CUDA tensors. Every interpolation, with its boundary ghost synthesis
folded in, is a separable linear operator applied as three dense per-axis
matrix products (``sep_apply``); the matrices come from applying the same
1D extender and child taps to an identity, so the operator is the
reference's stencil (+BC) by construction.

Float32 matrix products must not drop to TF32, which keeps ~3 decimal
digits: the transfers feed the residual ladder (the JAX package runs them
at Precision.HIGHEST). The two flags below are set explicitly for that.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from hpgmg_tpu_torch.core.config import BC
from hpgmg_tpu_torch.kernels.restrict import restrict_cell  # noqa: F401
from hpgmg_tpu_torch.ops.bc import _reflect_odd_axis

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def sep_apply(Wi: torch.Tensor, Wj: torch.Tensor, Wk: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Apply the separable operator Wi (x) Wj (x) Wk to a 3D field as three
    matrix products; the result is contiguous."""
    a, b, c = Wi.shape[0], Wj.shape[0], Wk.shape[0]
    mi, mj, mk = x.shape
    x = (Wi @ x.reshape(mi, mj * mk)).reshape(a, mj, mk)  # ai,ijk->ajk
    x = torch.matmul(Wj, x)  # bj,ajk->abk
    return torch.matmul(x, Wk.t()).reshape(a, b, c)  # ck,abk->abc


# ---------------------------------------------------------------------------
# face restriction (restriction.c:6-94, the beta ladder)
# ---------------------------------------------------------------------------

def _restrict_face(bf: torch.Tensor, axis: int) -> torch.Tensor:
    """Face-centered 4->1 average: coarse face (I,J,K) averages the four
    fine faces on the same plane (even index along ``axis``)."""
    b = torch.movedim(bf, axis, 0)
    nfaces = b.shape[0]  # 2m+1 fine faces -> m+1 coarse
    m1, m2 = b.shape[1] // 2, b.shape[2] // 2
    b = b[::2].reshape(nfaces // 2 + 1, m1, 2, m2, 2).mean(dim=(2, 4))
    return torch.movedim(b, 0, axis).contiguous()


def restrict_face_i(bf):
    return _restrict_face(bf, 0)


def restrict_face_j(bf):
    return _restrict_face(bf, 1)


def restrict_face_k(bf):
    return _restrict_face(bf, 2)


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def interp_matrix(m: int, dtype: torch.dtype, device: torch.device, bc: BC,
                  extend, radius: int, tap) -> torch.Tensor:
    """(2m, m) one-axis interpolation matrix: the columns are the responses
    of extend-then-tap to the coarse basis vectors. ``extend(x, axis,
    radius)`` synthesizes the BC ghosts; ``tap`` applies the child stencil
    along axis 0."""
    if bc == BC.PERIODIC:
        raise NotImplementedError("periodic BCs are not ported yet")
    eye = torch.eye(m, dtype=dtype, device=device)
    return tap(extend(eye, 0, radius), 0)


def _interp_axis_2tap(x: torch.Tensor, axis: int, w_c: float,
                      w_n: float) -> torch.Tensor:
    """Separable 1D upsample: even child = w_c*c[I] + w_n*c[I-1], odd
    child = w_c*c[I] + w_n*c[I+1]. ``x`` is ghost-padded by 1 on ``axis``."""
    n = x.shape[axis]
    lo, mid, hi = (x.narrow(axis, s, n - 2) for s in range(3))
    even = w_c * mid + w_n * lo
    odd = w_c * mid + w_n * hi
    out = torch.stack([even, odd], dim=axis + 1)
    shape = list(mid.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def interp_p0(xc: torch.Tensor, prescale_f: float, xf, bc: BC) -> torch.Tensor:
    """Piecewise-constant injection: every fine cell copies its coarse
    parent (interpolation_p0.c)."""
    Ws = [torch.repeat_interleave(torch.eye(xc.shape[a], dtype=xc.dtype,
                                            device=xc.device), 2, dim=0)
          for a in range(3)]
    up = sep_apply(*Ws, xc)
    return prescale_f * xf + up if prescale_f != 0.0 else up


def interp_p1(xc: torch.Tensor, prescale_f: float, xf, bc: BC) -> torch.Tensor:
    """Trilinear interpolation (interpolation_p1.c:42-62): the weights
    {27, 9, 3, 1}/64 are the tensor product of the 1D pair (3/4, 1/4),
    even children looking backward and odd ones forward, with the
    apply_BCs_p1 odd reflection at the boundary (interpolation_p1.c:71-72)."""
    def tap(x, axis):
        return _interp_axis_2tap(x, axis, 0.75, 0.25)

    Ws = [interp_matrix(xc.shape[a], xc.dtype, xc.device, bc, _reflect_odd_axis,
                        1, tap) for a in range(3)]
    up = sep_apply(*Ws, xc)
    return prescale_f * xf + up if prescale_f != 0.0 else up


_INTERP: Dict[str, Callable] = {"p0": interp_p0, "p1": interp_p1}


def get_interpolation(name: str) -> Callable:
    from hpgmg_tpu_torch.ops import transfer_fv  # noqa: F401 registers v2/v4/p2

    if name not in _INTERP:
        raise ValueError(f"unknown interpolation {name!r}; have {sorted(_INTERP)}")
    return _INTERP[name]
