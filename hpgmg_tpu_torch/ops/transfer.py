"""Inter-level transfers (counterpart of hpgmg_tpu/ops/transfer.py;
reference operators/restriction.c and interpolation_*.c).

Restriction of cell fields goes through K3 (``kernels/restrict.py``) on
CUDA tensors. Every interpolation, with its boundary ghost synthesis
folded in, is a separable linear operator applied as three dense per-axis
matrix products (``sep_apply``); the matrices come from applying the same
1D extender and child taps to an identity, so the operator is the
reference's stencil (+BC) by construction. The same matrix serves all
three axes (levels are cubes), and on a decomposed level each rank
applies its rows of it (``interpolate``).

Float32 matrix products must not drop to TF32, which keeps ~3 decimal
digits: the transfers feed the residual ladder (the JAX package runs them
at Precision.HIGHEST). The two flags below are set explicitly for that.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from hpgmg_tpu_torch.core.config import BC
from hpgmg_tpu_torch.kernels.restrict import restrict_cell  # noqa: F401
from hpgmg_tpu_torch.ops.bc import _reflect_odd_axis, _wrap_axis

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def sep_apply(Wi: torch.Tensor, Wj: torch.Tensor, Wk: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Apply the separable operator Wi (x) Wj (x) Wk to a 3D field as three
    matrix products; the result is contiguous. A bfloat16 field's products
    run in float32 on the widened matrices, each axis's result rounded to
    bf16 as a bf16 product rounds its output: a product of two bf16 values
    is exact in float32 and a row's few terms sum to the same value in any
    order, so the bits do not depend on the product's shape. (The card's
    bf16 products may reduce in bf16 at some shapes, and a rank's rows of
    W, ``interpolate``, then round otherwise than the whole level's.)"""
    a, b, c = Wi.shape[0], Wj.shape[0], Wk.shape[0]
    mi, mj, mk = x.shape
    dt = x.dtype
    if dt == torch.bfloat16:
        Wi, Wj, Wk, x = Wi.float(), Wj.float(), Wk.float(), x.float()

    def rounded(t):
        return t.to(dt).float() if dt == torch.bfloat16 else t

    x = rounded((Wi @ x.reshape(mi, mj * mk)).reshape(a, mj, mk))  # ai,ijk->ajk
    x = rounded(torch.matmul(Wj, x))  # bj,ajk->abk
    return torch.matmul(x, Wk.t()).reshape(a, b, c).to(dt)  # ck,abk->abc


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
    radius)`` synthesizes the Dirichlet ghosts (``_wrap_axis`` takes its
    place under periodic BCs); ``tap`` applies the child stencil along
    axis 0."""
    eye = torch.eye(m, dtype=dtype, device=device)
    ext = _wrap_axis if bc == BC.PERIODIC else extend
    return tap(ext(eye, 0, radius), 0)


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


def _window(W: torch.Tensor, oc: int, mc: int, radius: int,
            periodic: bool) -> torch.Tensor:
    """The rows of the (2m, m) matrix ``W`` for the fine cells of the coarse
    block [oc, oc+mc), as columns over that block extended by ``radius``
    ghosts: global coarse index oc - radius + w at column w, wrapped
    under periodic BCs; a Dirichlet ghost column is zero (the boundary is
    folded into W's interior columns)."""
    m = W.shape[1]
    rows = W[2 * oc:2 * (oc + mc)]
    g = torch.arange(oc - radius, oc + mc + radius, device=W.device)
    if periodic:
        if mc + 2 * radius > m:
            raise ValueError(f"a {mc}-cell block with {radius} ghosts wraps onto "
                             f"itself on an axis of {m}")
        return rows[:, g % m]
    out = torch.zeros((rows.shape[0], g.numel()), dtype=W.dtype, device=W.device)
    valid = (g >= 0) & (g < m)
    out[:, valid] = rows[:, g[valid]]
    return out


def coarse_extent(xc: torch.Tensor, coarse=None) -> int:
    """The global extent of the coarse level whose field (or this rank's
    block of it, ``coarse`` a Part) is ``xc``: the size of W's columns."""
    return xc.shape[2] if coarse is None else coarse.dim


def interpolate(W: torch.Tensor, radius: int, xc: torch.Tensor, prescale_f: float,
                xf, bc: BC, coarse=None, fine=None) -> torch.Tensor:
    """fine = prescale_f * fine + P(coarse), P = W (x) W (x) W, the
    separable operator of the (2m, m) one-axis matrix ``W`` (boundary
    ghosts folded in) whose stencil reaches ``radius`` coarse cells.

    On a decomposed fine level (``fine``, a parallel/mesh.Part) each rank
    applies the rows of W for its fine cells: from a replicated coarse
    level (``coarse`` None) to the whole coarse field it holds; from a
    coarse level split the same way to its block extended by ``radius``
    ghosts from the neighbours along each split axis (i, then j, then k,
    so the edges and corners arrive), the columns remapped to that window
    (``_window``); from a coarse level split otherwise, to the gathered
    coarse field."""
    if fine is None:
        if coarse is not None:
            raise ValueError("a decomposed coarse level under a replicated fine one")
        up = sep_apply(W, W, W, xc)
    else:
        from hpgmg_tpu_torch.parallel.halo import _exchange_axis
        from hpgmg_tpu_torch.parallel.mesh import gather

        if coarse is not None and coarse.split != fine.split:
            xc, coarse = gather(xc, coarse), None
        mats = []
        for axis in range(3):
            if coarse is None or not coarse.axes[axis]:
                o = fine.offsets[axis]
                mats.append(W if coarse is not None
                            else W[o:o + fine.extents[axis]])
                continue
            periodic = bc == BC.PERIODIC
            xc = _exchange_axis(xc, coarse, axis, radius, periodic)
            mats.append(_window(W, coarse.offsets[axis], coarse.extents[axis], radius,
                                periodic))
        up = sep_apply(*mats, xc)
    return prescale_f * xf + up if prescale_f != 0.0 else up


def interp_p0(xc: torch.Tensor, prescale_f: float, xf, bc: BC, coarse=None,
              fine=None) -> torch.Tensor:
    """Piecewise-constant injection: every fine cell copies its coarse
    parent (interpolation_p0.c)."""
    W = torch.repeat_interleave(torch.eye(coarse_extent(xc, coarse), dtype=xc.dtype,
                                          device=xc.device), 2, dim=0)
    return interpolate(W, 0, xc, prescale_f, xf, bc, coarse, fine)


def interp_p1(xc: torch.Tensor, prescale_f: float, xf, bc: BC, coarse=None,
              fine=None) -> torch.Tensor:
    """Trilinear interpolation (interpolation_p1.c:42-62): the weights
    {27, 9, 3, 1}/64 are the tensor product of the 1D pair (3/4, 1/4),
    even children looking backward and odd ones forward, with the
    apply_BCs_p1 odd reflection at the boundary (interpolation_p1.c:71-72)."""
    def tap(x, axis):
        return _interp_axis_2tap(x, axis, 0.75, 0.25)

    W = interp_matrix(coarse_extent(xc, coarse), xc.dtype, xc.device, bc,
                      _reflect_odd_axis, 1, tap)
    return interpolate(W, 1, xc, prescale_f, xf, bc, coarse, fine)


_INTERP: Dict[str, Callable] = {"p0": interp_p0, "p1": interp_p1}


def get_interpolation(name: str) -> Callable:
    from hpgmg_tpu_torch.ops import transfer_fv  # noqa: F401 registers v2/v4/p2

    if name not in _INTERP:
        raise ValueError(f"unknown interpolation {name!r}; have {sorted(_INTERP)}")
    return _INTERP[name]
