"""FE grid: node fields, element gather/scatter, inter-grid transfers
(counterpart of hpgmg_tpu/fe/grid.py).

Rebuild of the reference Grid/DM layer (finite-element/grid.c). A level is
ONE global node array per field, shape (Nx, Ny, Nz) with N = degree*M + 1.
The JAX package expresses the element gather and scatter as 0/1-matrix
products because strided lane access is slow on the TPU; here they are
the strided views they stand for:

* extract_elements (DMFEExtractElements, grid.c:936): node array ->
  element tensor (P, P, P, Mx, My, Mz), a view: ``unfold`` with size P and
  step p on each axis, local (basis) indices leading and the element
  batch trailing, the layout the operator's contractions read.
* assemble_add (DMFESetElements ADD_VALUES, grid.c:969): the exact
  transpose of that view, aten's ``unfold_backward`` along each axis
  (each node sums the windows that hold it, the same order on every run).
* assemble_interior: what the operator needs of it, the interior nodes'
  sums with the boundary zeroed (``zero_boundaries(assemble_add(E))``):
  each node gathers its 8 element contributions through a cached index
  (missing ones point at a zeroed value) and sums them in a fixed order,
  two launches where unfold_backward takes six.
* inject (DMFEInject): every second fine node, ``u[::2, ::2, ::2]``.
* interpolate / restrict (DMFEInterpolate/Restrict, grid.c:567-731):
  per-axis (nf, nc) matrices built once per level pair from the 1D
  stencil and cached; restrict applies their transposes, so R = P^T holds
  by construction.

Float32 matrix products must not drop to TF32, which keeps ~3 decimal
digits (the JAX package runs them at Precision.HIGHEST): the flag is set
here for every module of ``fe/``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from hpgmg_tpu_torch.fe.reference import ReferenceElement
from hpgmg_tpu_torch.ops.transfer import sep_apply

torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class FEGrid:
    """Static description of one FE level (the Grid+DM analog)."""

    M: Tuple[int, int, int]  # elements per axis
    degree: int  # 1 (Q1) or 2 (Q2)
    L: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # domain lengths
    addquadpts: int = 0

    @property
    def ref(self) -> ReferenceElement:
        return ReferenceElement(self.degree, self.addquadpts)

    @property
    def nodes(self) -> Tuple[int, int, int]:
        return tuple(self.degree * m + 1 for m in self.M)

    @property
    def ndof(self) -> int:
        nx, ny, nz = self.nodes
        return nx * ny * nz

    @property
    def neq(self) -> int:
        """Number of equations = interior nodes (Dirichlet)."""
        return int(np.prod([n - 2 for n in self.nodes]))

    def can_coarsen(self) -> bool:
        return all(m % 2 == 0 for m in self.M)

    def coarsen(self) -> "FEGrid":
        assert self.can_coarsen(), self.M
        return dataclasses.replace(self, M=tuple(m // 2 for m in self.M))

    def num_levels(self) -> int:
        g, n = self, 1
        while g.can_coarsen():
            g, n = g.coarsen(), n + 1
        return n

    # ------------------------------------------------------------------
    # coordinates
    # ------------------------------------------------------------------

    def node_coords_1d(self, axis: int, dtype=torch.float64, device="cuda"):
        n = self.nodes[axis]
        return torch.linspace(0.0, self.L[axis], n, dtype=dtype, device=device)

    def node_coords(self, dtype=torch.float64, distort: float = 0.0,
                    device="cuda"):
        """(3, Nx, Ny, Nz) nodal coordinates; ``distort`` applies the
        reference's smooth "swirl" distortion (DMCoordDistort,
        fmg.c:396-419): rotate (x, y) about the domain axis by
        theta = A * cos^2(pi*r/2) * sin(pi*z) with r the clipped radial
        distance of the normalized (x, y) from the axis; z unchanged.
        The reference hard-codes A = 0.1 ("5% distortion"); here
        ``distort=0.05`` reproduces that (A = 2*distort), and other
        values scale the same swirl."""
        xs = [self.node_coords_1d(a, dtype, device) for a in range(3)]
        X = torch.stack(torch.meshgrid(*xs, indexing="ij"))
        if distort:
            pi = math.pi
            x = X[0] / self.L[0]
            y = X[1] / self.L[1]
            z = X[2] / self.L[2]
            r = torch.clamp(
                torch.sqrt((2 * x - 1) ** 2 + (2 * y - 1) ** 2), max=1.0)
            theta = (2.0 * distort) * torch.cos(pi * r / 2) ** 2 \
                * torch.sin(pi * z)
            c, s = torch.cos(theta), torch.sin(theta)
            newx = (0.5 + c * (x - 0.5) - s * (y - 0.5)) * self.L[0]
            newy = (0.5 + s * (x - 0.5) + c * (y - 0.5)) * self.L[1]
            X = torch.stack([newx, newy, X[2]])
        return X

    # ------------------------------------------------------------------
    # element gather / scatter
    # ------------------------------------------------------------------

    def extract_elements(self, u: torch.Tensor) -> torch.Tensor:
        """(Nx,Ny,Nz) -> (P,P,P, Mx,My,Mz): element-local node values, a
        strided view of ``u`` (element (e0,e1,e2)'s local node (i,j,k) is
        node (p*e0+i, p*e1+j, p*e2+k))."""
        P, p = self.degree + 1, self.degree
        return u.unfold(0, P, p).unfold(1, P, p).unfold(2, P, p).permute(
            3, 4, 5, 0, 1, 2)

    def assemble_add(self, E: torch.Tensor) -> torch.Tensor:
        """(P,P,P, Mx,My,Mz) element contributions -> (Nx,Ny,Nz) node
        array, overlapping nodes summed (LocalToGlobal ADD_VALUES): the
        transpose of extract_elements, one axis at a time."""
        P, p = self.degree + 1, self.degree
        Mx, My, Mz = self.M
        Nx, Ny, Nz = self.nodes
        t = E.permute(3, 4, 5, 0, 1, 2)  # (Mx,My,Mz, P,P,P): unfold's layout
        t = torch.ops.aten.unfold_backward(t, [Mx, My, Nz, P, P], 2, P, p)
        t = torch.ops.aten.unfold_backward(t, [Mx, Ny, Nz, P], 1, P, p)
        return torch.ops.aten.unfold_backward(t, [Nx, Ny, Nz], 0, P, p)

    def assemble_interior(self, E: torch.Tensor) -> torch.Tensor:
        """``zero_boundaries(assemble_add(E))`` as one gather and one sum:
        E holds (P,P,P, Mx,My,Mz) values in any contiguous shape. E's
        first value, element (0,0,0)'s local node (0,0,0), which only the
        boundary node (0,0,0) takes, is set to 0 in place: the missing
        contributions point at it."""
        flat = E.view(-1)
        flat[:1].zero_()
        idx = _interior_gather(self.M, self.degree, E.device)
        return flat[idx].sum(-1).view(self.nodes)

    # ------------------------------------------------------------------
    # boundary
    # ------------------------------------------------------------------

    def zero_boundaries(self, u: torch.Tensor) -> torch.Tensor:
        """Zero the global-boundary nodes (DMFEZeroBoundaries,
        grid.c:733-759; homogeneous Dirichlet): a new tensor."""
        return u * _interior_mask(self.nodes, u.dtype, u.device)

    # ------------------------------------------------------------------
    # inter-grid transfers
    # ------------------------------------------------------------------

    def inject(self, u_fine: torch.Tensor) -> torch.Tensor:
        """State restriction Rhat: coarse nodes are every 2nd fine node
        (DMFEInject, grid.c:543-562)."""
        return u_fine[::2, ::2, ::2]

    def interpolate(self, coarse_grid: "FEGrid",
                    u_coarse: torch.Tensor) -> torch.Tensor:
        """P: coarse nodes -> fine nodes, separable per axis."""
        Ws = _interp_matrices(self, coarse_grid, u_coarse.dtype,
                              u_coarse.device)
        return sep_apply(*Ws, u_coarse)

    def restrict(self, coarse_grid: "FEGrid",
                 v_fine: torch.Tensor) -> torch.Tensor:
        """R = P^T: residual restriction (DMFERestrict, grid.c:645-731), the
        transposed interpolation matrices."""
        Ws = _interp_matrices(self, coarse_grid, v_fine.dtype, v_fine.device)
        return sep_apply(*(W.t() for W in Ws), v_fine)


def _interp_axis_matrix(fine: FEGrid, coarse: FEGrid, axis: int) -> np.ndarray:
    """(nf, nc) one-axis pass of DMFEInterpolate (grid.c:567-640): even fine
    nodes copy the coarse node; the ``degree`` non-nested fine nodes in
    each coarse element get the reference interp weights. Coarse element
    e holds coarse nodes p*e + l; its fine nodes are 2p*e + 2l (C-points)
    and 2p*e + 2f + 1 (fill f)."""
    p = fine.degree
    W = fine.ref.interp_weights()  # (p, P)
    mc = coarse.M[axis]
    out = np.zeros((fine.nodes[axis], coarse.nodes[axis]))
    for e in range(mc):
        for l in range(p + 1):
            out[2 * p * e + 2 * l, p * e + l] = 1.0
        for f in range(p):
            out[2 * p * e + 2 * f + 1, p * e:p * e + p + 1] = W[f]
    return out


@functools.lru_cache(maxsize=64)
def _interp_matrices(fine: FEGrid, coarse: FEGrid, dtype: torch.dtype,
                     device: torch.device):
    """The three per-axis interpolation matrices of a level pair on
    ``device``, built once."""
    return tuple(torch.tensor(_interp_axis_matrix(fine, coarse, a),
                              dtype=dtype, device=device) for a in range(3))


@functools.lru_cache(maxsize=64)
def _interior_mask(nodes: Tuple[int, int, int], dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """(Nx, Ny, Nz): 1 at the interior nodes, 0 on the boundary."""
    m = torch.zeros(nodes, dtype=dtype, device=device)
    m[1:-1, 1:-1, 1:-1] = 1.0
    return m


@functools.lru_cache(maxsize=64)
def _interior_gather(M: Tuple[int, int, int], degree: int,
                     device: torch.device) -> torch.Tensor:
    """(Nx*Ny*Nz, 8) index of each node's element contributions in the
    flattened (P,P,P, Mx,My,Mz) element tensor: along an axis node n is
    local node l = n - p*e of elements e = n//p and n//p - 1 (those with
    0 <= l <= p, 0 <= e < M); a node takes the 8 products of its per-axis
    pairs. Boundary nodes and missing pairs point at 0, local node
    (0,0,0) of element (0,0,0), which only the corner node (0,0,0) takes
    (assemble_interior zeroes it)."""
    p, P = degree, degree + 1
    axes = []
    for m in M:
        n = np.arange(p * m + 1)[:, None]
        e = n // p - np.arange(2)[None, :]
        loc = n - p * e
        ok = (loc <= p) & (e >= 0) & (e < m) & (n > 0) & (n < p * m)
        axes.append((np.where(ok, loc, 0), np.where(ok, e, 0), ok))
    (l0, e0, k0), (l1, e1, k1), (l2, e2, k2) = axes
    Mx, My, Mz = M
    nelem = Mx * My * Mz

    def grid3(x, y, z, op):
        return op(op(x[:, :, None, None, None, None], y[None, None, :, :, None, None]),
                  z[None, None, None, None, :, :])

    loc = grid3(l0 * P * P, l1 * P, l2, np.add)
    elem = grid3(e0 * My * Mz, e1 * Mz, e2, np.add)
    ok = grid3(k0, k1, k2, np.logical_and)
    idx = np.where(ok, loc * nelem + elem, 0).transpose(0, 2, 4, 1, 3, 5)
    return torch.tensor(idx.reshape(-1, 8), dtype=torch.int64, device=device)
