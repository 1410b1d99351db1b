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

A rank's block of a decomposed level (fe/mesh.py) is a ``BlockGrid``: the
same operations on its elements and nodes, with sums completed across
the ranks where a neighbour shares a node plane.

Float32 matrix products must not drop to TF32, which keeps ~3 decimal
digits (the JAX package runs them at Precision.HIGHEST): the flag is set
here for every module of ``fe/``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Tuple

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

    @property
    def spacing(self) -> Tuple[float, float, float]:
        """The element size along each axis."""
        return tuple(self.L[a] / self.M[a] for a in range(3))

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

    def node_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a node field over the level."""
        return torch.sum(x)

    # ------------------------------------------------------------------
    # inter-grid transfers
    # ------------------------------------------------------------------

    def inject(self, u_fine: torch.Tensor, coarse_grid=None) -> torch.Tensor:
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


@dataclasses.dataclass(frozen=True)
class BlockGrid(FEGrid):
    """A rank's block of a decomposed level (``fe/mesh.py:FEPart.block``):
    ``M`` its elements, ``L`` the domain's lengths, ``part`` its FEPart.
    The element gather and the metric are FEGrid's on the block's nodes;
    assembly completes the sums on the planes the block shares with a
    neighbour, only the domain's faces are zeroed, and a transfer to a
    coarse level split alike stays local (restrict sums its shared coarse
    planes), one to a coarse level replicated along some of the block's
    split axes ends in a gather (inject, restrict) or starts from a cut
    (interpolate)."""

    part: Any = None

    @property
    def spacing(self) -> Tuple[float, float, float]:
        return self.part.grid.spacing

    @property
    def keep(self) -> Tuple[Tuple[bool, bool], ...]:
        """(low, high) per axis: whether the boundary plane is kept (not a
        face of the domain)."""
        return tuple((not lo, not hi) for lo, hi in self.part.domain_faces)

    def node_coords_1d(self, axis: int, dtype=torch.float64, device="cuda"):
        o = self.part.node_offsets[axis]
        return self.part.grid.node_coords_1d(axis, dtype, device)[o:o + self.nodes[axis]]

    def assemble_add(self, E: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "assemble_add on a decomposed level would leave partial sums on the "
            "shared planes; assemble_interior completes them")

    def assemble_interior(self, E: torch.Tensor) -> torch.Tensor:
        """``assemble_interior`` on the block: the local sums
        (``_assemble_local``), completed on the shared planes."""
        return self.part.sum_shared(
            _assemble_local(E, self.M, self.degree, self.keep).view(self.nodes))

    def zero_boundaries(self, u: torch.Tensor) -> torch.Tensor:
        return u * _block_mask(self.nodes, self.keep, u.dtype, u.device)

    def node_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.part.node_sum(x)

    def _aligned(self, coarse_grid: FEGrid) -> bool:
        return (isinstance(coarse_grid, BlockGrid)
                and coarse_grid.part.split == self.part.split)

    def inject(self, u_fine: torch.Tensor, coarse_grid=None) -> torch.Tensor:
        """Every fine node of even global index: the coarse block (split
        alike) or, gathered, the coarse level as it is held."""
        s = tuple(o % 2 for o in self.part.node_offsets)
        piece = u_fine[s[0]::2, s[1]::2, s[2]::2]
        if self._aligned(coarse_grid):
            return piece
        whole = self.part.all_gather(
            piece, lambda p: tuple((o + o % 2) // 2 for o in p.node_offsets),
            _whole(coarse_grid).nodes)
        return _held(coarse_grid, whole)

    def interpolate(self, coarse_grid: FEGrid,
                    u_coarse: torch.Tensor) -> torch.Tensor:
        """The block's rows of P from the coarse nodes they take (a cut of
        the coarse field where it is held whole along an axis)."""
        Ws, cols, _ = _block_transfer(self, coarse_grid, False,
                                      u_coarse.dtype, u_coarse.device)
        return sep_apply(*Ws, u_coarse[cols])

    def restrict(self, coarse_grid: FEGrid,
                 v_fine: torch.Tensor) -> torch.Tensor:
        """R = P^T of the nodes the block owns (a shared fine plane counts
        once), then the coarse partial sums completed: on the shared
        coarse planes (split alike), or all-reduced into the coarse level
        as it is held."""
        from hpgmg_tpu_torch.core.blas import sum_over

        Ws, _, lo = _block_transfer(self, coarse_grid, True, v_fine.dtype,
                                    v_fine.device)
        ox, oy, oz = self.part.owned
        partial = sep_apply(*(W.t() for W in Ws), v_fine[:ox, :oy, :oz])
        if self._aligned(coarse_grid):
            return coarse_grid.part.sum_shared(partial)
        whole = v_fine.new_zeros(_whole(coarse_grid).nodes)
        whole[tuple(slice(o, o + n) for o, n in zip(lo, partial.shape))] = partial
        return _held(coarse_grid, sum_over(whole, self.part))


def _whole(g: FEGrid) -> FEGrid:
    """The whole level of a grid or a block."""
    return g.part.grid if isinstance(g, BlockGrid) else g


def _held(g: FEGrid, whole: torch.Tensor) -> torch.Tensor:
    """The part of the whole level's node field that ``g`` holds."""
    return g.part.cut(whole) if isinstance(g, BlockGrid) else whole


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
def _block_transfer(fine: BlockGrid, coarse: FEGrid, owned: bool,
                    dtype: torch.dtype, device: torch.device):
    """(Ws, cols, lo) of a block's transfers, built once: per axis the rows
    of the interpolation matrix of the block's nodes (the nodes it owns
    where ``owned``) and the columns of the coarse nodes they take, those
    columns as a slice of the coarse field as ``coarse`` holds it, and the
    global index of the first."""
    Ws, cols, los = [], [], []
    for a in range(3):
        W = _interp_axis_matrix(fine.part.grid, _whole(coarse), a)
        f0 = fine.part.node_offsets[a]
        rows = W[f0:f0 + (fine.part.owned if owned else fine.nodes)[a]]
        nz = np.flatnonzero(rows.any(axis=0))
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        held = (coarse.part.node_offsets[a] if isinstance(coarse, BlockGrid)
                and coarse.part.split[a] else 0)
        Ws.append(torch.tensor(rows[:, lo:hi], dtype=dtype, device=device))
        cols.append(slice(lo - held, hi - held))
        los.append(lo)
    return tuple(Ws), tuple(cols), tuple(los)


@functools.lru_cache(maxsize=64)
def _block_mask(nodes: Tuple[int, int, int], keep, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """A block's (Nx, Ny, Nz) mask: 0 on its boundary planes that are
    faces of the domain (``keep`` False), 1 elsewhere."""
    m = torch.ones(nodes, dtype=dtype, device=device)
    for a, (klo, khi) in enumerate(keep):
        if not klo:
            m.select(a, 0).zero_()
        if not khi:
            m.select(a, nodes[a] - 1).zero_()
    return m


@functools.lru_cache(maxsize=64)
def _interior_mask(nodes: Tuple[int, int, int], dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """(Nx, Ny, Nz): 1 at the interior nodes, 0 on the boundary."""
    m = torch.zeros(nodes, dtype=dtype, device=device)
    m[1:-1, 1:-1, 1:-1] = 1.0
    return m


def _assemble_local(E: torch.Tensor, M, degree: int, keep) -> torch.Tensor:
    """A block's local node sums of E ((P,P,P, Mx,My,Mz) values in any
    contiguous shape), flat; the domain-face nodes (``keep``: BlockGrid.keep)
    take 0. The missing contributions point at a value of E that only a
    domain-face node takes, set to 0 in place: the low corner's (E's first)
    where the block has a low domain face, else the high corner's (E's
    last) where it has a high one; a block with no domain face appends a
    zero to a copy of E."""
    flat = E.reshape(-1)
    n = flat.numel()
    if not all(lo for lo, _ in keep):
        miss = 0
    elif not all(hi for _, hi in keep):
        miss = n - 1
    else:
        miss = n
        flat = torch.cat([flat, flat.new_zeros(1)])
    flat[miss:miss + 1].zero_()
    return flat[_interior_gather(tuple(M), degree, E.device, keep, miss)].sum(-1)


@functools.lru_cache(maxsize=64)
def _interior_gather(M: Tuple[int, int, int], degree: int,
                     device: torch.device, keep=None, miss: int = 0) -> torch.Tensor:
    """(Nx*Ny*Nz, 8) index of each node's element contributions in the
    flattened (P,P,P, Mx,My,Mz) element tensor: along an axis node n is
    local node l = n - p*e of elements e = n//p and n//p - 1 (those with
    0 <= l <= p, 0 <= e < M); a node takes the 8 products of its per-axis
    pairs. Boundary nodes and missing pairs point at 0, local node
    (0,0,0) of element (0,0,0), which only the corner node (0,0,0) takes
    (assemble_interior zeroes it). With ``keep`` (a block's (low, high)
    per axis, BlockGrid.keep) the kept boundary planes take their
    contributions, and the rest point at ``miss`` (``_assemble_local``'s
    zero)."""
    p, P = degree, degree + 1
    axes = []
    for a, m in enumerate(M):
        klo, khi = (False, False) if keep is None else keep[a]
        n = np.arange(p * m + 1)[:, None]
        e = n // p - np.arange(2)[None, :]
        loc = n - p * e
        ok = ((loc <= p) & (e >= 0) & (e < m) & ((n > 0) | klo)
              & ((n < p * m) | khi))
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
    idx = np.where(ok, loc * nelem + elem, miss).transpose(0, 2, 4, 1, 3, 5)
    return torch.tensor(idx.reshape(-1, 8), dtype=torch.int64, device=device)
