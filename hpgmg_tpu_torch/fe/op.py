"""FE operator layer: matrix-free Poisson via tensor-product contractions
(counterpart of hpgmg_tpu/fe/op.py).

Rebuild of op/op.c + op/op-poisson1.c. The per-8-element SIMD pipeline
(OpApply_Poisson, op-poisson1.c:112-172) becomes matrix products over ALL
elements at once. The reference's sum-factorized contraction
``du[q1,q2,q3, e] = D[q1,i] B[q2,j] B[q3,k] u[i,j,k, e]`` (tensor.c, E9)
is applied as ONE product with the Kronecker matrix D (x) B (x) B, the
three gradient components stacked into one (3 Q^3, P^3) matrix: for
P, Q <= 4 its 3-4x more flops are one well-shaped GEMM (inner dimension
P^3) where the three per-axis products are nine with an inner dimension
of P = 2-3, which the GPU runs far below its memory rate, each a launch
of host time. The transposed contraction is the transposed matrix,
summing the components inside the product. Local (basis/quad) indices
lead and the element batch trails, as in the JAX package, so the metric
K (3, 3, Q,Q,Q, Mx,My,Mz) and every element tensor keep its shapes. The
3x3 Jacobian inverse is the closed-form adjugate (pointwise.h:7-39).

Registered op types mirror OpRegister/OpCreateFromOptions (op.c:443-517):
poisson1 (Q1), poisson2 (Q2), poisson2affine (exploits the affine
geometry, op-poisson1.c:179-238), and project/project2 (mass-matrix L2
projection used by transfer tests, op-project.c).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from hpgmg_tpu_torch.fe.grid import BlockGrid, FEGrid
from hpgmg_tpu_torch.fe.solutions import get_solution


def _elements(grid: FEGrid, u: torch.Tensor) -> torch.Tensor:
    """The element gather: (P, P*P*n_elements), contiguous, from the
    strided view ``grid.extract_elements(u)`` (one copy)."""
    return grid.extract_elements(u).reshape(grid.degree + 1, -1)


def _kron3(A, B, C) -> torch.Tensor:
    """(QA*QB*QC, PA*PB*PC) Kronecker product A (x) B (x) C: row
    (q1,q2,q3), column (i,j,k)."""
    return torch.einsum("ai,bj,ck->abcijk", A, B, C).reshape(
        A.shape[0] * B.shape[0] * C.shape[0], -1)


def _contract(E: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """y[c, q, e] = sum_n G[(c, q), n] E[n, e] (TensorContract EVAL,
    tensor.c:3-61) for the nc stacked Kronecker matrices of G (nc Q^3,
    P^3); E holds (P^3, n_elements) values in any shape (``_elements``).
    Returns (nc Q^3, n_elements)."""
    return G @ E.reshape(G.shape[1], -1)


def _contract_t(Y: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Transpose contraction (TENSOR_TRANSPOSE), quad points -> nodes,
    summed over the stacked components: out[n, e] = sum_{c,q} G[(c, q),
    n] Y[(c, q), e]. Y holds (nc Q^3, n_elements) values in any
    contiguous shape; returns (P^3, n_elements)."""
    return G.t() @ Y.reshape(G.shape[0], -1)


def _inv3x3(J):
    """Closed-form inverse + determinant of a field of 3x3 matrices stored
    with the matrix indices LEADING: J[a][c] is a tensor (the batched
    analog of PointwiseJacobianInvert, pointwise.h:7-39).

    Returns (Jinv as nested lists Jinv[c][a], det)."""
    a = J
    cof = [[None] * 3 for _ in range(3)]
    # cofactor matrix of the 3x3 with rows a[0], a[1], a[2]
    for r in range(3):
        for c in range(3):
            r1, r2 = [t for t in range(3) if t != r]
            c1, c2 = [t for t in range(3) if t != c]
            sign = 1.0 if (r + c) % 2 == 0 else -1.0
            cof[r][c] = sign * (a[r1][c1] * a[r2][c2] - a[r1][c2] * a[r2][c1])
    det = a[0][0] * cof[0][0] + a[0][1] * cof[0][1] + a[0][2] * cof[0][2]
    idet = 1.0 / det
    # inverse = adjugate / det; adj[c][r] = cof[r][c]
    inv = [[cof[r][c] * idet for r in range(3)] for c in range(3)]
    return inv, det


@dataclasses.dataclass(frozen=True)
class _Tensors:
    """The reference element's tensors for one (Q, dtype, device): the
    quadrature weights' product w3 (Q,Q,Q,1,1,1), the three gradient
    components' Kronecker matrices stacked (``grad``, (3 Q^3, P^3):
    component a takes D on axis a and B on the others) and the mass
    matrix's (``mass``, (Q^3, P^3), B (x) B (x) B)."""

    w3: torch.Tensor
    grad: torch.Tensor
    mass: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FEOp:
    """One physics operator bound to a reference element (Op_private
    analog, op.c:12-95). Holds its reference tensors on each device and
    dtype it was asked for, built once."""

    name: str
    degree: int
    affine: bool = False  # poisson2affine: constant metric per element
    mass_only: bool = False  # 'project': L2 projection (mass matrix)
    _cache: Dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def _t(self, grid: FEGrid, dtype, device) -> _Tensors:
        key = (grid.degree, grid.addquadpts, dtype, torch.device(device))
        t = self._cache.get(key)
        if t is None:
            Bn, Dn, wn = grid.ref.tensors()
            B, D, w = (torch.tensor(a, dtype=dtype, device=device)
                       for a in (Bn, Dn, wn))
            Q = grid.ref.Q
            w3 = (w[:, None, None] * w[None, :, None]
                  * w[None, None, :]).reshape(Q, Q, Q, 1, 1, 1)
            grad = torch.cat([_kron3(*(D if t_ == a else B for t_ in range(3)))
                              for a in range(3)])
            t = self._cache[key] = _Tensors(w3, grad, _kron3(B, B, B))
        return t

    # ------------------------------------------------------------------
    # geometry: metric K[a][b] = w |J| (J^{-1} J^{-T})_{ab} at quad points
    # ------------------------------------------------------------------

    def metric(self, grid: FEGrid, coords: torch.Tensor):
        """(K, wdxdet): K stacked (3, 3, Q,Q,Q, Mx,My,Mz) — matrix indices
        leading; wdxdet (Q,Q,Q, Mx,My,Mz)."""
        t = self._t(grid, coords.dtype, coords.device)
        Q = grid.ref.Q
        shape = (Q, Q, Q) + tuple(grid.M)
        # J[a][c] = d x_c / d xi_a, each (Q,Q,Q, M...)
        Jc = [_contract(_elements(grid, coords[c]), t.grad).view((3,) + shape)
              for c in range(3)]
        J = [[Jc[c][a] for c in range(3)] for a in range(3)]
        del Jc
        Jinv, det = _inv3x3(J)  # Jinv[c][a] = d xi_a / d x_c
        del J
        wdxdet = det * t.w3
        # K[a][b] = wdxdet * sum_c Jinv[c][a] Jinv[c][b]; K[b][a] = K[a][b]
        K = torch.empty((3, 3) + shape, dtype=coords.dtype,
                        device=coords.device)
        for a in range(3):
            for b in range(a, 3):
                K[a, b] = wdxdet * sum(Jinv[c][a] * Jinv[c][b]
                                       for c in range(3))
                if b != a:
                    K[b, a] = K[a, b]
        return K, wdxdet

    def metric_affine(self, grid: FEGrid, dtype, device="cuda"):
        """Uniform-grid shortcut (poisson2affine): constant diagonal metric
        (op-poisson1.c:179-238). Returns (kdiag (3,), wdxdet (Q,Q,Q,1,1,1))."""
        hx = [h / 2.0 for h in grid.spacing]  # dx/dxi
        det = hx[0] * hx[1] * hx[2]
        wdxdet = det * self._t(grid, dtype, device).w3
        kdiag = torch.tensor([1.0 / (h * h) for h in hx], dtype=dtype,
                             device=device)
        return kdiag, wdxdet

    def make_metric(self, grid: FEGrid, coords: Optional[torch.Tensor], dtype,
                    device="cuda"):
        if self.affine or coords is None:
            return self.metric_affine(grid, dtype, device)
        return self.metric(grid, coords)

    def _apply_metric(self, metric, du):
        """dv[a] = sum_b K[a,b] du[b]; du and dv are (3, Q^3, n)."""
        Ka, wdxdet = metric
        du = du.view(3, -1, du.shape[-1])
        if Ka.ndim == 1:  # affine diagonal
            return (Ka.view(3, 1) * wdxdet.reshape(1, -1)).unsqueeze(-1) * du
        K = Ka.view(3, 3, du.shape[1], -1)
        dv = K[:, 0] * du[0]
        dv.addcmul_(K[:, 1], du[1])
        return dv.addcmul_(K[:, 2], du[2])

    # ------------------------------------------------------------------
    # A(u)
    # ------------------------------------------------------------------

    def apply(self, grid: FEGrid, coords: Optional[torch.Tensor],
              u: torch.Tensor, metric=None) -> torch.Tensor:
        """v = A u (OpApply_Poisson pipeline, op-poisson1.c:112-172)."""
        t = self._t(grid, u.dtype, u.device)
        if metric is None:
            metric = self.make_metric(grid, coords, u.dtype, u.device)
        ue = _elements(grid, u)
        if self.mass_only:
            _, wdxdet = metric
            uq = _contract(ue, t.mass)
            ve = _contract_t(wdxdet.reshape(uq.shape[0], -1) * uq, t.mass)
        else:
            du = _contract(ue, t.grad)
            ve = _contract_t(self._apply_metric(metric, du), t.grad)
        return grid.assemble_interior(ve)

    # ------------------------------------------------------------------
    # forcing / solution / norms / diagonal
    # ------------------------------------------------------------------

    def _quad_coords(self, grid: FEGrid, coords: torch.Tensor):
        """(3, Q,Q,Q, Mx,My,Mz) coordinates at the quadrature points."""
        t = self._t(grid, coords.dtype, coords.device)
        Q = grid.ref.Q
        return torch.stack([
            _contract(_elements(grid, coords[c]), t.mass)
            for c in range(3)]).view((3, Q, Q, Q) + tuple(grid.M))

    def forcing(self, grid: FEGrid, coords: torch.Tensor,
                solution: str) -> torch.Tensor:
        """Galerkin projection of the analytic forcing (OpForcing,
        op.c:123-180): F = assemble(B^T (w |J| f(x_q)))."""
        t = self._t(grid, coords.dtype, coords.device)
        _, wdxdet = self.make_metric(grid, coords, coords.dtype, coords.device)
        xq = self._quad_coords(grid, coords)
        _, fq = get_solution(solution)(xq, grid.L)
        return grid.assemble_interior(_contract_t(wdxdet * fq, t.mass))

    def solution_nodes(self, grid: FEGrid, coords: torch.Tensor,
                       solution: str) -> torch.Tensor:
        """Pointwise analytic u at the nodes (OpSolution, op.c:96-121)."""
        u, _ = get_solution(solution)(coords, grid.L)
        return grid.zero_boundaries(u)

    def integrate_norms(self, grid: FEGrid, coords: torch.Tensor,
                        u: torch.Tensor, solution: str):
        """(e_max, e_L2) of u vs the analytic solution via quadrature,
        normalized by the solution norms (OpIntegrateNorms, op.c:183-250).
        A rank's block of a decomposed level raises: its norms would be
        the block's (the JAX package never runs them sharded)."""
        if isinstance(grid, BlockGrid):
            raise NotImplementedError(
                "integrate_norms on a decomposed level; gather u first")
        t = self._t(grid, u.dtype, u.device)
        _, wdxdet = self.make_metric(grid, coords, u.dtype, u.device)
        xq = self._quad_coords(grid, coords)
        uex, _ = get_solution(solution)(xq, grid.L)
        uq = _contract(_elements(grid, u), t.mass).view(uex.shape)
        diff = uq - uex
        wq = wdxdet.expand(uq.shape)
        e_max = torch.max(torch.abs(diff)) / torch.max(torch.abs(uex))
        e_l2 = torch.sqrt(torch.sum(wq * diff * diff)) \
            / torch.sqrt(torch.sum(wq * uex * uex))
        return e_max, e_l2

    def diagonal(self, grid: FEGrid, coords: Optional[torch.Tensor],
                 dtype=torch.float64, metric=None,
                 device="cuda") -> torch.Tensor:
        """Matrix-free diag(A) (OpGetDiagonal, op.c:263-338), in closed
        separable form instead of the reference's P^3 one-hot element
        probes: with e the (i,j,k) one-hot, du[b](q) factorizes as
        mats[b][0][q1,i]*mats[b][1][q2,j]*mats[b][2][q3,k], so

          diag[ijk] = sum_ab sum_q prod_t (mats[a][t] ⊙ mats[b][t])(q_t, ·)
                      * K[a,b](q)

        — one transposed contraction of the 9 (a, b) components (3 for
        the affine diagonal metric, 1 for mass-only), whose Kronecker
        matrices are the elementwise products of the components'."""
        if coords is not None:
            device = coords.device
        t = self._t(grid, dtype, device)
        if metric is None:
            metric = self.make_metric(grid, coords, dtype, device)
        Q3 = grid.ref.Q ** 3
        M = tuple(grid.M)
        G = t.grad.view(3, Q3, -1)
        if self.mass_only:
            _, wdxdet = metric
            Y = wdxdet.expand((grid.ref.Q,) * 3 + M)
            U = t.mass * t.mass
        else:
            Ka, wdxdet = metric
            if Ka.ndim == 1:  # affine metric is diagonal: a == b only
                Y = (Ka.view(3, 1, 1, 1, 1, 1, 1) * wdxdet).expand(
                    (3,) + wdxdet.shape[:3] + M)
                U = (G * G).reshape(3 * Q3, -1)
            else:
                Y = Ka
                U = (G[:, None] * G[None, :]).reshape(9 * Q3, -1)
        d = grid.assemble_interior(_contract_t(Y, U))
        # constrained (boundary) nodes act as identity rows: diag = 1 (on a
        # block, after assembly has summed its shared planes)
        return torch.where(d == 0.0, 1.0, d)


_OPS = {
    "poisson1": lambda: FEOp("poisson1", degree=1),
    "poisson2": lambda: FEOp("poisson2", degree=2),
    "poisson2affine": lambda: FEOp("poisson2affine", degree=2, affine=True),
    "project": lambda: FEOp("project", degree=1, mass_only=True),
    "project2": lambda: FEOp("project2", degree=2, mass_only=True),
}


def get_fe_op(name: str) -> FEOp:
    if name not in _OPS:
        raise ValueError(f"unknown -op_type {name!r}; have {sorted(_OPS)}")
    return _OPS[name]()
