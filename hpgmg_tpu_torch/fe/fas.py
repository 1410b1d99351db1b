"""FAS full multigrid for the FE path (counterpart of hpgmg_tpu/fe/fas.py).

Rebuild of finite-element/fmg.c. Per level the smoother is a fixed-interval
preconditioned Chebyshev (KSPCHEBYSHEV + PCJACOBI with eigenvalue targets
[0.4, 1.4] of D^{-1}A — fmg.c:92-120; no eigen-estimation), the coarsest
level runs Jacobi-preconditioned CG (rtol 1e-10, fmg.c:112-115,246-252).
The V-cycle is the FAS form

    Ac uc = R (bf - Af uf) + Ac (Rhat uf)       (fmg.c:234-237)

with Rhat = injection and R = P^T. The reference's shrinking communicator
(idle ranks pass NULL vectors, grid.c:208-220) maps to coarse levels being
replicated across the ranks, the same agglomeration mechanism as the FV
path: ``build_fe_levels(..., mesh=)`` gives each level split over the
process grid its FEPart (fe/mesh.py: the rank's block, both boundary node
planes included), and a level too small to split none, so every rank
holds it whole and runs it redundantly. The cycle is the same code on
either: the operator and the transfers work through ``FELevel.block``
(the level's FEGrid, or the rank's fe/grid.py:BlockGrid, which sums the
shared planes and gathers or cuts at a change of placement), and the
CG's dot products count each node once over the ranks
(``node_sum``: every rank reads the same stopping flag). The diagnostics
and the standalone Chebyshev KSP raise on a decomposed level.

The JAX package's ``lax.while_loop``s (the CG and the standalone
Chebyshev KSP) are Python loops here that read one host flag an
iteration (``_host_flag``, as solve/bottom.py does), with the same
stopping tests and caps. Every entry point builds and solves on the
device it is given, ``cuda`` unless the caller passes another.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from hpgmg_tpu_torch.fe.grid import FEGrid
from hpgmg_tpu_torch.fe.op import FEOp


@dataclasses.dataclass
class FELevel:
    grid: FEGrid
    coords: torch.Tensor  # (3, Nx, Ny, Nz)
    dinv: torch.Tensor  # 1/diag(A) with 1 on constrained nodes
    # metric: either (K, wdxdet) full or (kdiag, wdxdet) affine
    metric_a: torch.Tensor
    metric_w: torch.Tensor
    # this rank's block where the level is split over the process grid
    # (fe/mesh.py:FEPart; the fields above are the block's), else None
    part: Optional[Any] = None

    @property
    def block(self) -> FEGrid:
        """The grid the operator and the transfers work on: the level's,
        or this rank's block of it (fe/grid.py:BlockGrid)."""
        return self.grid if self.part is None else self.part.block


def build_fe_level(g: FEGrid, op: FEOp, dtype=torch.float64,
                   distort: float = 0.0, device="cuda", part=None) -> FELevel:
    """One level: coordinates, metric and the inverse diagonal
    (MGSetUpPC diag extraction, fmg.c:82-171); with ``part`` (an FEPart
    of ``g``) this rank's block of each, made on the block alone (its
    nodes' coordinates from the level's, its elements' metric, the
    diagonal assembled across the shared planes)."""
    block = g if part is None else part.block
    coords = block.node_coords(dtype, distort, device)
    metric = op.make_metric(block, coords, dtype, device)
    diag = op.diagonal(block, coords, dtype, metric=metric)
    return FELevel(grid=g, coords=coords, dinv=1.0 / diag,
                   metric_a=metric[0], metric_w=metric[1], part=part)


def build_fe_levels(grid: FEGrid, op: FEOp, dtype=torch.float64,
                    distort: float = 0.0, device="cuda",
                    mesh=None) -> List[FELevel]:
    """Build the level ladder fine -> coarse (MGCreate + DMFECoarsen chain,
    fmg.c:82-171), every field on ``device``. With ``mesh`` (a
    parallel/mesh.py Mesh of the initialized process group) each level
    is split over it where fe/mesh.py:_axis_spec splits an axis, else
    replicated."""
    from hpgmg_tpu_torch.fe.mesh import fe_level_part

    grids = [grid]
    while grids[-1].can_coarsen():
        grids.append(grids[-1].coarsen())
    return [build_fe_level(g, op, dtype, distort, device, fe_level_part(mesh, g))
            for g in grids]


def _apply(op: FEOp, L: FELevel, u):
    return op.apply(L.block, L.coords, u, metric=(L.metric_a, L.metric_w))


def _whole_only(L: FELevel, what: str):
    """Raise on a decomposed level: ``what`` would give the block's
    answer, not the level's."""
    if L.part is not None:
        raise NotImplementedError(f"{what} on a decomposed level")


# host reads of the loops' flags so far (``_host_flag``)
host_reads = 0


def _host_flag(flag: torch.Tensor) -> bool:
    """Read a loop's flag on the host (one device sync), counted in
    ``host_reads``."""
    global host_reads
    host_reads += 1
    return bool(flag)


def chebyshev(op: FEOp, L: FELevel, b, x, iters: int,
              emin: float = 0.4, emax: float = 1.4):
    """Fixed-interval Jacobi-preconditioned Chebyshev (the KSPCHEBYSHEV
    configuration of fmg.c:107-120), three-term recurrence as in the FV
    smoother (chebyshev.c:90-94) with theta/delta from [emin, emax]."""
    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)
    sigma = theta / delta
    rho = 1.0 / sigma
    c1, c2 = [0.0], [1.0 / theta]
    for _ in range(1, iters):
        rho_prev = rho
        rho = 1.0 / (2.0 * sigma - rho_prev)
        c1.append(rho * rho_prev)
        c2.append(rho * 2.0 / delta)

    x_prev = x
    for s in range(iters):
        r = b - _apply(op, L, x)
        # x + c1 (x - x_prev) + c2 dinv r; c1 = 0 on the first step
        x_next = torch.addcmul(x, L.dinv, r, value=c2[s])
        if c1[s]:
            x_next.add_(x - x_prev, alpha=c1[s])
        x_prev, x = x, x_next
    return x


def _cg_loop(op: FEOp, L: FELevel, b, x, max_iters: int, rtol: float):
    """Jacobi-preconditioned CG with nonzero initial guess (coarsest-level
    KSP, fmg.c:112-118). Convergence uses the natural norm sqrt(r'z)
    relative to the natural norm of the RHS, sqrt(b'Bb) — PETSc
    KSPConvergedDefault compares against the norm of b (UIRNorm unset),
    so a warm-started solve whose incoming residual is already small
    terminates immediately. Returns (x, iterations, the converged flag
    on the device); one host read before the first iteration and one
    after each but the last allowed."""
    g = L.block
    r = b - _apply(op, L, x)
    z = L.dinv * r
    p = z
    rtz = g.node_sum(r * z)
    target = rtol * torch.sqrt(torch.abs(g.node_sum(b * (L.dinv * b))))
    done = (rtz == 0.0) | (torch.sqrt(torch.abs(rtz)) < target)
    j = 0
    while j < max_iters and not _host_flag(done):
        ap = _apply(op, L, p)
        pap = g.node_sum(p * ap)
        alpha = torch.where(pap == 0.0, 0.0, rtz / pap)  # guard breakdown
        x = x + alpha * p
        r = r - alpha * ap
        z = L.dinv * r
        rtz1 = g.node_sum(r * z)
        done = (pap == 0.0) | (torch.sqrt(torch.abs(rtz1)) < target)
        beta = torch.where(rtz == 0.0, 0.0, rtz1 / rtz)
        p = z + beta * p
        rtz = rtz1
        j += 1
    return x, j, done


def cg(op: FEOp, L: FELevel, b, x, max_iters: int = 20, rtol: float = 1e-10):
    return _cg_loop(op, L, b, x, max_iters, rtol)[0]


def cg_info(op: FEOp, L: FELevel, b, x, max_iters: int = 20,
            rtol: float = 1e-10):
    """(x, iterations, converged) — for callers that report PETSc-style
    convergence reasons (run_ksp)."""
    x, j, done = _cg_loop(op, L, b, x, max_iters, rtol)
    return x, j, bool(done)


def bottom_iters(grid: FEGrid) -> int:
    """The coarsest solve's CG cap. PETSc KSPCG's default maxits is 10000
    (fmg.c sets only rtol=1e-10); exact arithmetic terminates in neq
    steps, so cap there (plus rounding slack) instead of spinning when
    1e-10 is unreachable."""
    return min(400, 2 * grid.neq + 10)


def fas_vcycle(op: FEOp, levels: List[FELevel], lev: int, b, u,
               pre: int = 2, post: int = 3,
               eig: Tuple[float, float] = (0.4, 1.4)):
    """FAS V-cycle (MGVCycle, fmg.c:238-303). ``eig`` is the Chebyshev
    target interval (emin, emax) of the Jacobi-preconditioned operator —
    the -mg_eig_target option (fmg.c:91-94, default [0.4, 1.4])."""
    L = levels[lev]
    if lev == len(levels) - 1:
        return cg(op, L, b, u, max_iters=bottom_iters(L.grid))

    u = chebyshev(op, L, b, u, pre, emin=eig[0], emax=eig[1])
    v = b - _apply(op, L, u)
    Lc = levels[lev + 1]
    g, gc = L.block, Lc.block
    uc = gc.zero_boundaries(g.inject(u, gc))  # Rhat u
    vc = _apply(op, Lc, uc) + g.restrict(gc, v)
    vc = gc.zero_boundaries(vc)
    yc = uc
    uc = fas_vcycle(op, levels, lev + 1, vc, uc, pre, post, eig)
    u = u + g.interpolate(gc, uc - yc)
    u = chebyshev(op, L, b, u, post, emin=eig[0], emax=eig[1])
    return u


def fas_fcycle(op: FEOp, levels: List[FELevel], lev: int, b,
               pre: int = 2, post: int = 3,
               eig: Tuple[float, float] = (0.4, 1.4)):
    """FAS full multigrid (MGFCycle, fmg.c:305-334): restrict the forcing
    down, coarsest solve, then interpolate + V-cycle per level."""
    L = levels[lev]
    if lev == len(levels) - 1:
        u = torch.zeros(L.block.nodes, dtype=b.dtype, device=b.device)
        return cg(op, L, b, u, max_iters=bottom_iters(L.grid))

    Lc = levels[lev + 1]
    bc = restrict_down(L, Lc, b)
    uc = fas_fcycle(op, levels, lev + 1, bc, pre, post, eig)
    u = L.block.interpolate(Lc.block, uc)
    return fas_vcycle(op, levels, lev, b, u, pre, post, eig)


def restrict_down(L: FELevel, Lc: FELevel, b):
    """The forcing of the coarse level ``Lc``: R b with its boundary
    zeroed (the F-cycle's step down)."""
    return Lc.block.zero_boundaries(L.block.restrict(Lc.block, b))


def diagnostics(op: FEOp, L: FELevel, b, u, solution: str):
    """(r_2/||b||_2, e_max, e_L2) — MGRecordDiagnostics (fmg.c:198-232)."""
    _whole_only(L, "diagnostics")
    r = b - _apply(op, L, u)
    rnorm = torch.sqrt(torch.sum(r * r))
    bnorm = torch.sqrt(torch.sum(b * b))
    e_max, e_l2 = op.integrate_norms(L.grid, L.coords, u, solution)
    return rnorm / bnorm, e_max, e_l2


def nodal_diagnostics(op: FEOp, L: FELevel, b, u, solution: str):
    """(|e|_2/|u0|_2, |r|_2/|f|_2) in plain nodal 2-norms against the
    pointwise analytic solution at the nodes — exactly what RunFMG prints
    and the reference goldens assert (fmg.c:455-467, t220-fmg.sh:8-22)."""
    _whole_only(L, "nodal_diagnostics")
    u0 = op.solution_nodes(L.grid, L.coords, solution)
    e = u - u0
    r = b - _apply(op, L, u)
    rel_e = torch.sqrt(torch.sum(e * e)) / torch.sqrt(torch.sum(u0 * u0))
    rel_r = torch.sqrt(torch.sum(r * r)) / torch.sqrt(torch.sum(b * b))
    return rel_e, rel_r


def run_fmg(grid: FEGrid, op: FEOp, solution: str = "sine",
            dtype=torch.float64, distort: float = 0.0, pre: int = 2,
            post: int = 3, num_vcycles: int = 2, monitor: bool = True,
            eig: Tuple[float, float] = (0.4, 1.4), device="cuda"):
    """RunFMG (fmg.c:421-480): one F-cycle then trailing V-cycles, printing
    the reference's golden-matched table
    ``F(3,3)  0: |e|_2/|u|_2 ...  |r|_2/|f|_2 ...`` (fmg.c:467) plus the
    MGRecordDiagnostics quadrature-norm line under ``monitor``."""
    levels = build_fe_levels(grid, op, dtype, distort, device)
    f = op.forcing(levels[0].grid, levels[0].coords, solution)

    results = []
    u = None
    for i in range(1 + num_vcycles):
        kind = "F" if i == 0 else "V"
        u = (fas_fcycle(op, levels, 0, f, pre, post, eig) if i == 0
             else fas_vcycle(op, levels, 0, f, u, pre, post, eig))
        rel_e, rel_r = (float(x) for x in
                        nodal_diagnostics(op, levels[0], f, u, solution))
        r2, emax, el2 = (float(x) for x in
                         diagnostics(op, levels[0], f, u, solution))
        print(f"{kind}({pre},{post}) {i:2d}: |e|_2/|u|_2 {rel_e:8.2e}  "
              f"|r|_2/|f|_2 {rel_r:8.2e}")
        results.append((kind, dict(rel_e=rel_e, rel_r=rel_r, r2=r2,
                                   e_max=emax, e_L2=el2)))

    if monitor:
        g = grid
        for kind, s in results:
            print(f"{kind}({pre},{post}) Q{grid.degree} "
                  f"G[{g.M[0]:5d}{g.M[1]:5d}{g.M[2]:5d}] "
                  f"e_max {s['e_max']:8.2e} e_L2 {s['e_L2']:8.2e} "
                  f"r_2 {s['r2']:8.2e}")
    return u, levels, f, results


def ksp_chebyshev(op: FEOp, L: FELevel, b, rtol: float = 1e-5,
                  max_iters: int = 10000,
                  eig: Tuple[float, float] = (0.2, 2.0)):
    """Standalone Jacobi-preconditioned Chebyshev KSP on one grid — the
    ``-ksp_type chebyshev -pc_type jacobi`` configuration of
    t120-poissonksp.sh. Left preconditioning with the PETSc-default
    PRECONDITIONED norm: converged when ||B r||_2 < rtol * ||B b||_2
    (zero initial guess). Returns (x, iterations); one host read before
    each iteration and after the last."""
    _whole_only(L, "ksp_chebyshev")
    emin, emax = eig
    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)
    sigma = theta / delta

    def prec_norm(r):
        z = L.dinv * r
        return torch.sqrt(torch.sum(z * z))

    norm_b = prec_norm(b)
    x = x_prev = torch.zeros(L.grid.nodes, dtype=b.dtype, device=b.device)
    # continuing 3-term recurrence (chebyshev.c:90-94 / KSPChebyshev): the
    # first step has no history term. The residual is carried, so each
    # iteration costs ONE operator apply; r0 = b because x0 = 0. rho
    # carries rho_{j-1}; seeding with sigma makes the first rho 1/sigma.
    r, rho, rnorm, j = b, sigma, norm_b, 0
    while j < max_iters and _host_flag(rnorm > rtol * norm_b):
        rho_next = 1.0 / (2.0 * sigma - rho)
        c1 = 0.0 if j == 0 else rho_next * rho
        c2 = 1.0 / theta if j == 0 else rho_next * 2.0 / delta
        x_next = x + c1 * (x - x_prev) + c2 * L.dinv * r
        r = b - _apply(op, L, x_next)
        x_prev, x, rho, rnorm, j = x, x_next, rho_next, prec_norm(r), j + 1
    return x, j


def run_ksp(grid: FEGrid, op: FEOp, solution: str = "sine",
            dtype=torch.float64, ksp_type: str = "chebyshev",
            rtol: float = 1e-5, eig: Tuple[float, float] = (0.2, 2.0),
            monitor: bool = True, device="cuda"):
    """TestKSPSolve (fefas-test.c:531-577) / the sampler's -solve_type ksp:
    a standalone Krylov solve on the *fine* grid only (no multigrid),
    cross-checking the FAS path. Prints |v-u|_2/|u|_2 like the reference."""
    L = build_fe_level(grid, op, dtype, device=device)
    f = op.forcing(L.grid, L.coords, solution)
    u0 = op.solution_nodes(L.grid, L.coords, solution)
    max_iters = 10000
    if ksp_type == "chebyshev":
        v, its = ksp_chebyshev(op, L, f, rtol=rtol, max_iters=max_iters,
                               eig=eig)
        converged = its < max_iters
    elif ksp_type == "cg":
        v, its, converged = cg_info(op, L, f, torch.zeros_like(f),
                                    max_iters=max_iters, rtol=rtol)
    else:
        raise ValueError(f"unknown ksp_type {ksp_type!r}")
    err = float(torch.sqrt(torch.sum((v - u0) ** 2))
                / torch.sqrt(torch.sum(u0 * u0)))
    if monitor:
        # PETSc KSPConvergedReasonView strings: CONVERGED_RTOL when the
        # tolerance was met before the cap, DIVERGED_ITS otherwise
        reason = ("converged due to CONVERGED_RTOL" if converged
                  else "did not converge due to DIVERGED_ITS")
        print(f"Linear solve {reason} iterations {its}")
        print(f"|v-u|_2/|u|_2 = {err:g}")
    return v, its, err
