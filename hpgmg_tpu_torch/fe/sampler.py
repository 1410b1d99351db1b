"""FE performance sampler (counterpart of hpgmg_tpu/fe/sampler.py;
RunSample, finite-element/sampler.c).

Protocol (sampler.c:242-292, README.md:66-73): enumerate compatible grid
sizes from the 8 coarse seeds x 8^level, greedily thin to ``maxsamples``,
run the smallest first (sanity), the largest next (memory + warmup), then
a timed sweep small -> large, printing per sample:

    Q<degree> G[...] P[...] <time> s <GF> GF <MEq/s> MEq/s

Equations = global nodes; FLOPs counted analytically from the static
tensor-contraction shapes (the reference counts via PetscLogFlops — the
manual counts at tensor.c:58, pointwise.h:37, op-poisson1.c:98).

A sample times a chain of data-dependent F-cycles (each one's rhs is
``f + 0*u[1,1,1]`` of the one before, no host sync between them) with
CUDA events on a CUDA device, the host clock on the CPU
(bench/driver.py:elapsed), and reports the best of its repeats. The
coarsest level's CG reads one host flag an iteration inside that chain
(fe/fas.py).

Under an initialized process group of more than one rank (one process per
device: ``python -m hpgmg_tpu_torch.fe.cli sample -ranks N``, or torchrun)
the sampler runs on the ``make_mesh`` grid of the ranks, as the JAX
sampler runs on the mesh of its devices: ``P[...]`` is the grid, the
sample sizes those of ``sample_grid_range`` for it, every level split
over it by fe/mesh.py (the coarse ones replicated), each chain timed
between barriers and the slowest rank's seconds kept; rank 0 prints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from hpgmg_tpu_torch.bench.driver import slowest, elapsed
from hpgmg_tpu_torch.fe.fas import (bottom_iters, build_fe_levels, cg_info,
                                    fas_fcycle, restrict_down)
from hpgmg_tpu_torch.fe.grid import FEGrid
from hpgmg_tpu_torch.fe.op import FEOp

COARSE_SEEDS = [(2, 2, 2), (2, 2, 3), (2, 3, 3), (3, 3, 3),
                (3, 3, 4), (3, 4, 4), (2, 2, 4), (2, 4, 4)]


def sample_grid_range(min_local: int, max_local: int,
                      procs: Tuple[int, int, int]) -> List[Tuple[int, int, int]]:
    """Enumerate global grids whose per-device element count lies in
    [min_local, max_local] (SampleGridRangeCreate, sampler.c:54-76)."""
    nproc = procs[0] * procs[1] * procs[2]
    out = []
    for seed in COARSE_SEEDS:
        M = list(seed)
        while True:
            nelem = M[0] * M[1] * M[2]
            local = nelem / nproc
            if local > max_local:
                break
            if local >= min_local:
                out.append(tuple(M))
            M = [2 * m for m in M]
    return sorted(set(out), key=lambda M: M[0] * M[1] * M[2])


def thin_samples(samples: List[Tuple[int, int, int]],
                 maxsamples: int) -> List[Tuple[int, int, int]]:
    """Greedy geometric thinning (sampler.c:97-111)."""
    if len(samples) <= maxsamples:
        return samples
    keep = [samples[0], samples[-1]]
    rest = samples[1:-1]
    while len(keep) < maxsamples and rest:
        # pick the sample maximizing the min log-distance to kept ones
        def score(M):
            sz = math.log(M[0] * M[1] * M[2])
            return min(abs(sz - math.log(k[0] * k[1] * k[2])) for k in keep)

        best = max(rest, key=score)
        keep.append(best)
        rest.remove(best)
    return sorted(keep, key=lambda M: M[0] * M[1] * M[2])


def _apply_flops_per_elem(grid: FEGrid) -> int:
    """FLOPs for one operator apply on one element: 6 tensor contractions
    (3 EVAL + 3 TRANSPOSE), each three passes of 2*Q*P per point-line
    (tensor.c counts at tensor.c:58), plus the pointwise metric
    (pointwise.h:37, op-poisson1.c:98)."""
    P, Q = grid.ref.P, grid.ref.Q
    per_contraction = 2 * (Q * P * P * P + Q * Q * P * P + Q * Q * Q * P)
    pointwise = 15 * Q ** 3  # dv = K du (9 mul + 6 add per point)
    return 6 * per_contraction + pointwise


def fcycle_flops(grid: FEGrid, pre: int = 2, post: int = 3,
                 cg_iters: int = 20) -> int:
    """Analytic FLOP count for one FAS F-cycle from the ACTUAL cycle
    structure (no hard-coded cycle factor).

    Operator applies per level, counted from fas_fcycle/fas_vcycle: level
    l < bottom is entered by the V-cycles started at levels 0..l, i.e.
    (l+1) visits, each costing pre + post Chebyshev applies + 1 residual
    apply; the coarse FAS rhs adds 1 apply at level l+1 per visit of l.
    The bottom level runs Jacobi-CG (1 apply/iteration + 1 setup);
    ``cg_iters`` is an estimate of its (convergence-dependent, tiny-grid)
    trip count — bottom work is <1% of the total on sampler grids."""
    levels = [grid]
    while levels[-1].can_coarsen():
        levels.append(levels[-1].coarsen())
    bot = len(levels) - 1
    total = 0.0
    for lev, g in enumerate(levels):
        nelem = g.M[0] * g.M[1] * g.M[2]
        if lev < bot:
            visits = lev + 1
            applies = visits * (pre + post + 1)
            if lev > 0:  # coarse-side FAS apply charged by the finer level
                applies += lev  # = visits of level lev-1
        else:
            # entered once by the F-cycle restrict chain and once per
            # visiting V-cycle; each entry runs CG
            applies = (bot + 1) * (cg_iters + 1) + bot  # + FAS rhs applies
        total += applies * _apply_flops_per_elem(g) * nelem
    return int(total)


@dataclasses.dataclass
class SampleResult:
    M: Tuple[int, int, int]
    seconds: float
    gflops: float
    meq_per_s: float


def _timed(mesh, device: torch.device, fn) -> float:
    """Seconds of ``fn()`` (bench/driver.py:elapsed); with ``mesh``,
    started after a barrier and the slowest rank's."""
    if mesh is None:
        return elapsed(device, fn)
    import torch.distributed as dist

    dist.barrier()
    return slowest(elapsed(device, fn), mesh)


def sample_on_grid(op: FEOp, M, degree: int, dtype=torch.float32,
                   repeat: int = 3, mintime: float = 0.1,
                   chain: int = 20, device="cuda", mesh=None) -> SampleResult:
    """SampleOnGrid (sampler.c:114-240): build, warm up, run >= repeat
    timed measurements of ``chain`` data-dependent F-cycles, report the
    best. With ``mesh`` (parallel/mesh.py:make_mesh of the process group)
    each rank builds its blocks of the levels split over it
    (fe/fas.py:build_fe_levels) and every time is the slowest rank's."""
    device = torch.device(device)
    mmax = max(M)
    L = tuple(m / mmax for m in M)
    grid = FEGrid(M=tuple(M), degree=degree, L=L)
    levels = build_fe_levels(grid, op, dtype=dtype, device=device, mesh=mesh)
    f = op.forcing(levels[0].block, levels[0].coords, "sine")

    def chained():
        dep = torch.zeros((), dtype=f.dtype, device=device)
        for _ in range(chain):
            u = fas_fcycle(op, levels, 0, f + dep)
            dep = 0.0 * u[1, 1, 1]

    _timed(mesh, device, chained)  # warm up

    # Measure the bottom-CG trip count for THIS problem instead of
    # guessing it (the reference's GF comes from measured petsc_TotalFlops,
    # sampler.c:202-224; the analytic model needs the one
    # convergence-dependent count): restrict the forcing down the ladder
    # exactly as fas_fcycle does and count the zero-guess coarse solve.
    b = f
    for lev in range(len(levels) - 1):
        b = restrict_down(levels[lev], levels[lev + 1], b)
    Lb = levels[-1]
    _, cg_j, _ = cg_info(op, Lb, b, torch.zeros_like(b),
                         max_iters=bottom_iters(Lb.grid))
    cg_iters = max(cg_j, 1)

    best = float("inf")
    elapsed_total, runs = 0.0, 0
    while runs < repeat or elapsed_total < mintime:
        dt = _timed(mesh, device, chained) / chain
        best = min(best, dt)
        elapsed_total += dt * chain
        runs += 1
        if runs > 100:
            break
    eqs = grid.ndof
    # default pre/post match fas_fcycle defaults; cg_iters is measured above
    flops = fcycle_flops(grid, cg_iters=cg_iters)
    return SampleResult(M=tuple(M), seconds=best,
                        gflops=flops / best / 1e9,
                        meq_per_s=eqs / best / 1e6)


def run_sample(op: FEOp, degree: int = 2, local: Tuple[int, int] = (50, 10000),
               maxsamples: int = 8, repeat: int = 3, mintime: float = 0.1,
               dtype=torch.float32, n_devices: Optional[int] = None,
               verbose: bool = True, device="cuda",
               chain: int = 20) -> List[SampleResult]:
    """RunSample (sampler.c:242-292). ``n_devices`` (default: the ranks of
    the initialized process group, else 1) above 1 runs every sample on the
    ``make_mesh`` grid of the group, which must have that many ranks, and
    ``P[...]`` is the grid; on one device ``P[1 1 1]``. Only rank 0
    prints. ``chain``: F-cycles a timed chain."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    n_dev = n_devices or world
    mesh, procs = None, (1, 1, 1)
    if n_dev > 1:
        if n_dev != world:
            raise ValueError(
                f"run_sample(n_devices={n_dev}) needs a process group of {n_dev} ranks "
                f"(it has {world}): python -m hpgmg_tpu_torch.fe.cli sample -ranks "
                f"{n_dev}, or torchrun")
        from hpgmg_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(torch.device(device))
        procs = mesh.shape
        verbose = verbose and mesh.rank == 0
    samples = sample_grid_range(local[0], local[1], procs)
    samples = thin_samples(samples, maxsamples)
    if not samples:
        raise ValueError("no compatible sample sizes; widen -local")

    def emit(r):
        # print per sample, not in one trailing block, so a run cut short
        # keeps every completed measurement
        if verbose:
            print(f"Q{degree} G[{r.M[0]:5d}{r.M[1]:5d}{r.M[2]:5d}] "
                  f"P[{procs[0]:3d}{procs[1]:3d}{procs[2]:3d}] "
                  f"{r.seconds:10.6f} s {r.gflops:9.3f} GF "
                  f"{r.meq_per_s:9.3f} MEq/s", flush=True)

    if verbose:
        print(f"Small sample of size {samples[0]} (instant feedback)",
              flush=True)
    results = [sample_on_grid(op, samples[0], degree, dtype, 1, 0.0, chain,
                              device=device, mesh=mesh)]
    emit(results[0])
    if len(samples) > 1:
        if verbose:
            print(f"Large sample of size {samples[-1]} (memory + warmup)",
                  flush=True)
        sample_on_grid(op, samples[-1], degree, dtype, 1, 0.0, chain,
                       device=device, mesh=mesh)
    for M in samples[1:] if len(samples) > 1 else []:
        results.append(sample_on_grid(op, M, degree, dtype, repeat, mintime,
                                      chain, device=device, mesh=mesh))
        emit(results[-1])
    return results
