"""Rank bodies of the port's multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_parallel_slice.py).

Each test module spawns its gloo jobs at once (``spawn``): ranks start with the
``spawn`` method, join a group through a file in the test's temporary
directory (so parallel test workers never share a port), run one body on
the CPU, and save what the test compares to ``<tmp>/rank<r>.pt``. This
module imports torch and the port only: a rank never imports JAX.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SEED = 20261017


def spawn(jobs, timeout: float = 240.0):
    """Run each job (body, nprocs, tmp, *args), all at once: ``body(rank,
    nprocs, *args)`` in ``nprocs`` spawned ranks of a gloo group of its
    own; raise if a rank fails or the jobs outlive ``timeout`` seconds (a
    rank that skips a collective hangs the others). Returns each job's
    saved results, by rank."""
    ctxs = [mp.start_processes(_run, args=(nprocs, str(tmp), body, args),
                               nprocs=nprocs, start_method="spawn", join=False)
            for body, nprocs, tmp, *args in jobs]
    deadline = time.monotonic() + timeout
    try:
        for ctx in ctxs:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the gloo jobs outlived {timeout} s")
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    return [[torch.load(f"{tmp}/rank{r}.pt") for r in range(nprocs)]
            for _, nprocs, tmp, *_ in jobs]


def _run(rank: int, world: int, tmp: str, body, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init", rank=rank,
                            world_size=world)
    try:
        out = body(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{tmp}/rank{rank}.pt")


def global_field(n: int, seed: int = SEED) -> torch.Tensor:
    return torch.tensor(np.random.default_rng(seed).standard_normal((n, n, n)))


def slab_body(rank: int, world: int, n: int) -> dict:
    """Every slab set of this rank's block of ``global_field(n)`` on the
    2x2 grid and (ranks 0 and 1 only) on a 2x1 grid of the same ranks,
    plus the halo module's explicit exchange and operators, K8d's rhs ring,
    the gather and the mesh-aware reductions."""
    from hpgmg_tpu_torch.core import blas
    from hpgmg_tpu_torch.core.config import BC
    from hpgmg_tpu_torch.parallel import halo
    from hpgmg_tpu_torch.parallel import shard_kernels as SK
    from hpgmg_tpu_torch.parallel.mesh import Mesh, Part, gather, make_mesh_ij

    x = global_field(n)
    cpu = torch.device("cpu")
    meshes = {"2x2": make_mesh_ij(cpu)}
    if rank < 2:
        meshes["2x1"] = Mesh(shape=(2, 1, 1), rank=rank, backend="gloo", device=cpu)
    out = {}
    for grid, mesh in meshes.items():
        part = Part(mesh, (True, mesh.shape[1] > 1), n)
        xl = part.block(x)
        for bc in (BC.DIRICHLET, BC.PERIODIC):
            out[(grid, "fv4", bc.value)] = SK.slabs_for_kernel(xl, part, bc)
            for taps in ("p1", "v2", "27pt"):
                out[(grid, taps, bc.value)] = SK.slabs_for_kernel_r1(xl, part, bc, taps)
        out[(grid, "part")] = (part.oi, part.oj, part.ni, part.nj)
        out[(grid, "edges")] = SK.edge_flags(part)
    part = Part(meshes["2x2"], (True, True), n)
    xl = part.block(x)
    for bc in (BC.DIRICHLET, BC.PERIODIC):
        out[("exchange2", bc.value)] = halo.halo_exchange(part, xl, 2, bc)
        out[("poisson7", bc.value)] = halo.apply_poisson7_explicit(part, xl, 4.0, bc)
    out["jacobi"] = halo.jacobi_sweeps_explicit(part, xl, torch.ones_like(xl), 4.0, 3)
    out["rhs_ring"] = SK.r1_gsrb2_rhs_sharded(part, xl)
    out["gather"] = gather(xl, part)
    y = part.block(global_field(n, SEED + 1))
    out["dot"] = blas.dot(xl, y, part=part)
    out["norm"] = blas.norm(xl, part=part)
    out["mean"] = blas.mean(xl, part=part)
    return out


def fcycle_body(rank: int, world: int, n: int, cases) -> dict:
    """One F-cycle per case (op, bc, bottom, min_coarse_dim[, size]) of the
    benchmark problem at n^3 (size^3 where the case gives one) float64 on
    the make_mesh_ij grid of the group: the gathered u, rel_residual, which
    levels are decomposed, and the plain versions that ran."""
    from hpgmg_tpu_torch.bench.driver import build
    from hpgmg_tpu_torch.core.config import BC, BottomSolver, Smoother, SolverConfig
    from hpgmg_tpu_torch.kernels import counts
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.parallel.mesh import active_mesh, gather, make_mesh_ij
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    cpu = torch.device("cpu")
    mesh = make_mesh_ij(cpu)
    out = {"grid": mesh.shape}
    for case in cases:
        op, bc, bottom, mcd, *size = case
        cfg = SolverConfig(op=op, bc=BC(bc), a=0.0, b=1.0, smoother=Smoother.GSRB,
                           bottom=BottomSolver(bottom), min_coarse_dim=mcd,
                           dtype=torch.float64)
        hier, f = build(size[0] if size else n, cfg, cpu, mesh=mesh)
        counts.reset()
        with active_mesh(mesh):
            u, norm_r, norm_f = fmg_solve(get_suite(op), hier, f, cfg)
        part = hier.levels[0].part
        out[case] = dict(
            u=gather(u, part), rel=float(norm_r) / float(norm_f),
            decomposed=[lv.part is not None for lv in hier.levels],
            plain_calls={k: v for k, v in counts.read()[1].items() if v})
    return out
