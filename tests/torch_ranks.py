"""Rank bodies of the port's multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_parallel_slice.py, the
3D grid's and the FE path's: tests/test_torch_mesh3d.py,
tests/test_torch_fe_sharded.py, tests/test_torch_fe_mesh.py,
tests/test_torch_fe_cli.py; bfloat16 on the grids:
tests/test_torch_bf16_mesh.py, tests/test_torch_bf16_mesh3d.py).

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
    return start(jobs, timeout)()


def start(jobs, timeout: float = 240.0):
    """``spawn``'s jobs, started; returns the call that waits for them and
    returns their results (so that the caller may compute while the ranks
    run)."""
    ctxs = [mp.start_processes(_run, args=(nprocs, str(tmp), body, args),
                               nprocs=nprocs, start_method="spawn", join=False)
            for body, nprocs, tmp, *args in jobs]
    deadline = time.monotonic() + timeout

    def finish():
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
    return finish


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


def grid_mesh(kind: str, device):
    """This rank's Mesh of the group by ``kind``: "ij" (make_mesh_ij), "3d"
    (make_mesh) or "pod<s>" (make_pod_mesh with s emulated slices)."""
    from hpgmg_tpu_torch.parallel.mesh import make_mesh, make_mesh_ij, make_pod_mesh

    if kind == "ij":
        return make_mesh_ij(device)
    if kind == "3d":
        return make_mesh(device)
    return make_pod_mesh(int(kind[3:]), device)


def slab3_body(rank: int, world: int, n: int) -> dict:
    """On the (2, 2, 2) grid of ``make_mesh``: every slab set of this
    rank's block of ``global_field(n)`` (K8a's and K8c's, Dirichlet and
    periodic: six slabs a set), the halo module's explicit exchange, K8d's
    rhs ring, the gather and the mesh-aware reductions."""
    from hpgmg_tpu_torch.core import blas
    from hpgmg_tpu_torch.core.config import BC
    from hpgmg_tpu_torch.parallel import halo
    from hpgmg_tpu_torch.parallel import shard_kernels as SK
    from hpgmg_tpu_torch.parallel.mesh import Part, gather, make_mesh

    x = global_field(n)
    mesh = make_mesh(torch.device("cpu"))
    part = Part(mesh, (True, True, True), n)
    xl = part.block(x)
    out = {"grid": mesh.shape, "coords": mesh.coords,
           "part": part.offsets + part.extents, "edges": SK.edge_flags(part)}
    for bc in (BC.DIRICHLET, BC.PERIODIC):
        out[("fv4", bc.value)] = SK.slabs_for_kernel(xl, part, bc)
        for taps in ("p1", "v2", "27pt"):
            out[(taps, bc.value)] = SK.slabs_for_kernel_r1(xl, part, bc, taps)
        out[("exchange2", bc.value)] = halo.halo_exchange(part, xl, 2, bc)
    out["slabs2"] = SK.slabs2_for_kernel_r1(xl, part, "p1")
    out["rhs_ring"] = SK.r1_gsrb2_rhs_sharded(part, xl)
    out["gather"] = gather(xl, part)
    y = part.block(global_field(n, SEED + 1))
    out["dot"] = blas.dot(xl, y, part=part)
    out["norm"] = blas.norm(xl, part=part)
    out["mean"] = blas.mean(xl, part=part)
    return out


def solve_body(rank: int, world: int, grid: str, cases) -> dict:
    """Each case (driver, op, bc, smoother, bottom, min_coarse_dim, n, a)
    of the benchmark problem at n^3 float64 (b = 1; Helmholtz where a is
    not 0) on the ``grid_mesh(grid)`` of the group, through the driver:
    "fcycle" (fmg_solve), "timed" (fmg_solve with timers, and the untimed
    u), "vcycles" (mg_solve_fixed, 3 cycles), "mgpcg" (4 iterations) or
    "fmg2" (fmg_solve2). Saves the gathered u, the relative residual (or
    history), how each level is split (None: replicated), and the plain
    versions that ran."""
    from hpgmg_tpu_torch.bench.driver import build
    from hpgmg_tpu_torch.core.config import BC, BottomSolver, Smoother, SolverConfig
    from hpgmg_tpu_torch.kernels import counts
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.parallel.mesh import active_mesh, gather
    from hpgmg_tpu_torch.solve import mg

    cpu = torch.device("cpu")
    mesh = grid_mesh(grid, cpu)
    out = {"grid": mesh.shape, "coords": mesh.coords}
    for case in cases:
        driver, op, bc, smoother, bottom, mcd, n, a = case
        cfg = SolverConfig(op=op, bc=BC(bc), a=a, b=1.0, helmholtz=a != 0.0,
                           smoother=Smoother(smoother), bottom=BottomSolver(bottom),
                           min_coarse_dim=mcd, dtype=torch.float64)
        hier, f = build(n, cfg, cpu, mesh=mesh)
        suite = get_suite(op)
        part = hier.levels[0].part
        counts.reset()
        res = {}
        with active_mesh(mesh):
            if driver in ("fcycle", "timed"):
                timers = {} if driver == "timed" else None
                u, norm_r, norm_f = mg.fmg_solve(suite, hier, f, cfg, timers=timers)
                res["rel"] = float(norm_r) / float(norm_f)
                if timers is not None:
                    res["phases"] = sorted({name for _, name in timers})
                    u0, _, _ = mg.fmg_solve(suite, hier, f, cfg)
                    res["untimed_u"] = gather(u0, part) if part is not None else u0
            elif driver == "vcycles":
                u, rels = mg.mg_solve_fixed(suite, hier, f, cfg, num_cycles=3)
                res["rel"] = rels.tolist()
            elif driver == "mgpcg":
                u, res["rel"] = mg.mgpcg(suite, hier, f, cfg, max_iters=4)
            else:
                u, res["rel"] = mg.fmg_solve2(suite, hier, f, cfg, max_fcycles=2)
        res.update(u=gather(u, part) if part is not None else u,
                   split=[None if lv.part is None else lv.part.axes for lv in hier.levels],
                   plain_calls={k: v for k, v in counts.read()[1].items() if v})
        out[case] = res
    return out


def mesh3d_body(rank: int, world: int, n: int, cases) -> dict:
    """``slab3_body`` and ``solve_body`` on the ``make_mesh`` grid."""
    return {"slabs": slab3_body(rank, world, n), **solve_body(rank, world, "3d", cases)}


def fe_solve_body(rank: int, world: int, cases) -> dict:
    """Each FE case (op, M, L, cycles, build) float64 on the ``make_mesh``
    grid of the group: the levels split by fe/mesh.py, built on the blocks
    (build "blocks") or built whole and cut (build "cut",
    ``shard_fe_levels``), the sine forcing, one F-cycle and ``cycles``
    V-cycles. Saves the gathered u after each cycle, each level's split
    (None: replicated) and the fine level's metric shape."""
    from hpgmg_tpu_torch.fe.fas import build_fe_levels, fas_fcycle, fas_vcycle
    from hpgmg_tpu_torch.fe.grid import FEGrid
    from hpgmg_tpu_torch.fe.mesh import gather_fe_field, shard_fe_field, shard_fe_levels
    from hpgmg_tpu_torch.fe.op import get_fe_op
    from hpgmg_tpu_torch.parallel.mesh import make_mesh

    cpu = torch.device("cpu")
    mesh = make_mesh(cpu)
    out = {"grid": mesh.shape, "coords": mesh.coords}
    for case in cases:
        name, M, L, cycles, build = case
        op = get_fe_op(name)
        grid = FEGrid(M=tuple(M), degree=op.degree, L=tuple(L))
        if build == "blocks":
            levels = build_fe_levels(grid, op, torch.float64, device=cpu, mesh=mesh)
            f = op.forcing(levels[0].block, levels[0].coords, "sine")
        else:
            whole = build_fe_levels(grid, op, torch.float64, device=cpu)
            f = shard_fe_field(mesh, whole[0], op.forcing(whole[0].grid, whole[0].coords, "sine"))
            levels = shard_fe_levels(mesh, whole)
        part = levels[0].part
        u = fas_fcycle(op, levels, 0, f)
        us = [gather_fe_field(part, u)]
        for _ in range(cycles):
            u = fas_vcycle(op, levels, 0, f, u)
            us.append(gather_fe_field(part, u))
        out[case] = dict(u=us, split=[None if lv.part is None else lv.part.split
                                      for lv in levels],
                         metric_a=tuple(levels[0].metric_a.shape))
    return out


def fe_ops_body(rank: int, world: int, cases) -> dict:
    """For each (op, M) on the ``make_mesh`` grid, float64, the levels
    built on the blocks: every level's placement (split, node offsets and
    extents; None where replicated), coords, dinv and the forcing, and on
    random whole-level fields cut to the blocks (``global_field``-like,
    seeded by the level): the operator, assemble_interior of an element
    field, the owned node sum of a product, and each level pair's
    restrict, interpolate and inject."""
    from hpgmg_tpu_torch.fe.fas import build_fe_levels
    from hpgmg_tpu_torch.fe.grid import FEGrid
    from hpgmg_tpu_torch.fe.op import get_fe_op
    from hpgmg_tpu_torch.parallel.mesh import make_mesh

    cpu = torch.device("cpu")
    mesh = make_mesh(cpu)
    out = {"grid": mesh.shape}
    for case in cases:
        name, M = case
        op = get_fe_op(name)
        levels = build_fe_levels(FEGrid(M=tuple(M), degree=op.degree), op, torch.float64,
                                 device=cpu, mesh=mesh)
        res = {"levels": []}
        for lev, lv in enumerate(levels):
            g, part = lv.block, lv.part

            def cut(x, part=part):
                return x if part is None else part.cut(x)

            x = torch.tensor(fe_field(lv.grid.nodes, lev))
            y = torch.tensor(fe_field(lv.grid.nodes, lev + 100))
            E = torch.tensor(fe_field((op.degree + 1,) * 3 + tuple(lv.grid.M), lev + 200))
            Eb = E if part is None else part.cut_elements(E)
            row = dict(place=None if part is None else (part.split, part.node_offsets,
                                                        part.nodes),
                       coords=lv.coords, dinv=lv.dinv,
                       forcing=op.forcing(g, lv.coords, "sine"),
                       apply=op.apply(g, lv.coords, cut(x), metric=(lv.metric_a, lv.metric_w)),
                       assemble=g.assemble_interior(Eb.contiguous()),
                       dot=g.node_sum(cut(x) * cut(y)))
            if lev + 1 < len(levels):
                lc = levels[lev + 1]
                gc = lc.block
                xc = torch.tensor(fe_field(lc.grid.nodes, lev + 300))
                row.update(restrict=g.restrict(gc, cut(x)),
                           interpolate=g.interpolate(gc, xc if lc.part is None
                                                     else lc.part.cut(xc)),
                           inject=g.inject(cut(x), gc).clone())
            res["levels"].append(row)
        out[case] = res
    return out


def fe_field(shape, seed: int) -> np.ndarray:
    """A random float64 field of ``shape`` from ``SEED + seed``."""
    return np.random.default_rng(SEED + seed).standard_normal(tuple(shape))


def fe_sample_body(rank: int, world: int, local, maxsamples: int) -> dict:
    """fe/sampler.py:run_sample of Q2 float64 on the group's ranks (chains
    of 2 F-cycles, one repeat): what this rank printed and its results."""
    import io
    from contextlib import redirect_stdout

    from hpgmg_tpu_torch.fe.op import get_fe_op
    from hpgmg_tpu_torch.fe.sampler import run_sample

    buf = io.StringIO()
    with redirect_stdout(buf):
        res = run_sample(get_fe_op("poisson2"), 2, tuple(local), maxsamples, repeat=1,
                         mintime=0.0, dtype=torch.float64, device="cpu", chain=2)
    return {"text": buf.getvalue(), "samples": [(r.M, r.seconds, r.gflops, r.meq_per_s)
                                                for r in res]}


# the whole-level plain versions of the suites' stencils and fused sweeps:
# on a decomposed level only the slab kernels' plain versions may run
WHOLE_LEVEL_PLAINS = (("stencils", "fv4_stencil_plain"), ("stencils", "fv4_subtile_plain"),
                      ("stencils", "fv4_gsrb2_plain"), ("stencils_r1", "r1_stencil_plain"),
                      ("stencils_r1", "r1_gsrb2_plain"))


def _whole_level_dims(dims: dict):
    """Wrap the whole-level plain versions (WHOLE_LEVEL_PLAINS) so that each
    call adds its level's dim to ``dims[name]``; returns the undo."""
    import importlib

    saved = []
    for mod, name in WHOLE_LEVEL_PLAINS:
        module = importlib.import_module(f"hpgmg_tpu_torch.kernels.{mod}")
        fn = getattr(module, name)

        def wrapped(level, *a, _fn=fn, _name=name, **k):
            dims.setdefault(_name, set()).add(level.dim)
            return _fn(level, *a, **k)
        wrapped.calls = fn.calls
        saved.append((module, name, fn))
        setattr(module, name, wrapped)

    def undo():
        for module, name, fn in saved:
            setattr(module, name, fn)
    return undo


def bf16_field(n: int, seed: int) -> torch.Tensor:
    """A seeded n^3 bfloat16 field (numpy's normal draws, rounded once)."""
    return torch.tensor(np.random.default_rng(seed).standard_normal((n, n, n)),
                        dtype=torch.float32).to(torch.bfloat16)


def _bf16_cfg(op: str, bc: str, mcd: int):
    from hpgmg_tpu_torch.core.config import BC, BottomSolver, SolverConfig

    return SolverConfig(op=op, bc=BC(bc), a=0.0, b=1.0, dtype=torch.bfloat16,
                        bottom=BottomSolver.BICGSTAB, min_coarse_dim=mcd)


def bf16_slab_outputs(mesh, op: str, bc: str, levels, seed: int) -> dict:
    """Each slab kernel's plain version on this rank's block of the carried
    one-level bf16 hierarchy ``levels`` (the suite's finest level) and of
    ``bf16_field`` x and rhs, its slabs from the exchange: K8a's modes and,
    where its split takes the block, K8b's two passes (fv4); K8c's modes
    and, on Dirichlet levels of the var7 body, K8d's sweep (the radius-1
    suites). Returns the block's offsets and each output by
    (kernel, mode[, parity])."""
    from hpgmg_tpu_torch.interop import hierarchy_from_numpy
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.parallel import shard_kernels as SK
    from hpgmg_tpu_torch.parallel.mesh import shard_hierarchy

    cfg = _bf16_cfg(op, bc, levels[0]["dim"])
    lv = shard_hierarchy(mesh, hierarchy_from_numpy(levels, cfg, "cpu"), cfg).levels[0]
    part = lv.part
    n = lv.dim
    x, rhs = (part.block(bf16_field(n, seed + d)) for d in (0, 1))
    out = {"offsets": part.offsets, "extents": part.extents, "dtype": lv.beta_i.dtype}
    gsrb = [("gsrb", p, {"rhs": rhs, "kdinv": lv.kdinv[p]}) for p in (0, 1)]
    if op == "fv4":
        slabs = SK.slabs_for_kernel(x, part, cfg.bc)
        for mode, p, kw in [("apply", None, {}), ("residual", None, {"rhs": rhs})] + gsrb:
            out[("K8a", mode, p)] = S.fv4_slab_plain(lv, x, slabs, cfg, mode, **kw)
            ksplit = len(slabs) == 6
            if S.overlap_grid_shape(*part.extents[:2], part.extents[2] if ksplit else None):
                inner = S.fv4_overlap_interior_plain(lv, x, cfg, mode, ksplit=ksplit, **kw)
                out[("K8b", mode, p)] = S.fv4_overlap_edge_plain(lv, x, slabs, cfg, mode,
                                                                 inner, **kw)
        return out
    suite = get_suite(op)
    slabs = SK.slabs_for_kernel_r1(x, part, cfg.bc, suite.taps_key)
    for mode, p, kw in ([("apply", None, {}), ("residual", None, {"rhs": rhs})] + gsrb
                        + [("fres", None, {"rhs": rhs})]):
        out[("K8c", mode, p)] = K.r1_slab_plain(lv, x, slabs, cfg, mode, suite.taps_key,
                                                suite.var7, **kw)
    if lv.ring is not None:
        out[("K8d", "sweep", None)] = K.r1_gsrb2_slab_plain(
            lv, x, SK.slabs2_for_kernel_r1(x, part, suite.taps_key), SK.edge_flags(part),
            SK.r1_gsrb2_rhs_sharded(part, rhs), cfg, suite.taps_key, suite.var7)
    return out


def bf16_grid_body(rank: int, world: int, grid: str, slab_sets, fcycles) -> dict:
    """On the ``grid_mesh(grid)`` of the group, in bfloat16: each slab set
    (label, op, bc, levels, seed) through ``bf16_slab_outputs``, and each
    F-cycle (case, levels, f): case (op, bc, n, min_coarse_dim), the carried
    bf16 hierarchy ``levels`` and rhs ``f`` (float32 arrays holding bf16
    values) cut by shard_hierarchy, one F-cycle over the BiCGStab bottom.
    Saves each F-cycle's gathered u, relative residual, each level's split
    (None: replicated), the slab plain versions' calls and the dims of the
    levels a whole-level stencil's plain version ran on."""
    from hpgmg_tpu_torch.interop import hierarchy_from_numpy
    from hpgmg_tpu_torch.kernels import counts
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.parallel.mesh import active_mesh, gather, shard_array, shard_hierarchy
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    mesh = grid_mesh(grid, torch.device("cpu"))
    out = {"grid": mesh.shape, "coords": mesh.coords}
    for label, op, bc, levels, seed in slab_sets:
        out[("slabs", label)] = bf16_slab_outputs(mesh, op, bc, levels, seed)
    for case, levels, f in fcycles:
        op, bc, n, mcd = case
        cfg = _bf16_cfg(op, bc, mcd)
        hier = shard_hierarchy(mesh, hierarchy_from_numpy(levels, cfg, "cpu"), cfg)
        fb = shard_array(mesh, torch.tensor(f).to(torch.bfloat16))
        part = hier.levels[0].part
        dims = {}
        undo = _whole_level_dims(dims)
        counts.reset()
        try:
            with active_mesh(mesh):
                u, nr, nf = fmg_solve(get_suite(op), hier, fb, cfg)
        finally:
            undo()
        out[case] = dict(u=gather(u, part) if part is not None else u,
                         rel=float(nr) / float(nf),
                         split=[None if lv.part is None else lv.part.axes for lv in hier.levels],
                         plain_calls={k: v for k, v in counts.read()[1].items() if v},
                         whole_level_dims={k: sorted(v) for k, v in dims.items()})
    return out


def launched_body(device: torch.device, fail_rank: int) -> dict:
    """A body for parallel/launch.py:spawn_ranks: prints a line on rank 0,
    raises on ``fail_rank`` (-1: none), returns the rank and its device."""
    rank = dist.get_rank()
    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} fails")
    print(f"rank {rank} of {dist.get_world_size()} on {device}")
    return {"rank": rank, "device": str(device)}
