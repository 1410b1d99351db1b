"""The decomposed F-cycle over a grid of ranks (counterpart of
hpgmg_tpu/bench/weak.py and of __graft_entry__.dryrun_multichip): a fixed
per-rank block, one process per rank, the fine levels decomposed over the
(sx, sy, 1) grid of ``make_mesh_ij``, the coarse ones replicated.

    python -m hpgmg_tpu_torch.bench.weak --ranks 4 --per-rank 256 \\
        [--backend nccl|gloo] [--op fv4] [--dtype float32] [--bc dirichlet] \\
        [--bottom direct|bicgstab] [--dynamic-range 3] [--check-serial] \\
        [--overlap] [--device cuda|cpu]

The global grid is per_rank * max(sx, sy) cells a side. The ranks start
with ``torch.multiprocessing`` (spawn), or from ``torchrun``'s environment
when it set one. ``--backend nccl`` (the default) puts each rank on its own
card and refuses more ranks than cards; ``--backend gloo`` lets the ranks
share one card (or the CPU), the halos staged through host memory, which
is slow: its times are not a multi-card number. The parent builds the
kernel library once before it spawns.

Each rank runs ``bench.driver.run_benchmark`` on its mesh (one warm-up
F-cycle, then timed chains, and with ``--dynamic-range 3`` the 2h and 4h
solves), then one more F-cycle with the launch counts reset before it and
read after it. ``--check-serial`` then solves the same problem on one rank
and compares u (max|u_ranks - u_one| / max|u_one|) and rel_residual.
Prints one JSON line: the keys of ``python -m hpgmg_tpu_torch.bench`` plus
``ranks``, ``grid``, ``backend``, ``launches`` (of that F-cycle), rank 0's
``slab_launches_by_block`` (its K8a and K8b launches in that F-cycle by
pass, mode and local block shape, and its K8d sweeps by block) and, with
``--check-serial``,
``serial_u_rel_diff`` and ``serial_rel_residual``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _config(op: str, dtype: str, bc: str, bottom: str):
    from hpgmg_tpu_torch.core.config import BC, BottomSolver, Smoother, SolverConfig

    return SolverConfig(op=op, bc=BC(bc), a=0.0, b=1.0, smoother=Smoother.GSRB,
                        bottom=BottomSolver(bottom), min_coarse_dim=8,
                        dtype=_DTYPES[dtype])


def _rank_main(rank: int, world: int, init: str, opts: dict, out: str):
    """One rank: join the group, run the benchmark and the counted F-cycle
    on its mesh, and (rank 0) write the result to ``out``."""
    import torch.distributed as dist

    from hpgmg_tpu_torch.bench.driver import build, device_name, run_benchmark
    from hpgmg_tpu_torch.kernels import counts, stencils
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.parallel import shard_kernels
    from hpgmg_tpu_torch.parallel.mesh import active_mesh, gather, make_mesh_ij
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    backend = opts["backend"]
    if opts["device"] == "cuda":
        device = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(opts.get("threads", 1))
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    try:
        shard_kernels.OVERLAP = opts["overlap"]
        mesh = make_mesh_ij(device)
        n = opts["per_rank"] * max(mesh.shape[:2])
        cfg = _config(opts["op"], opts["dtype"], opts["bc"], opts["bottom"])
        op = get_suite(cfg.op)
        t0 = time.perf_counter()
        res = run_benchmark(n, cfg, device, min_solve_seconds=opts["min_seconds"],
                            max_solves=opts["max_solves"],
                            dynamic_range=opts["dynamic_range"], verbose=False,
                            mesh=mesh)
        hier, f = build(n, cfg, device, mesh=mesh)
        counts.reset()
        stencils.slab_launches_by_block.clear()
        with active_mesh(mesh):
            u, norm_r, norm_f = fmg_solve(op, hier, f, cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches, plain_calls = counts.read()
        u_full = gather(u, hier.levels[0].part) if hier.levels[0].part else u
        wall = time.perf_counter() - t0
        result = {"n": n, "grid": list(mesh.shape), "res": res.__dict__,
                  "launches": launches, "plain_calls": plain_calls,
                  "slab_launches_by_block": dict(stencils.slab_launches_by_block),
                  "counted_rel_residual": float(norm_r) / float(norm_f),
                  "device": device_name(device), "wall_seconds": wall}
        del hier, f, u
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return
    if opts["check_serial"]:
        hier1, f1 = build(n, cfg, device)
        u1, nr1, nf1 = fmg_solve(op, hier1, f1, cfg)
        diff = float((u_full - u1).abs().max() / u1.abs().max())
        result.update(serial_u_rel_diff=diff,
                      serial_rel_residual=float(nr1) / float(nf1))
    Path(out).write_text(json.dumps(result))


def run_weak(per_rank: int, ranks: int, op: str = "fv4", dtype: str = "float32",
             reps: int = 1, backend: str = "nccl", bc: str = "dirichlet",
             bottom: str = "direct", dynamic_range: int = 3,
             check_serial: bool = False, overlap: bool = False,
             device: str = "cuda", min_seconds: float = 0.0,
             timeout: float = 1800.0) -> dict:
    """Spawn ``ranks`` processes, run the decomposed F-cycle benchmark with
    ``per_rank`` cells a side per rank (timed chain: at most ``reps``
    solves beyond the calibration, sized by ``min_seconds``), and return
    rank 0's result. A rank that fails, or a job that outlives ``timeout``
    seconds, raises."""
    import torch.multiprocessing as mp

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: use --device cpu")
        if backend == "nccl" and ranks > torch.cuda.device_count():
            raise ValueError(f"nccl puts one rank on each card: {ranks} ranks, "
                             f"{torch.cuda.device_count()} cards (use --backend gloo)")
        from hpgmg_tpu_torch.kernels import build

        build.build()
    elif backend == "nccl":
        raise ValueError("nccl needs CUDA devices; use --backend gloo on the CPU")
    opts = dict(per_rank=per_rank, op=op, dtype=dtype, bc=bc, bottom=bottom,
                backend=backend, dynamic_range=dynamic_range, min_seconds=min_seconds,
                max_solves=max(1, reps), check_serial=check_serial, overlap=overlap,
                device=device)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        ctx = mp.start_processes(_rank_main,
                                 args=(ranks, f"file://{tmp}/init", opts, out),
                                 nprocs=ranks, start_method="spawn", join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {ranks}-rank job outlived {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        result = json.loads(Path(out).read_text())
    result.update(ranks=ranks, backend=backend)
    return result


def _torchrun_main(opts: dict):
    """A rank started by torchrun: its rank and world size from the
    environment; rank 0 prints the result."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        _rank_main(rank, world, "env://", opts, out)
        if rank == 0:
            return dict(json.loads(Path(out).read_text()), ranks=world,
                        backend=opts["backend"])
    return None


def summary(r: dict, op: str, dtype: str, bottom: str, bc: str) -> dict:
    """The JSON line: the keys of ``python -m hpgmg_tpu_torch.bench``,
    plus the grid, the backend and the launches of the counted F-cycle."""
    res = r["res"]
    out = {"metric": f"{op}{'_periodic' if bc == 'periodic' else ''}"
                     f"_fcycle_dof_per_s_n{r['n']}_ranks{r['ranks']}",
           "value": res["dof_per_second"], "unit": "DOF/s", "n": r["n"],
           "dtype": dtype, "smoother": "gsrb", "bottom": bottom,
           "rel_residual": res["rel_residual"],
           "seconds_per_solve": res["seconds_per_solve"],
           "richardson_order": res["richardson_order"], "device": r["device"],
           "ranks": r["ranks"], "grid": r["grid"], "backend": r["backend"],
           "launches": {k: v for k, v in r["launches"].items() if v},
           "wall_seconds": r["wall_seconds"]}
    for key in ("serial_u_rel_diff", "serial_rel_residual"):
        if key in r:
            out[key] = r[key]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hpgmg_tpu_torch.bench.weak")
    ap.add_argument("--per-rank", type=int, default=64,
                    help="cells a side of each rank's block at the finest level")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    ap.add_argument("--op", choices=["fv4", "fv7pt", "fv2", "27pt"], default="fv4")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    ap.add_argument("--bc", choices=["dirichlet", "periodic"], default="dirichlet")
    ap.add_argument("--bottom", choices=["direct", "bicgstab"], default="direct")
    ap.add_argument("--dynamic-range", type=int, default=3)
    ap.add_argument("--reps", type=int, default=1,
                    help="most timed solves after the calibration")
    ap.add_argument("--check-serial", action="store_true")
    ap.add_argument("--overlap", action="store_true",
                    help="K8b's interior/edge split (shard_kernels.OVERLAP)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds the spawned ranks may take before they are killed")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device available (use --device cpu)", file=sys.stderr)
        return 1
    print(f"backend {args.backend}: "
          + ("one card per rank (NCCL)" if args.backend == "nccl" else
             f"{args.ranks} processes sharing "
             + ("one GPU, gloo, host-staged halos" if args.device == "cuda"
                else "the CPU, gloo")), file=sys.stderr)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        opts = dict(per_rank=args.per_rank, op=args.op, dtype=args.dtype, bc=args.bc,
                    bottom=args.bottom, backend=args.backend,
                    dynamic_range=args.dynamic_range, min_seconds=0.0,
                    max_solves=args.reps, check_serial=args.check_serial,
                    overlap=args.overlap, device=args.device)
        r = _torchrun_main(opts)
        if r is None:
            return 0
    else:
        r = run_weak(args.per_rank, args.ranks, args.op, args.dtype, args.reps,
                     args.backend, args.bc, args.bottom, args.dynamic_range,
                     args.check_serial, args.overlap, args.device, timeout=args.timeout)
    print(json.dumps(summary(r, args.op, args.dtype, args.bottom, args.bc)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
