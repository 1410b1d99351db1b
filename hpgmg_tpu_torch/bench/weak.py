"""The decomposed F-cycle over a grid of ranks (counterpart of
hpgmg_tpu/bench/weak.py and of __graft_entry__.dryrun_multichip): a fixed
per-rank block, one process per rank, the fine levels decomposed over the
(sx, sy, sz) grid of ``make_mesh`` (hpgmg_tpu/bench/weak.py:37: on 4 ranks
(2, 2, 1), on 8 (2, 2, 2)), the coarse ones replicated.

    python -m hpgmg_tpu_torch.bench.weak --ranks 1 4 --per-rank 256 \\
        [--backend nccl|gloo] [--op fv4] [--dtype float32] [--bc dirichlet] \\
        [--bottom direct|bicgstab] [--dynamic-range 3] [--check-serial] \\
        [--overlap] [--device cuda|cpu] [--trace DIR]

The global grid is per_rank * max(sx, sy, sz) cells a side. The ranks start
through parallel/launch.py: ``spawn_ranks``, or ``torchrun_rank`` when
torchrun set the environment. ``--backend nccl`` (the default) puts each
rank on its own card and refuses more ranks than cards; ``--backend gloo``
lets the ranks share one card (or the CPU), the halos staged through host
memory, which is slow: its times are not a multi-card number. The parent builds the
kernel library once before it spawns.

Each rank runs ``bench.driver.run_benchmark`` on its mesh (one warm-up
F-cycle, then timed chains, and with ``--dynamic-range 3`` the 2h and 4h
solves), then one more F-cycle with the launch counts reset before it and
read after it. ``--check-serial`` then solves the same problem on one rank
and compares u (max|u_ranks - u_one| / max|u_one|) and rel_residual.
``--ranks`` takes a list of rank counts and runs one job per count (the
JAX ``main``'s ``--devices`` sweep, hpgmg_tpu/bench/weak.py:70-93). For each
count it prints the JAX line

    devices=N mesh=(sx, sy, sz) n=... ms/solve DOF/s weak-eff=t1/tN serial-eff=min(N*t1/tN, 1)

(t1 the first count's seconds a solve; ranks sharing one card, or the
CPU, run one after another, so serial-eff, not weak-eff, is what such a
run says about the distribution layer), then its JSON line, the last line
of its output. ``--trace DIR`` has each rank run, after the benchmark, one
more chain of ``--reps`` solves inside ``utils.profiler.trace(DIR/rank{r})``
(the chain in a ``weak.chain`` range); the JSON line then holds rank 0's
``trace``: the chain's wall ms and the shares of it spent in the process
group's communication, in kernels, and in neither, and of neither the
host's wait in CUDA copies and syncs (``utils.profiler.wall_shares``).

Each JSON line has the keys of ``python -m hpgmg_tpu_torch.bench`` plus
``ranks``, ``grid``, ``backend``, ``launches`` (of that F-cycle), rank 0's
``slab_launches_by_block`` (its K8a, K8b and K8c launches in that F-cycle
by pass, mode and local block shape, and its K8d sweeps by block, keyed
apart on blocks split along k) and, with
``--check-serial``,
``serial_u_rel_diff`` and ``serial_rel_residual``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _config(op: str, dtype: str, bc: str, bottom: str):
    from hpgmg_tpu_torch.core.config import BC, BottomSolver, Smoother, SolverConfig

    return SolverConfig(op=op, bc=BC(bc), a=0.0, b=1.0, smoother=Smoother.GSRB,
                        bottom=BottomSolver(bottom), min_coarse_dim=8,
                        dtype=_DTYPES[dtype])


def _weak_rank(device: torch.device, opts: dict) -> dict:
    """One rank of the group: run the benchmark and the counted F-cycle
    on its mesh; rank 0's result (with ``check_serial``, beside the
    one-rank solve of the same problem, run after the decomposed one)."""
    import torch.distributed as dist

    from hpgmg_tpu_torch.bench.driver import build, device_name, run_benchmark
    from hpgmg_tpu_torch.kernels import counts, stencils
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.parallel import shard_kernels
    from hpgmg_tpu_torch.parallel.mesh import active_mesh, gather, make_mesh
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    shard_kernels.OVERLAP = opts["overlap"]
    mesh = make_mesh(device)
    n = opts["per_rank"] * max(mesh.shape)
    cfg = _config(opts["op"], opts["dtype"], opts["bc"], opts["bottom"])
    op = get_suite(cfg.op)
    t0 = time.perf_counter()
    res = run_benchmark(n, cfg, device, min_solve_seconds=opts["min_seconds"],
                        max_solves=opts["max_solves"],
                        dynamic_range=opts["dynamic_range"], verbose=False,
                        mesh=mesh)
    hier, f = build(n, cfg, device, mesh=mesh)
    traced = None
    if opts.get("trace"):
        traced = _traced_chain(op, hier, f, cfg, mesh, opts["max_solves"],
                               os.path.join(opts["trace"], f"rank{mesh.rank}"))
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
              "device": device_name(device), "wall_seconds": wall,
              "ranks": dist.get_world_size(), "backend": opts["backend"]}
    if traced is not None:
        result["trace"] = traced
    del hier, f, u
    if mesh.rank == 0 and opts["check_serial"]:
        hier1, f1 = build(n, cfg, device)
        u1, nr1, nf1 = fmg_solve(op, hier1, f1, cfg)
        diff = float((u_full - u1).abs().max() / u1.abs().max())
        result.update(serial_u_rel_diff=diff,
                      serial_rel_residual=float(nr1) / float(nf1))
    return result


def _traced_chain(op, hier, f, cfg, mesh, solves: int, log_dir: str) -> dict:
    """``solves`` data-dependent F-cycles (bench/driver.py's chain) inside
    ``utils.profiler.trace(log_dir)``, in a ``weak.chain`` range; returns
    the trace's directory and the chain's wall shares."""
    from hpgmg_tpu_torch.parallel.mesh import active_mesh
    from hpgmg_tpu_torch.solve.mg import fmg_solve
    from hpgmg_tpu_torch.utils.profiler import read_trace, scope, trace, wall_shares

    with trace(log_dir), active_mesh(mesh), scope("weak.chain"):
        dep = torch.zeros((), dtype=f.dtype, device=f.device)
        for _ in range(solves):
            _, nr, _ = fmg_solve(op, hier, f + dep, cfg)
            dep = 0.0 * nr
        if f.device.type == "cuda":
            torch.cuda.synchronize(f.device)
    return dict(dir=log_dir, solves=solves,
                **wall_shares(read_trace(log_dir), "weak.chain"))


def run_weak(per_rank: int, ranks: int, op: str = "fv4", dtype: str = "float32",
             reps: int = 1, backend: str = "nccl", bc: str = "dirichlet",
             bottom: str = "direct", dynamic_range: int = 3,
             check_serial: bool = False, overlap: bool = False,
             device: str = "cuda", min_seconds: float = 0.0,
             timeout: float = 1800.0, trace=None) -> dict:
    """Spawn ``ranks`` processes (parallel/launch.py:spawn_ranks), run the
    decomposed F-cycle benchmark with ``per_rank`` cells a side per rank
    (timed chain: at most ``reps`` solves beyond the calibration, sized by
    ``min_seconds``), and return rank 0's result; with ``trace`` (a
    directory) each rank also runs a traced chain of ``reps`` solves
    (``_traced_chain``). A rank that fails, or a job that outlives
    ``timeout`` seconds, raises."""
    from hpgmg_tpu_torch.parallel.launch import spawn_ranks

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: use --device cpu")
        from hpgmg_tpu_torch.kernels import build

        build.build()
    return spawn_ranks(ranks, backend, device, _weak_rank,
                       (_opts(per_rank, op, dtype, max(1, reps), backend, bc, bottom,
                              dynamic_range, check_serial, overlap, min_seconds, trace),),
                       timeout=timeout)


def _opts(per_rank, op, dtype, max_solves, backend, bc, bottom, dynamic_range,
          check_serial, overlap, min_seconds, trace) -> dict:
    return dict(per_rank=per_rank, op=op, dtype=dtype, bc=bc, bottom=bottom,
                backend=backend, dynamic_range=dynamic_range, min_seconds=min_seconds,
                max_solves=max_solves, check_serial=check_serial, overlap=overlap,
                trace=trace)


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
    for key in ("serial_u_rel_diff", "serial_rel_residual", "trace"):
        if key in r:
            out[key] = r[key]
    return out


def jax_line(r: dict, base_seconds: float) -> str:
    """The JAX sweep's line for a result of ``run_weak``
    (hpgmg_tpu/bench/weak.py:84-93): weak-eff is the wall-clock efficiency
    against the first count's seconds a solve, serial-eff the efficiency
    against the serialized ideal ranks * t1 (ranks that share one device
    run one after another, so it isolates the distribution layer's cost:
    halos, collectives, redistribution)."""
    res = r["res"]
    seconds, ranks = res["seconds_per_solve"], r["ranks"]
    weak_eff = base_seconds / seconds
    serial_eff = ranks * base_seconds / seconds
    return (f"devices={ranks:3d} mesh={tuple(r['grid'])} n={r['n']:4d} "
            f"{seconds * 1e3:8.2f} ms/solve {res['dof_per_second']:.3e} DOF/s "
            f"weak-eff={weak_eff:5.2f} serial-eff={min(serial_eff, 1.0):5.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hpgmg_tpu_torch.bench.weak")
    ap.add_argument("--per-rank", type=int, default=64,
                    help="cells a side of each rank's block at the finest level")
    ap.add_argument("--ranks", type=int, nargs="+", default=[4],
                    help="rank counts to sweep, one job each")
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
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="trace a chain of --reps solves on each rank into DIR/rank{r}")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device available (use --device cpu)", file=sys.stderr)
        return 1

    def report(r: dict, base_seconds: float):
        print(jax_line(r, base_seconds))
        print(json.dumps(summary(r, args.op, args.dtype, args.bottom, args.bc)), flush=True)

    from hpgmg_tpu_torch.parallel.launch import torchrun_rank, under_torchrun

    trace = None if args.trace is None else os.path.abspath(args.trace)
    if under_torchrun():
        r = torchrun_rank(args.backend, args.device, _weak_rank,
                          (_opts(args.per_rank, args.op, args.dtype, args.reps,
                                 args.backend, args.bc, args.bottom, args.dynamic_range,
                                 args.check_serial, args.overlap, 0.0, trace),))
        if int(os.environ["RANK"]) == 0:
            report(r, r["res"]["seconds_per_solve"])
        return 0
    base = None
    for ranks in args.ranks:
        print(f"backend {args.backend}: "
              + ("one card per rank (NCCL)" if args.backend == "nccl" else
                 f"{ranks} processes sharing "
                 + ("one GPU, gloo, host-staged halos" if args.device == "cuda"
                    else "the CPU, gloo")), file=sys.stderr)
        r = run_weak(args.per_rank, ranks, args.op, args.dtype, args.reps, args.backend,
                     args.bc, args.bottom, args.dynamic_range, args.check_serial,
                     args.overlap, args.device, timeout=args.timeout, trace=trace)
        base = base or r["res"]["seconds_per_solve"]
        report(r, base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
