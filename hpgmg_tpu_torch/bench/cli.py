"""hpgmg-fv style benchmark CLI of the port (counterpart of
hpgmg_tpu/bench/cli.py): every operator suite, smoother, bottom solver,
cycle and driver of the solver, on one device.

    python -m hpgmg_tpu_torch.bench.cli [log2_box_dim [target_boxes]]
        [--n 128] [--op fv4] [--smoother gsrb] [--bottom bicgstab]
        [--cycle F] [--bc dirichlet] [--dtype float32] [--problem fv]
        [--dynamic-range 3] [--min-seconds 1.0] [--test-error]
        [--driver fmg2|fmg2dd|mgpcg] [--min-coarse-dim 2] [--device cuda]
        [--timing-table] [--solve-timing-table]

The protocol follows main()/bench_hpgmg (hpgmg-fv.c:103-386) through
``bench/driver.py``: build, warm up, a timed chain of F-cycle solves (or,
under ``--cycle V``, eleven V-cycles a solve) at h, then the 2h and 4h
solves of the Richardson order, and the DOF/s summary. ``--test-error``
reports the error against a pointwise problem's analytic solution at h, 2h
and 4h instead. ``--driver`` runs the iterated F-cycle (FMGSolve2,
mg.c:1348-1495), its compensated double-f32 variant (fmg2dd) or
MG-preconditioned CG (MGPCG, mg.c:1500-1607) to ``rtol`` 1e-10 and prints
the convergence history, the seconds of the converged solve and its DOF/s.

The reference-style positionals size the grid as
box_dim * cbrt(target_boxes), one device. ``--min-coarse-dim`` defaults to
2, the JAX CLI's ladder (its SolverConfig's default; ``python -m
hpgmg_tpu_torch.bench`` keeps bench.py's 8): the fv4 suite computes its
levels below 4^3 by the plain version on every device
(kernels/stencils.py:small_level). After the DOF/s lines,
``--timing-table`` prints the per-level x per-operation table of
standalone phase times (``bench/timing.py:measure_breakdown``) and
``--solve-timing-table`` the reference's MGPrintTiming table of one timed
F-cycle (``bench/timing.py:fmg_timing_table``), both on the CLI's device.
``--dtype bfloat16`` is the whole solve in bf16 (stored in bf16, every
kernel and plain version computing in float32 and rounding its output to
bf16 once): every ``--op`` (fv4, fv7pt, fv2, 27pt) with either ``--bc``,
on one rank, with an iterative bottom (DIRECT cannot be built in bf16:
it raises). On the default device ``cuda``
the CLI exits with 1 when no CUDA device is present; ``--device cpu`` runs
the plain versions.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from hpgmg_tpu_torch.bench.driver import (PROBLEMS, elapsed, build, device_name,
                                          run_benchmark, run_test_error)
from hpgmg_tpu_torch.bench.timing import (fmg_timing_table, format_breakdown,
                                          measure_breakdown)
from hpgmg_tpu_torch.core.config import (OPS, BC, BottomSolver, CycleType, Smoother,
                                         SolverConfig)
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import fmg_solve2, fmg_solve2_dd, mgpcg

DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}
DRIVERS = ("fmg2", "fmg2dd", "mgpcg")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m hpgmg_tpu_torch.bench.cli",
                                description="HPGMG-FV benchmark of the PyTorch/CUDA port")
    # reference-compatible positionals: hpgmg-fv [log2_box_dim]
    # [target_boxes_per_rank] (hpgmg-fv.c:152-205)
    p.add_argument("log2_box_dim", nargs="?", type=int, default=None)
    p.add_argument("target_boxes", nargs="?", type=int, default=None)
    p.add_argument("--n", type=int, default=128, help="fine grid dim (n^3)")
    p.add_argument("--op", default="fv4", choices=OPS)
    p.add_argument("--smoother", default="gsrb", choices=[s.value for s in Smoother])
    p.add_argument("--bottom", default="bicgstab",
                   choices=[s.value for s in BottomSolver])
    p.add_argument("--cycle", default="F", choices=[c.value for c in CycleType])
    p.add_argument("--bc", default="dirichlet", choices=[b.value for b in BC])
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                   help="bfloat16: every --op and --bc on one rank, iterative bottoms only")
    p.add_argument("--dynamic-range", type=int, default=3,
                   help="solve at h, 2h, 4h for Richardson (DYNAMIC_RANGE)")
    p.add_argument("--problem", default=None, choices=PROBLEMS,
                   help="problem override (default: fv for fv2/fv4, p6 otherwise)")
    p.add_argument("--test-error", action="store_true",
                   help="TEST_ERROR mode (hpgmg-fv.c:317-348): the error against "
                        "the analytic solution at h/2h/4h instead of DOF/s")
    p.add_argument("--driver", default=None, choices=DRIVERS,
                   help="run FMGSolve2, its compensated double-f32 variant or "
                        "MGPCG to rtol and print the convergence history")
    p.add_argument("--min-seconds", type=float, default=1.0)
    p.add_argument("--min-coarse-dim", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timing-table", action="store_true",
                   help="print the per-level x per-op breakdown (standalone costs)")
    p.add_argument("--solve-timing-table", action="store_true",
                   help="print MGPrintTiming-style per-level times accumulated "
                        "inside one actual solve")
    return p


def grid_dim(args) -> int:
    """``--n``, or with the positionals box_dim * cbrt(target_boxes) on
    one device (target_boxes 8 by default)."""
    if args.log2_box_dim is None:
        return args.n
    boxes = args.target_boxes or 8
    return (2 ** args.log2_box_dim) * max(1, round(boxes ** (1.0 / 3.0)))


def solver_config(args) -> SolverConfig:
    return SolverConfig(op=args.op, a=0.0, b=1.0, bc=BC(args.bc),
                        smoother=Smoother(args.smoother),
                        bottom=BottomSolver(args.bottom), cycle=CycleType(args.cycle),
                        min_coarse_dim=args.min_coarse_dim, dtype=DTYPES[args.dtype])


def run_driver(driver: str, n: int, cfg: SolverConfig, device,
               problem: Optional[str] = None, verbose: bool = True,
               max_cycles: int = 20) -> dict:
    """One solver driver to ``cfg.rtol``, at most ``max_cycles`` F-cycles
    or iterations, on the benchmark problem at n^3: an untimed warm-up
    solve, then the timed one (CUDA events on a CUDA device). Returns its
    history (per F-cycle or iteration relative residuals), its seconds and
    its DOF/s (n^3 over those seconds)."""
    device = torch.device(device)
    op = get_suite(cfg.op)
    hier, f = build(n, cfg, device, problem)
    if driver == "fmg2":
        def run():
            return fmg_solve2(op, hier, f, cfg, max_fcycles=max_cycles,
                              verbose=verbose)[1]
    elif driver == "fmg2dd":
        def run():
            return fmg_solve2_dd(op, hier, f, cfg, max_fcycles=max_cycles,
                                 verbose=verbose)[2]
    elif driver == "mgpcg":
        def run():
            return mgpcg(op, hier, f, cfg, max_iters=max_cycles, verbose=verbose)[1]
    else:
        raise ValueError(f"unknown driver {driver!r}; have {DRIVERS}")
    run()  # warm-up
    out = {}
    seconds = elapsed(device, lambda: out.setdefault("history", run()))
    history = out["history"]
    return {"driver": driver, "n": n, "iterations": len(history), "history": history,
            "rel_residual": history[-1], "seconds": seconds,
            "dof_per_second": n ** 3 / seconds, "device": device_name(device)}


def run(args):
    """Run what the parsed ``args`` ask for and print its summary: the
    driver's result dict under ``--driver``, the TEST_ERROR rows under
    ``--test-error``, else the benchmark's ``BenchResult``."""
    device = torch.device(args.device)
    cfg = solver_config(args)
    n = grid_dim(args)
    if args.log2_box_dim is not None:
        print(f"  reference-style sizing: box_dim=2^{args.log2_box_dim}, "
              f"{args.target_boxes or 8} boxes on 1 device -> n={n}")
    print(f"  op={args.op} smoother={args.smoother} bottom={args.bottom} "
          f"cycle={args.cycle} bc={args.bc} n={n} dtype={args.dtype} "
          f"device={device_name(device)}")
    if args.driver:
        res = run_driver(args.driver, n, cfg, device, problem=args.problem)
        print(f"  {args.driver}: {res['iterations']} iterations, rel_res="
              f"{res['rel_residual']:.3e}, {res['seconds']:.4f} s "
              f"({res['dof_per_second']:.3e} DOF/s)")
        return res
    if args.test_error:
        problem = args.problem or ("p6" if args.op in ("fv7pt", "27pt") else "sine")
        print(f"  TEST_ERROR mode, problem={problem}")
        return run_test_error(n, cfg, device, problem=problem,
                              levels=min(3, args.dynamic_range))
    res = run_benchmark(n, cfg, device, min_solve_seconds=args.min_seconds,
                        dynamic_range=args.dynamic_range, problem=args.problem)
    print(f"  DOF/s == {res.dof_per_second:.3e}")
    print(f"  rel_residual == {res.rel_residual:.3e}")
    if res.richardson_order is not None:
        print(f"  Richardson order == {res.richardson_order:.3f}")
    if args.timing_table or args.solve_timing_table:
        hier, f = build(n, cfg, device, args.problem)
        if args.timing_table:
            print(format_breakdown(measure_breakdown(hier, cfg)))
        if args.solve_timing_table:
            print(fmg_timing_table(hier, cfg, f)[1])
    return res


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
