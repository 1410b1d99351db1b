"""Headline benchmark of the port: F-cycle DOF/s on a CUDA device, fv4 by
default, or another suite with ``--op fv7pt | fv2 | 27pt``, with Dirichlet
or periodic (``--bc periodic``) boundary conditions.

    python -m hpgmg_tpu_torch.bench [--n 512] [--op fv4] [--bc dirichlet]
        [--problem p6] ...

Prints ONE JSON line with the keys of the JAX package's ``bench.py``
(metric, value, unit, vs_baseline, n, dtype, smoother, bottom,
rel_residual, seconds_per_solve, richardson_order, warnings,
bicgstab_dof_per_s, bicgstab_vs_baseline) plus ``device``, the name of the
device that ran it. The baseline is the reference's published FV
4th-order F-cycle throughput, 2.781e8 DOF/s (BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from hpgmg_tpu_torch.bench.driver import PROBLEMS, device_name, run_benchmark
from hpgmg_tpu_torch.core.config import OPS, BC, BottomSolver, Smoother, SolverConfig

BASELINE_DOF_S = 2.781e8

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# per suite: its discretization order (a Richardson order more than one
# below it is flagged) and the rel_residual one F-cycle should reach
_LIMITS = {"fv4": (4.0, 1e-3), "fv7pt": (2.0, 1e-2), "fv2": (2.0, 1e-2),
           "27pt": (2.0, 1e-2)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m hpgmg_tpu_torch.bench")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--op", choices=OPS, default="fv4")
    ap.add_argument("--bc", choices=[b.value for b in BC], default="dirichlet")
    ap.add_argument("--problem", choices=PROBLEMS, default=None,
                    help="problem override (default: fv for fv2/fv4, p6 for "
                         "fv7pt/27pt)")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    ap.add_argument("--bottom", choices=["direct", "bicgstab"], default="direct")
    ap.add_argument("--min-coarse-dim", type=int, default=8)
    ap.add_argument("--dynamic-range", type=int, default=3)
    ap.add_argument("--min-seconds", type=float, default=2.0)
    ap.add_argument("--no-bicgstab", action="store_true",
                    help="skip the BiCGStab-bottom companion run")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1

    def cfg_for(bottom):
        return SolverConfig(op=args.op, bc=BC(args.bc), a=0.0, b=1.0,
                            smoother=Smoother.GSRB, bottom=bottom,
                            min_coarse_dim=args.min_coarse_dim,
                            dtype=_DTYPES[args.dtype])

    res = run_benchmark(args.n, cfg_for(BottomSolver(args.bottom)), device,
                        min_solve_seconds=args.min_seconds,
                        dynamic_range=args.dynamic_range, verbose=False,
                        problem=args.problem)
    out = {
        "metric": (f"{args.op}{'_periodic' if args.bc == 'periodic' else ''}"
                   f"_fcycle_dof_per_s_n{args.n}"),
        "value": res.dof_per_second,
        "unit": "DOF/s",
        "vs_baseline": res.dof_per_second / BASELINE_DOF_S,
        "n": args.n,
        "dtype": args.dtype,
        "smoother": "gsrb",
        "bottom": args.bottom,
        "rel_residual": res.rel_residual,
        "seconds_per_solve": res.seconds_per_solve,
        "device": device_name(device),
    }
    warnings = []
    want, rel_limit = _LIMITS[args.op]
    if res.richardson_order is not None:
        out["richardson_order"] = res.richardson_order
        if res.richardson_order < want - 1.0:
            warnings.append(f"richardson_order {res.richardson_order:.3f} < "
                            f"{want - 1.0}: order-{want:g} operator regression")
    if res.rel_residual > rel_limit:
        warnings.append(f"rel_residual {res.rel_residual:.3e} > {rel_limit:g}: "
                        "F-cycle failed to reach the discretization-error regime")
    if warnings:
        out["warnings"] = warnings
    if not args.no_bicgstab:
        res_b = run_benchmark(args.n, cfg_for(BottomSolver.BICGSTAB), device,
                              min_solve_seconds=args.min_seconds, verbose=False,
                              problem=args.problem)
        out["bicgstab_dof_per_s"] = res_b.dof_per_second
        out["bicgstab_vs_baseline"] = res_b.dof_per_second / BASELINE_DOF_S
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
