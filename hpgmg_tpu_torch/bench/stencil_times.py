"""Device time of each fv4 stencil call the F-cycle makes on one level, on
one CUDA device.

    python -m hpgmg_tpu_torch.bench.stencil_times [--sizes 128 256 512]
        [--dtype float32] [--bc dirichlet periodic] [--reps 10] [--json PATH]

For each size and BC, on the benchmark problem's finest level as the fv4
suite rebuilds it, with x drawn from a seeded generator: the ms per call
(CUDA events over ``--reps`` calls at 512^3, as many cells' worth on
smaller levels, after 3 warm-up calls) of the suite's
``apply_op``, ``residual``, ``gsrb_sweep`` (parity 0) and
``restrict_residual``, the calls a V-cycle makes on levels above the fused
sweep's gate (K1 on Dirichlet levels, K7a on periodic ones). It reads
nothing but the suite's methods, so the same file times an older tree of
the package too (copied into that tree and run from its root), in turns
with this one on the same card. Prints one JSON line; ``--json`` also
writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from hpgmg_tpu_torch.bench.driver import build_problem
from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.ops.base import get_suite

SEED = 20261017


def time_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` over ``reps`` calls, after 3 warm-up
    calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def level_times(n: int, dtype: torch.dtype, bc: BC, reps: int) -> dict:
    """{call: ms} of the four stencil calls on the n^3 level, each over
    ``reps`` calls at 512^3 and proportionally more on smaller levels (the
    same cells timed)."""
    reps = reps * max(1, (512 // n) ** 3)
    dev = torch.device("cuda")
    cfg = SolverConfig(op="fv4", bc=bc, a=0.0, b=1.0, dtype=dtype)
    suite = get_suite("fv4")
    prob = build_problem(n, cfg, dev)
    lv = suite.rebuild_operator(Level(dim=n, h=1.0 / n, depth=0, beta_i=prob.beta_i,
                                      beta_j=prob.beta_j, beta_k=prob.beta_k), cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, n, n), generator=gen, device=dev, dtype=dtype)
    f = prob.f
    calls = {"apply": lambda: suite.apply_op(lv, x, cfg),
             "residual": lambda: suite.residual(lv, x, f, cfg),
             "gsrb": lambda: suite.gsrb_sweep(lv, x, f, cfg, 0),
             "fres": lambda: suite.restrict_residual(lv, x, f, cfg)}
    return {name: time_ms(fn, reps) for name, fn in calls.items()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", type=int, nargs="+", default=[128, 256, 512])
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--bc", nargs="+", choices=["dirichlet", "periodic"],
                   default=["dirichlet", "periodic"])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stencil_times needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rows = []
    for bc in args.bc:
        for n in args.sizes:
            ms = level_times(n, getattr(torch, args.dtype), BC(bc), args.reps)
            rows += [{"n": n, "dtype": args.dtype, "bc": bc, "call": k, "ms": v}
                     for k, v in ms.items()]
            torch.cuda.empty_cache()
    out = {"device": torch.cuda.get_device_name(0), "card": card, "rows": rows}
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
