"""Device time of each fv4 stencil call the F-cycle makes on one level, on
one CUDA device.

    python -m hpgmg_tpu_torch.bench.stencil_times [--sizes 128 256 512]
        [--dtype float32] [--bc dirichlet periodic] [--reps 10] [--tail]
        [--json PATH]

For each size and BC, on the benchmark problem's finest level as the fv4
suite rebuilds it, with x drawn from a seeded generator: the ms per call
(CUDA events over ``--reps`` calls at 512^3, as many cells' worth on
smaller levels up to 64 times as many calls, after 3 warm-up calls) of the
suite's
``apply_op``, ``residual``, ``gsrb_sweep`` (parity 0) and
``restrict_residual`` (K1 on Dirichlet levels, K7a on periodic ones), and
one smoother call (the suite's 6 half-sweeps): as the suite's
``gsrb_smooth`` under the tree's own gate (``smooth``; K7a half-sweeps on
a periodic level), and on a Dirichlet level also as three
``stencils.fv4_gsrb2_cuda`` sweeps (K2, ``smooth_k2``), as three K2c
sweeps on the levels K2c takes (``smooth_k2c``: ``fv4_gsrb2_cluster_cuda``,
or an older tree's cooperative ``fv4_gsrb2_coop_cuda``) and as
``gsrb_smooth`` with ``stencils.GSRB2_MAX_DIM`` set to 0 (K1 half-sweeps,
``smooth_k1``); beside each smoother call's time, the device time of its
kernels alone (torch.profiler), which tells launch overhead from kernel
time on the small levels. With ``--tail``, also K4c, K4a and K4b (the
tail kernels' entries ``tail_v_cuda``, ``tail_down_cuda``,
``tail_up_cuda``) on the headline's tail, the 32^3 and 16^3 levels of the
benchmark hierarchy over its 8^3 DIRECT bottom, each with its device
time (rows with n 32 and calls ``tail_v``, ``tail_down``, ``tail_up``). It
reads nothing but these and the gate, so the same file times an older
tree of the package too (copied into that tree and run from its root;
there ``fv4_gsrb2_cuda`` is its own K2), in turns with this one on the same
card. Prints one JSON line; ``--json`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from hpgmg_tpu_torch.bench.driver import build, build_problem
from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels import stencils
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


def device_ms(fn, reps: int):
    """Device ms per call of ``fn``: its kernels' own time in a
    torch.profiler trace of ``reps`` calls, without the gaps between
    launches; None when the trace shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / 1000.0 / reps if us else None


def level_times(n: int, dtype: torch.dtype, bc: BC, reps: int) -> dict:
    """{call: ms} of the four stencil calls and the smoother calls on the
    n^3 level, each over ``reps`` calls at 512^3 and proportionally more on
    smaller levels (the same cells timed); for each smoother call also its
    kernels' device ms (``<call>_device``)."""
    reps = reps * min(64, max(1, (512 // n) ** 3))
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
    out = {name: time_ms(fn, reps) for name, fn in calls.items()}
    nsweeps = 2 * suite.gsrb_num_smooths

    def sweeps(kernel):
        def run():
            y = x
            for _ in range(nsweeps // 2):
                y = kernel(lv, y, f, cfg)
            return y
        return run

    def half_sweeps():
        old = stencils.GSRB2_MAX_DIM
        stencils.GSRB2_MAX_DIM = 0
        try:
            return suite.gsrb_smooth(lv, x, f, cfg, nsweeps)
        finally:
            stencils.GSRB2_MAX_DIM = old

    # the smoother call as the solver makes it, under the tree's own gate
    smooths = {"smooth": lambda: suite.gsrb_smooth(lv, x, f, cfg, nsweeps)}
    if bc == BC.DIRICHLET:
        smooths["smooth_k2"] = sweeps(stencils.fv4_gsrb2_cuda)
        k2c = (getattr(stencils, "fv4_gsrb2_cluster_cuda", None)
               or getattr(stencils, "fv4_gsrb2_coop_cuda", None))
        if k2c is not None and n <= getattr(stencils, "GSRB2_CLUSTER_MAX_N", n):
            smooths["smooth_k2c"] = sweeps(k2c)
        smooths["smooth_k1"] = half_sweeps
    for name, fn in smooths.items():
        out[name] = time_ms(fn, reps)
        out[name + "_device"] = device_ms(fn, reps)
    return out


def tail_times(dtype: torch.dtype, reps: int) -> dict:
    """{call: ms} of K4c, K4a and K4b on the headline's tail (the 32^3 and
    16^3 levels of the benchmark hierarchy over its 8^3 DIRECT bottom, 6
    half-sweeps a level), with each call's device ms (``<call>_device``)."""
    from hpgmg_tpu_torch.kernels import tail

    dev = torch.device("cuda")
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=dtype, min_coarse_dim=8)
    hier, _ = build(64, cfg, dev)
    levels, bottom = hier.levels[1:3], hier.levels[3]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    e, rhs = (torch.randn(levels[0].shape, generator=gen, device=dev, dtype=dtype)
              for _ in range(2))
    es, rhss = tail.tail_down_cuda(levels, e, rhs, cfg, 6)
    u_bot = torch.randn(bottom.shape, generator=gen, device=dev, dtype=dtype)
    calls = {"tail_v": lambda: tail.tail_v_cuda(levels, bottom, e, rhs, cfg, 6),
             "tail_down": lambda: tail.tail_down_cuda(levels, e, rhs, cfg, 6),
             "tail_up": lambda: tail.tail_up_cuda(levels, es, [rhs, rhss[0]], u_bot,
                                                  cfg, 6)}
    out = {}
    for name, fn in calls.items():
        out[name] = time_ms(fn, reps * 64)
        out[name + "_device"] = device_ms(fn, reps * 64)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", type=int, nargs="+", default=[128, 256, 512])
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--bc", nargs="+", choices=["dirichlet", "periodic"],
                   default=["dirichlet", "periodic"])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--tail", action="store_true",
                   help="also time K4c, K4a and K4b on the headline's 32-16 tail")
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
    if args.tail:
        rows += [{"n": 32, "dtype": args.dtype, "bc": "dirichlet", "call": k, "ms": v}
                 for k, v in tail_times(getattr(torch, args.dtype), args.reps).items()]
    out = {"device": torch.cuda.get_device_name(0), "card": card, "rows": rows}
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
