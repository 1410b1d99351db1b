"""Where the time of the port's F-cycle goes, on one CUDA device.

    python -m hpgmg_tpu_torch.bench.profile [--n 512] [--op fv4]
        [--bc dirichlet] [--dtype float32] [--smoother gsrb] [--solves 5]
        [--ab] [--subtile] [--json PATH]

On the benchmark's problem and hierarchy of the suite ``--op``
(``bench/driver.py:build``), with the smoother ``--smoother`` (the CLI's
choices; the headline's GSRB by default), after a warm-up solve:

1. the chain of ``--solves`` data-dependent F-cycles (the driver's
   protocol) timed with CUDA events, without and then under
   ``torch.profiler``: wall ms per solve both ways (their ratio is the
   profiler's overhead), the device time per kernel name summed over the
   profiled chain, and the idle share of that same chain,
   1 - (summed kernel time) / (its wall time) (one stream, so kernels do
   not overlap);
2. per level, a V-cycle from that level: device ms (CUDA events) and host
   enqueue ms (the host clock around the calls, no sync), each the mean of
   5 V-cycles;
3. with ``--ab``: phase 2 again with the fused kernels off (half-sweeps
   on every level, no K4 tail); one smoother call per level above the
   tail through the fused full sweeps (K2c for fv4, K6 for the radius-1
   suites) and through half-sweeps (K1, K5) (what sets
   ``stencils.GSRB2_MAX_DIM`` and ``stencils_r1.GSRB2_MAX_DIM``; a run
   moves its own suite's gate only); and the
   chain's ms per solve with the shipped schedule and with the fused
   kernels off; for fv4 also the chain's device (CUDA events) and wall
   (host clock) ms per solve with K4c, the one-launch tail V-cycle, on and
   off (what sets ``tail.TAIL_ONE_LAUNCH``). Each A/B runs in turns on,
   off, off, on. Dirichlet only: under ``--bc periodic`` no level takes a
   fused kernel;
4. with ``--subtile`` (fv4, Dirichlet): the chain's ms per solve with
   ``stencils.SUBTILE`` on and off, and per level one residual and one
   smoother call through K1s and through K1, in turns on, off, off, on
   (what sets ``SUBTILE`` and ``SUBTILE_MAX_DIM``; the counterpart of
   hpgmg_tpu/bench/kernel_sweep.py --subtile).

Prints one line per number; ``--json`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
from torch.autograd import DeviceType

from hpgmg_tpu_torch.bench.driver import build
from hpgmg_tpu_torch.core.config import OPS, BC, BottomSolver, Smoother, SolverConfig
from hpgmg_tpu_torch.kernels import stencils, stencils_r1, tail
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.ops.transfer import restrict_cell
from hpgmg_tpu_torch.solve.mg import fmg_solve, vcycle
from hpgmg_tpu_torch.solve.smoothers import smooth


def _chain(op, hier, f, cfg, num: int):
    dep = torch.zeros((), dtype=f.dtype, device=f.device)
    for _ in range(num):
        _, nr, _ = fmg_solve(op, hier, f + dep, cfg)
        dep = 0.0 * nr


def _events_ms(fn) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_chain(op, hier, f, cfg, solves: int) -> dict:
    """Phase 1: the chain with and without the profiler, per-kernel device
    time and the idle share of the profiled chain."""
    from torch.profiler import ProfilerActivity, profile

    plain_ms = _events_ms(lambda: _chain(op, hier, f, cfg, solves)) / solves
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = _events_ms(lambda: _chain(op, hier, f, cfg, solves)) / solves
    rows = []
    for evt in prof.key_averages():
        us = _self_device_us(evt)
        # kernels only: the rows of aten ops repeat their kernels' time
        if us > 0 and getattr(evt, "device_type", None) == DeviceType.CUDA:
            rows.append((evt.key, us / 1000.0 / solves, evt.count / solves))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"ms_per_solve": plain_ms, "ms_per_solve_profiled": prof_ms,
            "device_ms_per_solve": busy, "idle_share": 1.0 - busy / prof_ms,
            "kernels": [{"name": k, "ms_per_solve": ms, "calls_per_solve": c}
                        for k, ms, c in rows]}


def per_level(op, hier, f, cfg, reps: int = 5) -> list:
    """Phase 2: a V-cycle from each level (zero start), device ms (CUDA
    events around ``reps`` of them, each V-cycle's wall time on the device,
    launch gaps included) and host enqueue ms, each the mean over ``reps``
    V-cycles."""
    rhs = [f]
    for _ in range(len(hier.levels) - 1):
        rhs.append(restrict_cell(rhs[-1]))
    out = []
    for lev, lv in enumerate(hier.levels):
        def run():
            for _ in range(reps):
                vcycle(op, hier.levels, lev, torch.zeros_like(rhs[lev]), rhs[lev], cfg)

        run()
        device_ms = _events_ms(run) / reps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        host_ms = (time.perf_counter() - t0) * 1000.0 / reps
        torch.cuda.synchronize()
        out.append({"dim": lv.dim, "device_ms": device_ms, "host_enqueue_ms": host_ms})
    return out


@contextlib.contextmanager
def schedule(gsrb2_max_dim, tail_fuse: bool, op: str = "fv4"):
    """Set the levels the fused full sweeps of suite ``op`` smooth (K2c's
    ``stencils.GSRB2_MAX_DIM`` for fv4, K6's ``stencils_r1.GSRB2_MAX_DIM``
    for the radius-1 suites; None keeps the gate) and whether the tail goes
    through K4, for the duration. Only the suite's own gate moves."""
    gates = stencils if op == "fv4" else stencils_r1
    old = (gates.GSRB2_MAX_DIM, tail.TAIL_FUSE)
    if gsrb2_max_dim is not None:
        gates.GSRB2_MAX_DIM = gsrb2_max_dim
    tail.TAIL_FUSE = tail_fuse
    try:
        yield
    finally:
        gates.GSRB2_MAX_DIM, tail.TAIL_FUSE = old


def fused(on: bool, op: str = "fv4"):
    """The shipped schedule (on) or half-sweeps and no tail (off)."""
    return schedule(None if on else 0, on, op)


def smooth_ab(op, hier, f, cfg, reps: int = 5) -> list:
    """Phase 3: one smoother call (2 * num_smooths half-sweeps) per level
    through the fused full sweeps (K2c, K6) and through half-sweeps (K1,
    K5), device ms per call, in turns fused/half/half/fused, from a
    smoothed iterate; on the levels the fused kernel takes (K2c: n up to
    ``stencils.GSRB2_CLUSTER_MAX_N``)."""
    nsweeps = 2 * cfg.resolved_num_smooths(op)
    largest = getattr(stencils, "GSRB2_CLUSTER_MAX_N", None) if op.name == "fv4" else None
    rhs = f
    out = []
    for lv in hier.levels:
        if tail.use_tail(op, cfg, hier.levels, lv.depth) or lv is hier.levels[-1]:
            break
        if largest is not None and lv.dim > largest:
            rhs = restrict_cell(rhs)
            continue
        x = op.gsrb_smooth(lv, torch.zeros_like(rhs), rhs, cfg, nsweeps)
        row = {"dim": lv.dim, "fused_ms": [], "half_ms": []}
        for k2 in (True, False, False, True):
            with schedule(lv.dim if k2 else 0, True, op.name):
                op.gsrb_smooth(lv, x, rhs, cfg, nsweeps)
                ms = _events_ms(lambda: [op.gsrb_smooth(lv, x, rhs, cfg, nsweeps)
                                         for _ in range(reps)]) / reps
            row["fused_ms" if k2 else "half_ms"].append(ms)
        out.append(row)
        rhs = restrict_cell(rhs)
    return out


def fused_ab(op, hier, f, cfg, solves: int) -> list:
    """Phase 3: ms per solve with K2c/K6/K4 on and off, in turns on/off/off/on."""
    out = []
    for on in (True, False, False, True):
        with fused(on, op.name):
            _chain(op, hier, f, cfg, 1)
            ms = _events_ms(lambda: _chain(op, hier, f, cfg, solves)) / solves
        out.append({"fused": on, "ms_per_solve": ms})
    return out


def one_launch_ab(op, hier, f, cfg, solves: int) -> list:
    """Phase 3: device and wall ms per solve with K4c (``TAIL_ONE_LAUNCH``)
    on and off, in turns on/off/off/on, and the phase-2 V-cycle times of
    the tail roots (the levels whose V-cycle K4c runs) each way."""
    out = []
    old = tail.TAIL_ONE_LAUNCH
    try:
        for on in (True, False, False, True):
            tail.TAIL_ONE_LAUNCH = on
            _chain(op, hier, f, cfg, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            device_ms = _events_ms(lambda: _chain(op, hier, f, cfg, solves)) / solves
            wall_ms = (time.perf_counter() - t0) * 1000.0 / solves
            roots = [row for lev, row in enumerate(per_level(op, hier, f, cfg))
                     if tail.use_tail(op, cfg, hier.levels, lev)]
            out.append({"one_launch": on, "device_ms_per_solve": device_ms,
                        "wall_ms_per_solve": wall_ms, "tail_roots": roots})
    finally:
        tail.TAIL_ONE_LAUNCH = old
    return out


@contextlib.contextmanager
def subtile(on: bool, max_dim=None):
    """Set ``stencils.SUBTILE`` (and ``SUBTILE_MAX_DIM`` unless None) for
    the duration."""
    old = (stencils.SUBTILE, stencils.SUBTILE_MAX_DIM)
    stencils.SUBTILE = on
    if max_dim is not None:
        stencils.SUBTILE_MAX_DIM = max_dim
    try:
        yield
    finally:
        stencils.SUBTILE, stencils.SUBTILE_MAX_DIM = old


def subtile_ab(op, hier, f, cfg, solves: int, reps: int = 5) -> dict:
    """``--subtile``: the chain's ms per solve with ``SUBTILE`` on (K1s on
    the levels the gate admits) and off (K1 everywhere), and per level
    above the bottom the device ms of one residual and one smoother call
    with K1s on that level and with K1, from a smoothed iterate (what sets
    ``SUBTILE`` and ``SUBTILE_MAX_DIM``). Each A/B in turns on, off, off,
    on."""
    chain = []
    for on in (True, False, False, True):
        with subtile(on):
            _chain(op, hier, f, cfg, 1)
            chain.append({"subtile": on, "ms_per_solve":
                          _events_ms(lambda: _chain(op, hier, f, cfg, solves)) / solves})
    levels, rhs = [], f
    for lv in hier.levels[:-1]:
        x = smooth(op, lv, torch.zeros_like(rhs), rhs, cfg)
        row = {"dim": lv.dim, "k1s_residual_ms": [], "k1_residual_ms": [],
               "k1s_smooth_ms": [], "k1_smooth_ms": []}
        for on in (True, False, False, True):
            key = "k1s" if on else "k1"
            with subtile(on, lv.dim):
                for what, fn in (("residual", lambda: op.residual(lv, x, rhs, cfg)),
                                 ("smooth", lambda: smooth(op, lv, x, rhs, cfg))):
                    fn()
                    row[f"{key}_{what}_ms"].append(
                        _events_ms(lambda: [fn() for _ in range(reps)]) / reps)
        levels.append(row)
        rhs = restrict_cell(rhs)
    return {"chain": chain, "levels": levels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--op", choices=OPS, default="fv4")
    ap.add_argument("--bc", choices=[b.value for b in BC], default="dirichlet")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--smoother", choices=[v.value for v in Smoother], default="gsrb")
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--subtile", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.profile needs a CUDA device")

    cfg = SolverConfig(op=args.op, bc=BC(args.bc), a=0.0, b=1.0,
                       smoother=Smoother(args.smoother), bottom=BottomSolver.DIRECT,
                       min_coarse_dim=8, dtype=getattr(torch, args.dtype))
    op = get_suite(args.op)
    hier, f = build(args.n, cfg, torch.device("cuda"))
    fmg_solve(op, hier, f, cfg)  # warm-up
    res = {"n": args.n, "op": args.op, "bc": args.bc, "dtype": args.dtype,
           "smoother": args.smoother, "solves": args.solves,
           "device": torch.cuda.get_device_name(0)}
    res["chain"] = profile_chain(op, hier, f, cfg, args.solves)
    c = res["chain"]
    print(f"{args.op} {args.bc} {args.smoother} F-cycle {args.n}^3 {args.dtype}: "
          f"{c['ms_per_solve']:.4f} ms/solve, "
          f"{c['ms_per_solve_profiled']:.4f} under the profiler; device "
          f"{c['device_ms_per_solve']:.4f} ms/solve; idle share {c['idle_share']:.4f}")
    for k in c["kernels"][:20]:
        print(f"  {k['ms_per_solve']:9.4f} ms/solve {k['calls_per_solve']:8.1f} "
              f"calls/solve  {k['name'][:90]}")
    res["levels"] = per_level(op, hier, f, cfg)
    for row in res["levels"]:
        print(f"  V-cycle from {row['dim']:4d}^3: device {row['device_ms']:.4f} ms, "
              f"host enqueue {row['host_enqueue_ms']:.4f} ms")
    if args.ab and cfg.bc != BC.DIRICHLET:
        print("  --ab: periodic levels take no fused kernel (K2, K4, K6); no A/B to run")
    elif args.ab:
        with fused(False, args.op):
            res["levels_unfused"] = per_level(op, hier, f, cfg)
        for row in res["levels_unfused"]:
            print(f"  V-cycle from {row['dim']:4d}^3, fused sweeps/K4 off: device "
                  f"{row['device_ms']:.4f} ms, host enqueue {row['host_enqueue_ms']:.4f} ms")
        res["smooth_ab"] = smooth_ab(op, hier, f, cfg)
        for row in res["smooth_ab"]:
            print(f"  smoother {row['dim']:4d}^3: fused sweeps {row['fused_ms']} ms, "
                  f"half-sweeps {row['half_ms']} ms")
        res["fused_ab"] = fused_ab(op, hier, f, cfg, args.solves)
        for row in res["fused_ab"]:
            print(f"  fused sweeps/K4 {'on ' if row['fused'] else 'off'}: "
                  f"{row['ms_per_solve']:.4f} ms/solve")
        if args.op == "fv4":
            res["one_launch_ab"] = one_launch_ab(op, hier, f, cfg, args.solves)
            for row in res["one_launch_ab"]:
                print(f"  K4c (one-launch tail) {'on ' if row['one_launch'] else 'off'}: "
                      f"device {row['device_ms_per_solve']:.4f} ms/solve, wall "
                      f"{row['wall_ms_per_solve']:.4f} ms/solve; V-cycle from "
                      + ", ".join(f"{r['dim']}^3 device {r['device_ms']:.4f} ms, host "
                                  f"enqueue {r['host_enqueue_ms']:.4f} ms"
                                  for r in row["tail_roots"]))
    if args.subtile and (args.op != "fv4" or cfg.bc != BC.DIRICHLET):
        print("  --subtile: only the Dirichlet fv4 levels take K1s; no A/B to run")
    elif args.subtile:
        res["subtile_ab"] = subtile_ab(op, hier, f, cfg, args.solves)
        for row in res["subtile_ab"]["chain"]:
            print(f"  SUBTILE {'on ' if row['subtile'] else 'off'} (K1s up to "
                  f"{stencils.SUBTILE_MAX_DIM}^3): {row['ms_per_solve']:.4f} ms/solve")
        for row in res["subtile_ab"]["levels"]:
            print(f"  {row['dim']:4d}^3 residual: K1s {row['k1s_residual_ms']} ms, K1 "
                  f"{row['k1_residual_ms']} ms; smoother: K1s {row['k1s_smooth_ms']} ms, "
                  f"K1 {row['k1_smooth_ms']} ms")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
