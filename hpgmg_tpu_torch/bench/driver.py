"""Benchmark driver (counterpart of hpgmg_tpu/bench/driver.py; the
hpgmg-fv.c:50-99 protocol).

Build, one untimed warm-up solve, then a calibration chain and a timed
chain of data-dependent solves (each solve's rhs is ``f + 0*norm_r`` of the
previous one, so no solve can start before the last finished), reporting
DOF/s = n^3 * solves / seconds. On a CUDA device the chain is timed with
CUDA events; on the CPU with the host clock, and the result names the
device it ran on. ``dynamic_range=3`` also solves at 2h and 4h for the
Richardson order (hpgmg-fv.c:320-329).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from hpgmg_tpu_torch.core.config import CycleType, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy, slim_hierarchy
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.problems.fv import init_problem_fv
from hpgmg_tpu_torch.solve.mg import fmg_solve, mg_solve_fixed, richardson_error


@dataclasses.dataclass
class BenchResult:
    n: int
    dof: int
    seconds_per_solve: float
    dof_per_second: float
    num_solves: int
    rel_residual: float
    richardson_order: Optional[float] = None
    device: str = ""


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def build(n: int, cfg: SolverConfig, device: torch.device):
    """The fv4 benchmark problem's slimmed hierarchy and rhs on ``device``."""
    if cfg.op != "fv4":
        raise NotImplementedError(f"operator {cfg.op!r} is not ported yet")
    prob = init_problem_fv(n, dtype=cfg.dtype, device=device)
    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg,
                           alpha=prob.alpha if cfg.helmholtz else None)
    return slim_hierarchy(hier, cfg), prob.f


def _elapsed(device: torch.device, fn) -> float:
    """Seconds ``fn()`` keeps the device busy: CUDA events around it on a
    CUDA device (queue drained first), the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1000.0


def run_benchmark(n: int, cfg: SolverConfig, device="cuda",
                  min_solve_seconds: float = 1.0, max_solves: int = 100,
                  dynamic_range: int = 1,
                  verbose: bool = True) -> BenchResult:
    device = torch.device(device)
    op = get_suite(cfg.op)
    hier, f = build(n, cfg, device)

    def one_solve(rhs):
        """One benchmark solve: an F-cycle, or under CycleType.V eleven
        V-cycles (~1 digit each, the reference's rtol=1e-10 regime)."""
        if cfg.cycle == CycleType.V:
            u, rels = mg_solve_fixed(op, hier, rhs, cfg, num_cycles=11)
            return u, rels[-1], torch.ones((), dtype=rhs.dtype, device=device)
        return fmg_solve(op, hier, rhs, cfg)

    # untimed warm-up pass (hpgmg-fv.c:63)
    u, norm_r, norm_f = one_solve(f)
    rel = float(norm_r) / float(norm_f)

    def chain(num: int):
        dep = torch.zeros((), dtype=f.dtype, device=device)
        for _ in range(num):
            _, nr, _ = one_solve(f + dep)
            dep = 0.0 * nr

    _elapsed(device, lambda: chain(1))
    # calibrate the time per solve, then size the timed chain to the budget
    cal = max(1, min(4, max_solves))
    per_solve_est = _elapsed(device, lambda: chain(cal)) / cal
    num = int(max(1, min(max_solves, round(min_solve_seconds / per_solve_est))))
    per_solve = _elapsed(device, lambda: chain(num)) / num

    order = None
    if dynamic_range >= 3:
        # Richardson: solve at 2h and 4h, compare restrictions (mg.c:1113)
        sols = [u]
        for k in (2, 4):
            hk, fk = build(n // k, cfg, device)
            sols.append(fmg_solve(op, hk, fk, cfg)[0])
            del hk, fk
        order = float(richardson_error(op, *sols)[1])

    res = BenchResult(n=n, dof=n ** 3, seconds_per_solve=per_solve,
                      dof_per_second=n ** 3 / per_solve, num_solves=num,
                      rel_residual=rel, richardson_order=order,
                      device=device_name(device))
    if verbose:
        print(f"  {cfg.op} F-cycle on {res.device}: {n}^3 grid, {num} solves, "
              f"{per_solve:.6f} s/solve, {res.dof_per_second:.6e} DOF/s, "
              f"rel_res={rel:.6e}"
              + (f", order={order:.6f}" if order is not None else ""))
    return res
