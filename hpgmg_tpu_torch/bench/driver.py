"""Benchmark driver (counterpart of hpgmg_tpu/bench/driver.py; the
hpgmg-fv.c:50-99 protocol).

Build, one untimed warm-up solve, then a calibration chain and a timed
chain of data-dependent solves (each solve's rhs is ``f + 0*norm_r`` of the
previous one, so no solve can start before the last finished), reporting
DOF/s = n^3 * solves / seconds. On a CUDA device the chain is timed with
CUDA events; on the CPU with the host clock, and the result names the
device it ran on. ``dynamic_range=3`` also solves at 2h and 4h for the
Richardson order (hpgmg-fv.c:320-329). ``run_test_error`` is the
TEST_ERROR mode: errors against a pointwise problem's analytic solution.

Problems per suite (hpgmg_tpu/bench/driver.py:_build_problem): fv2 and fv4
take the cell-averaged problem of ``problems/fv.py``, fv7pt and 27pt the
pointwise p6; ``problem`` overrides with fv, p4, p6 or sine. Under
``cfg.bc == BC.PERIODIC`` fv, p4 and p6 take their periodic variants (sine
satisfies both BCs as it is).

``mesh`` (parallel/mesh.py) runs the same protocol on a hierarchy cut for
a process grid, every rank calling with its own Mesh (the JAX driver's
``mesh`` argument): each rank builds the global problem on its device,
keeps its blocks, and solves under ``active_mesh``; the Richardson solves
at 2h and 4h run on the same mesh. The timed chain's length is agreed
between the ranks (the largest rank's), so every rank runs as many solves.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from hpgmg_tpu_torch.core import blas
from hpgmg_tpu_torch.core.config import BC, CycleType, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy, slim_hierarchy
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.parallel.mesh import active_mesh, shard_array, shard_hierarchy
from hpgmg_tpu_torch.problems.fv import init_problem_fv
from hpgmg_tpu_torch.problems.p4 import init_problem_p4
from hpgmg_tpu_torch.problems.p6 import init_problem_p6
from hpgmg_tpu_torch.problems.sine import init_problem_sine
from hpgmg_tpu_torch.solve.mg import fmg_solve, mg_solve_fixed, richardson_error

PROBLEMS = ("fv", "p4", "p6", "sine")


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


def build_problem(n: int, cfg: SolverConfig, device: torch.device,
                  problem: Optional[str] = None):
    """The suite's problem at n^3 on ``device``: fv for fv2/fv4, p6 for
    fv7pt/27pt, unless ``problem`` names one of ``PROBLEMS``. The pointwise
    problems (p4, p6, sine) carry ``u_true``."""
    periodic = cfg.bc == BC.PERIODIC
    if problem is None:
        problem = "fv" if cfg.op in ("fv2", "fv4") else "p6"
    if problem == "fv":
        return init_problem_fv(n, dtype=cfg.dtype, device=device,
                               periodic=periodic)
    kw = dict(a=cfg.a, b=cfg.b, helmholtz=cfg.helmholtz)
    if problem == "sine":
        return init_problem_sine(n, cfg.dtype, device, **kw)
    if problem == "p4":
        return init_problem_p4(n, cfg.dtype, device, periodic=periodic, **kw)
    if problem == "p6":
        return init_problem_p6(n, cfg.dtype, device, periodic=periodic, **kw)
    raise ValueError(f"unknown problem {problem!r}; have {PROBLEMS}")


def build(n: int, cfg: SolverConfig, device: torch.device,
          problem: Optional[str] = None, mesh=None):
    """The benchmark problem's slimmed hierarchy and rhs on ``device``; with
    ``mesh``, this rank's cut of both (the global arrays are freed)."""
    prob = build_problem(n, cfg, device, problem)
    hier = slim_hierarchy(build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg,
                                          alpha=prob.alpha if cfg.helmholtz else None),
                          cfg)
    if mesh is None:
        return hier, prob.f
    return shard_hierarchy(mesh, hier, cfg), shard_array(mesh, prob.f)


def run_test_error(n: int, cfg: SolverConfig, device="cuda",
                   problem: str = "p6", levels: int = 3,
                   verbose: bool = True):
    """TEST_ERROR mode (hpgmg-fv.c:317-348): one F-cycle at h, 2h, 4h of a
    pointwise problem with an analytic solution (p4, p6, sine), and the
    error against it. Returns [(n, max_err, l2_err), ...] fine to coarse."""
    device = torch.device(device)
    op = get_suite(cfg.op)
    rows = []
    for lev in range(levels):
        nl = n >> lev
        prob = build_problem(nl, cfg, device, problem)
        hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg,
                               alpha=prob.alpha if cfg.helmholtz else None)
        u, _, _ = fmg_solve(op, hier, prob.f, cfg)
        e = u - prob.u_true
        rows.append((nl, float(blas.norm(e)), float(torch.sqrt(blas.mean(e * e)))))
        if verbose:
            print(f"  h={1.0 / nl:.6e}  {nl}^3  error_max={rows[-1][1]:.6e}  "
                  f"error_L2={rows[-1][2]:.6e}")
    if verbose and len(rows) >= 2:
        orders = [math.log2(rows[i + 1][1] / rows[i][1])
                  for i in range(len(rows) - 1)]
        print("  observed order (max-norm): "
              + ", ".join(f"{o:.2f}" for o in orders))
    return rows


def elapsed(device: torch.device, fn) -> float:
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


def slowest(value: float, mesh) -> float:
    """The largest ``value`` over the ranks of ``mesh`` (itself without one)."""
    if mesh is None:
        return value
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64,
                     device="cpu" if mesh.backend == "gloo" else mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def run_benchmark(n: int, cfg: SolverConfig, device="cuda",
                  min_solve_seconds: float = 1.0, max_solves: int = 100,
                  dynamic_range: int = 1, verbose: bool = True,
                  problem: Optional[str] = None, mesh=None) -> BenchResult:
    device = torch.device(device)
    op = get_suite(cfg.op)
    with active_mesh(mesh):
        return _run(n, cfg, device, op, min_solve_seconds, max_solves,
                    dynamic_range, verbose, problem, mesh)


def _run(n, cfg, device, op, min_solve_seconds, max_solves, dynamic_range,
         verbose, problem, mesh) -> BenchResult:
    hier, f = build(n, cfg, device, problem, mesh)

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

    elapsed(device, lambda: chain(1))
    # calibrate the time per solve, then size the timed chain to the budget
    cal = max(1, min(4, max_solves))
    per_solve_est = slowest(elapsed(device, lambda: chain(cal)) / cal, mesh)
    num = int(max(1, min(max_solves, round(min_solve_seconds / per_solve_est))))
    per_solve = slowest(elapsed(device, lambda: chain(num)) / num, mesh)

    order = None
    if dynamic_range >= 3:
        # Richardson: solve at 2h and 4h, compare restrictions (mg.c:1113)
        sols, parts = [u], [hier.levels[0].part]
        for k in (2, 4):
            hk, fk = build(n // k, cfg, device, problem, mesh)
            sols.append(fmg_solve(op, hk, fk, cfg)[0])
            parts.append(hk.levels[0].part)
            del hk, fk
        order = float(richardson_error(op, *sols, parts=tuple(parts))[1])

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
