"""Per-level / per-operation timing tables (counterpart of
hpgmg_tpu/bench/timing.py; the MGPrintTiming analog, mg.c:54-163).

Two tools, each printing the reference's table (levels as columns,
operations as rows):

* ``measure_breakdown``: each phase (smooth, residual, BLAS1, the
  restrict->interpolate round trips, the bottom solve) called on its own
  per level, a chain of data-dependent calls timed together: standalone
  costs that bound the phases inside a solve;
* ``fmg_timing_table``: the phases of one actual F-cycle in solve order,
  accumulated per level by the cycle's timed mode (``solve/mg.py:
  _phase``, a device sync around each phase; the reference's timers pay
  the same).

On a CUDA device the chains are timed with CUDA events
(``bench/driver.py:elapsed``), on the CPU with the host clock. The trace
with named per-level ranges is ``utils/profiler.py:trace``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from hpgmg_tpu_torch.bench.driver import elapsed
from hpgmg_tpu_torch.core import blas
from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.hierarchy import Hierarchy
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.ops.transfer import get_interpolation, restrict_cell
from hpgmg_tpu_torch.solve.bottom import bottom_solve
from hpgmg_tpu_torch.solve.smoothers import smooth


def _time_fn(fn, *args, reps: int = 50) -> float:
    """Seconds a call of ``fn``: one warm-up call, then ``reps`` calls
    chained eagerly, the first positional argument threaded through them
    as the carry (each call's result is the next call's first argument),
    so no call can start before the previous one finished."""
    carry, rest = args[0], args[1:]
    fn(carry, *rest)  # warm-up

    def chain():
        c = carry
        for _ in range(reps):
            c = fn(c, *rest)

    return elapsed(carry.device, chain) / reps


def measure_breakdown(hier: Hierarchy, cfg: SolverConfig,
                      reps: int = 5) -> List[Dict[str, float]]:
    """Time each multigrid phase per level. Returns a list (one dict per
    level) of seconds per single invocation."""
    op = get_suite(cfg.op)
    rows = []
    for idx, lv in enumerate(hier.levels):
        x = torch.zeros(lv.shape, dtype=lv.dtype, device=lv.device)
        r = torch.ones(lv.shape, dtype=lv.dtype, device=lv.device)
        row = {"level": idx, "dim": lv.dim}
        # the carry (first arg) threads through the chained calls
        row["smooth"] = _time_fn(
            lambda x, lv, r: smooth(op, lv, x, r, cfg), x, lv, r, reps=reps)
        row["residual"] = _time_fn(
            lambda x, lv, r: op.residual(lv, x, r, cfg), x, lv, r, reps=reps)
        row["blas1"] = _time_fn(
            lambda c, x, r: blas.dot(x + c, r, cfg.reduce_dtype),
            torch.zeros((), dtype=lv.dtype, device=lv.device), x, r, reps=reps)
        if idx + 1 < len(hier.levels):
            # the restrict->interpolate round trip chained on the fine
            # array (shape-preserving, data-dependent)
            interp_v = get_interpolation(op.interpolation_vcycle)
            row["transfer_v"] = _time_fn(
                lambda x: interp_v(restrict_cell(x), 1.0, x, cfg.bc), r, reps=reps)
            interp_f = get_interpolation(op.interpolation_fcycle)
            row["transfer_f"] = _time_fn(
                lambda x: interp_f(restrict_cell(x), 1.0, x, cfg.bc), r, reps=reps)
        else:
            row["bottom"] = _time_fn(
                lambda x, lv, r: bottom_solve(op, lv, x, r, cfg), x, lv, r,
                reps=max(5, reps // 5))
        rows.append(row)
    return rows


TIMED_PHASES = ("smooth", "residual", "restriction", "interpolation",
                "interpolation_f", "bottom")


def _table(names, row_names, cells) -> str:
    """Levels as columns (``names``: (level, dim) pairs), one row a name
    of ``row_names`` (``cells(name, i)`` the seconds, or None), and the
    per-level total."""
    lines = ["level".ljust(16) + "".join(f"{i:>12d}" for i, _ in names),
             "dim".ljust(16) + "".join(f"{d:>10d}^3" for _, d in names)]
    total = [0.0] * len(names)
    for name in row_names:
        out = []
        for i in range(len(names)):
            v = cells(name, i)
            out.append(f"{v:12.6f}" if v is not None else " " * 12)
            total[i] += v or 0.0
        lines.append(name.ljust(16) + "".join(out))
    lines.append("total".ljust(16) + "".join(f"{t:12.6f}" for t in total))
    return "\n".join(lines)


def fmg_timing_table(hier: Hierarchy, cfg: SolverConfig, f=None):
    """MGPrintTiming analog (mg.c:54-163): per-level x per-operation wall
    time accumulated inside ONE actual F-cycle solve (after one timed
    warm-up solve), a device sync around each phase, so the numbers are
    the phases of a real solve in solve order. Returns (timers dict
    {(level, phase): seconds}, formatted table)."""
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    op = get_suite(cfg.op)
    lv0 = hier.levels[0]
    if f is None:
        f = torch.ones(lv0.shape, dtype=lv0.dtype, device=lv0.device)
    fmg_solve(op, hier, f, cfg, timers={})  # warm-up
    timers: Dict = {}
    fmg_solve(op, hier, f, cfg, timers=timers)
    names = [(i, lv.dim) for i, lv in enumerate(hier.levels)]
    return timers, _table(names, TIMED_PHASES, lambda ph, i: timers.get((i, ph)))


def format_breakdown(rows: List[Dict[str, float]]) -> str:
    """Render the per-level x per-op table the way MGPrintTiming does
    (levels as columns, operations as rows)."""
    ops = ["smooth", "residual", "blas1", "transfer_v", "transfer_f", "bottom"]
    names = [(r["level"], r["dim"]) for r in rows]
    return _table(names, ops, lambda name, i: rows[i].get(name))
