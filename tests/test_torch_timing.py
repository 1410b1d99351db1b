"""The port's timing and tracing tools against the JAX package on the CPU:
the timed F-cycle (``fmg_solve(..., timers={})``, the MGPrintTiming mode),
``bench/timing.py`` (``measure_breakdown``, ``fmg_timing_table``,
``format_breakdown``), the CLI's two tables, ``utils/profiler.py`` and
``utils/memory.py``.

The timed F-cycle runs on the JAX hierarchy carried across by
hpgmg_tpu_torch.interop, in float64, in two cases: fv4, Dirichlet, DIRECT
bottom at 32^3, and fv7pt, periodic, BiCGStab bottom at 16^3. The port's
timed u equals JAX's timed u to 1e-12 and the port's untimed u to 1e-10
(relative max), with the same (level, phase) keys as JAX's timers.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.bench import timing as jtiming
from hpgmg_tpu.bench.driver import _build_problem as jproblem
from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.solve.mg import fmg_solve as jfmg
from hpgmg_tpu.utils import memory as jmemory
from hpgmg_tpu.utils import profiler as jprofiler
from hpgmg_tpu_torch.bench import cli, timing
from hpgmg_tpu_torch.bench.driver import build_problem
from hpgmg_tpu_torch.core.config import BC, BottomSolver, SolverConfig
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import fmg_solve
from hpgmg_tpu_torch.utils import memory, profiler

CPU = torch.device("cpu")
LEVEL_FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max",
                "bottom_ainv")
# (tag, op, bc, bottom, n, problem)
CASES = {"fv4-dirichlet-direct": ("fv4", "dirichlet", "direct", 32, "fv"),
         "fv7pt-periodic-bicgstab": ("fv7pt", "periodic", "bicgstab", 16, "p6")}


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def cfgs(op, bc, bottom):
    kw = dict(op=op, a=0.0, b=1.0, min_coarse_dim=8)
    return (JConfig(dtype=jnp.float64, kernels="xla", bottom=JBottom(bottom),
                    bc=JBC(bc), **kw),
            SolverConfig(dtype=torch.float64, bottom=BottomSolver(bottom), bc=BC(bc), **kw))


def carry(jhier, cfg):
    """The JAX hierarchy as the port's, field for field."""
    return hierarchy_from_numpy(
        [{"dim": lv.dim, "h": lv.h, "depth": lv.depth,
          **{f: np.array(getattr(lv, f)) for f in LEVEL_FIELDS
             if getattr(lv, f) is not None},
          "kdinv": None if lv.kdinv is None else tuple(np.array(k) for k in lv.kdinv)}
         for lv in jhier.levels], cfg, "cpu")


@pytest.fixture(scope="module")
def cases():
    """Per case: the JAX hierarchy, its rhs, JAX's timed u and timers, and
    the port's carried hierarchy and rhs."""
    out = {}
    for tag, (op, bc, bottom, n, prob_name) in CASES.items():
        jcfg, cfg = cfgs(op, bc, bottom)
        prob = jproblem(n, jcfg, prob_name)
        jhier = jbuild(prob.beta_i, prob.beta_j, prob.beta_k, jcfg, alpha=prob.alpha)
        jtimers = {}
        ju, _, _ = jfmg(jsuite(op), jhier, prob.f, jcfg, timers=jtimers)
        f = build_problem(n, cfg, CPU, prob_name).f
        assert rel(f, prob.f) <= 1e-15
        out[tag] = dict(jcfg=jcfg, cfg=cfg, jhier=jhier, jf=prob.f, ju=np.array(ju),
                        jtimers=jtimers, hier=carry(jhier, cfg), f=f)
    return out


@pytest.mark.parametrize("tag", list(CASES))
def test_timed_fcycle_matches_jax(cases, tag):
    c = cases[tag]
    op = get_suite(c["cfg"].op)
    timers = {}
    u, nr, nf = fmg_solve(op, c["hier"], c["f"], c["cfg"], timers=timers)
    u0, nr0, _ = fmg_solve(op, c["hier"], c["f"], c["cfg"])
    err_jax, err_untimed = rel(u, c["ju"]), rel(u, u0.numpy())
    print(f"{tag}: timed u vs JAX timed u {err_jax:.3e}, vs untimed u {err_untimed:.3e}")
    assert err_jax <= 1e-12
    assert err_untimed <= 1e-10
    assert set(timers) == set(c["jtimers"])
    assert all(v > 0.0 for v in timers.values())


def test_measure_breakdown_rows_match_jax(cases):
    """The same rows, keys and key order as the JAX package's on the same
    hierarchy (reps=1; values not compared)."""
    c = cases["fv7pt-periodic-bicgstab"]
    rows = timing.measure_breakdown(c["hier"], c["cfg"], reps=1)
    jrows = jtiming.measure_breakdown(c["jhier"], c["jcfg"], reps=1)
    assert [list(r) for r in rows] == [list(r) for r in jrows]
    assert [(r["level"], r["dim"]) for r in rows] == [(r["level"], r["dim"]) for r in jrows]
    assert all(v > 0.0 for r in rows for k, v in r.items() if k not in ("level", "dim"))


def test_format_breakdown_equals_jax():
    rng = np.random.default_rng(15)
    rows = [{"level": i, "dim": 64 >> i,
             **{k: float(rng.uniform(1e-6, 2.0)) for k in
                ("smooth", "residual", "blas1", "transfer_v", "transfer_f")}}
            for i in range(3)]
    rows.append({"level": 3, "dim": 8, "smooth": 1e-5, "residual": 2.5e-6,
                 "blas1": 0.0, "bottom": 123.456789})
    assert timing.format_breakdown(rows) == jtiming.format_breakdown(rows)


def _labels(table: str):
    lines = table.splitlines()
    return lines[:2], [line[:16] for line in lines]


def test_fmg_timing_table_layout_matches_jax(cases):
    """Row labels and column headers equal JAX's, on the same hierarchy."""
    c = cases["fv4-dirichlet-direct"]
    timers, table = timing.fmg_timing_table(c["hier"], c["cfg"], c["f"])
    _, jtable = jtiming.fmg_timing_table(c["jhier"], c["jcfg"], c["jf"])
    assert _labels(table) == _labels(jtable)
    assert set(timers) == set(c["jtimers"])
    # a cell is printed where the phase ran, blank where it did not
    for line, jline in zip(table.splitlines()[2:], jtable.splitlines()[2:]):
        cells = [line[16 + 12 * i:28 + 12 * i].strip() for i in range(3)]
        jcells = [jline[16 + 12 * i:28 + 12 * i].strip() for i in range(3)]
        assert [bool(x) for x in cells] == [bool(x) for x in jcells], line


def test_cli_prints_both_tables(capsys):
    rc = cli.main(["--device", "cpu", "--n", "16", "--bottom", "direct",
                   "--dynamic-range", "1", "--min-seconds", "0.01",
                   "--timing-table", "--solve-timing-table"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    heads = [i for i, line in enumerate(lines) if line.startswith("level ")]
    assert len(heads) == 2 and heads[0] > 0
    first = [line[:16].strip() for line in lines[heads[0]:heads[0] + 9]]
    second = [line[:16].strip() for line in lines[heads[1]:heads[1] + 9]]
    assert first == ["level", "dim", "smooth", "residual", "blas1", "transfer_v",
                     "transfer_f", "bottom", "total"]
    assert second == ["level", "dim", *timing.TIMED_PHASES, "total"]
    # the CLI's ladder is the JAX CLI's, down to 2^3 (min_coarse_dim 2)
    assert lines[heads[0] + 1].split() == ["dim", "16^3", "8^3", "4^3", "2^3"]


def test_scope_records_nothing_outside_a_trace(monkeypatch, tmp_path):
    """An untimed F-cycle (fv7pt at 16^3: no K4 tail, every phase a range
    of its own) opens no record_function outside ``trace``; inside one on
    the CPU, trace.json holds the per-level ranges."""
    calls = []
    record = torch.profiler.record_function

    def counted(name, *a, **kw):
        calls.append(name)
        return record(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    _, cfg = cfgs("fv7pt", "dirichlet", "direct")
    prob = build_problem(16, cfg, CPU, "p6")
    from hpgmg_tpu_torch.core.hierarchy import build_hierarchy

    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
    op = get_suite("fv7pt")
    u0, _, _ = fmg_solve(op, hier, prob.f, cfg)
    assert calls == []
    with profiler.trace(str(tmp_path / "t")) as log_dir:
        u1, _, _ = fmg_solve(op, hier, prob.f, cfg)
    assert log_dir == str(tmp_path / "t")
    assert torch.equal(u0, u1)
    bot = len(hier.levels) - 1
    assert "mg.L0.smooth" in calls and f"mg.L{bot}.bottom" in calls
    names = {e["name"] for e in profiler.read_trace(log_dir)
             if e.get("cat") == "user_annotation"}
    assert {"mg.L0.smooth", f"mg.L{bot}.bottom", "mg.L0.res+restrict",
            "mg.L0.restriction", "mg.L0.interpolation_f"} <= names
    # the range is off again after the trace
    calls.clear()
    fmg_solve(op, hier, prob.f, cfg)
    assert calls == []


def test_trace_without_a_directory_takes_a_new_one_each_call(monkeypatch, tmp_path):
    """Two traces given no ``log_dir`` write to two new directories under
    the temporary directory, neither overwriting the other's trace.json."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    dirs = []
    for _ in range(2):
        with profiler.trace() as log_dir:
            torch.ones(4).sum()
        dirs.append(log_dir)
    assert dirs[0] != dirs[1]
    for d in dirs:
        assert os.path.dirname(d) == str(tmp_path)
        assert os.path.isfile(os.path.join(d, "trace.json"))


def test_wall_timer_accumulates():
    t = profiler.WallTimer(device="cpu")
    for _ in range(3):
        with t:
            sum(range(10000))
    first = t.total
    assert first > 0.0
    with t:
        pass
    assert t.total >= first


def test_flop_counts_equal_jax():
    for op in ("fv7pt", "fv2", "fv4", "27pt", "unknown"):
        assert profiler.stencil_flops_per_cell(op) == jprofiler.stencil_flops_per_cell(op)
    assert profiler.fcycle_dof_per_solve(512) == jprofiler.fcycle_dof_per_solve(512)


def test_memory_report_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert memory.device_memory_stats() == {}
    line = memory.format_memory_report().splitlines()[0]
    jline = jmemory.format_memory_report().splitlines()[0]
    pattern = r"host rss: (\d+\.\d) MiB"
    m, jm = re.fullmatch(pattern, line), re.fullmatch(pattern, jline)
    assert m and jm
    assert abs(float(m.group(1)) - float(jm.group(1))) <= 64.0
    assert memory.host_rss_bytes() > 0


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1,
            "tid": 7, "args": args}


def test_trace_readers_on_synthetic_events():
    """wall_shares and kernel_ms_by_range on a hand-made trace: a 100 us
    chain with comm 20-40 and 60-70, kernels 30-50 and 80-90 on the
    device, a copy waiting 45-65 on the host; ranges, kernels assigned by
    their launch call."""
    ev = [_x("weak.chain", "user_annotation", 0.0, 100.0),
          _x("comm.p2p", "user_annotation", 20.0, 20.0),
          _x("gloo:all_reduce", "cpu_op", 60.0, 10.0),
          _x("mg.L0.smooth", "user_annotation", 25.0, 10.0),
          _x("mg.L1.tail", "user_annotation", 40.0, 30.0),
          _x("mg.L1.bottom", "user_annotation", 50.0, 5.0),
          _x("cudaLaunchKernel", "cuda_runtime", 26.0, 1.0, correlation=1),
          _x("cudaLaunchKernel", "cuda_runtime", 52.0, 1.0, correlation=2),
          _x("cudaLaunchKernel", "cuda_runtime", 95.0, 1.0, correlation=3),
          _x("cudaMemcpyAsync", "cuda_runtime", 45.0, 20.0),
          _x("k1", "kernel", 30.0, 20.0, correlation=1),
          _x("k2", "kernel", 80.0, 10.0, correlation=2),
          _x("k3", "kernel", 96.0, 2.0, correlation=3)]
    sh = profiler.wall_shares(ev, "weak.chain")
    assert sh["wall_ms"] == pytest.approx(0.1)
    assert sh["comm_share"] == pytest.approx(0.30)
    assert sh["kernel_share"] == pytest.approx(0.32)
    assert sh["overlap_share"] == pytest.approx(0.10)
    assert sh["neither_share"] == pytest.approx(1.0 - 0.52)
    assert sh["host_wait_share"] == pytest.approx(0.10)  # 50-60 only
    by, total, inside = profiler.kernel_ms_by_range(ev)
    assert by["mg.L0.smooth"] == (pytest.approx(0.020), 1)
    assert by["mg.L1.bottom"] == (pytest.approx(0.010), 1)
    assert by["mg.L1.tail"] == (0.0, 1)
    assert total == pytest.approx(0.032) and inside == pytest.approx(0.030)
