"""The port's benchmark path on the CPU: the BiCGStab-bottom F-cycle
against the JAX package (16^3 f64, u rel <= 1e-9, rel_res within 1e-6
relative), the driver's protocol and result (F- and V-cycle solves), the
command-line JSON, the profiler's K2/K4 switch, and the refusal of
chip_smoke.py and bench.profile to run without a CUDA device.
"""

import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.problems.fv import init_problem_fv as jinit
from hpgmg_tpu.solve.mg import fmg_solve as jfmg
from hpgmg_tpu_torch.bench import __main__ as bench_main
from hpgmg_tpu_torch.bench import profile as bench_profile
from hpgmg_tpu_torch.bench.driver import build, run_benchmark
from hpgmg_tpu_torch.core.config import BottomSolver, CycleType, SolverConfig
from hpgmg_tpu_torch.kernels import restrict as R
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import tail as T
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import fmg_solve, mg_solve_fixed

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_bicgstab_fcycle_matches_jax():
    n = 16
    jcfg = JConfig(op="fv4", a=0.0, b=1.0, dtype=jnp.float64, kernels="xla",
                   bottom=JBottom.BICGSTAB, min_coarse_dim=8)
    jprob = jinit(n, dtype=jnp.float64)
    jh = jbuild(jprob.beta_i, jprob.beta_j, jprob.beta_k, jcfg, alpha=jprob.alpha)
    ju, jnr, jnf = jax.jit(lambda h, f: jfmg(jsuite("fv4"), h, f, jcfg))(jh, jprob.f)
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64,
                       bottom=BottomSolver.BICGSTAB, min_coarse_dim=8)
    hier, f = build(n, cfg, torch.device("cpu"))
    assert hier.levels[-1].bottom_ainv is None
    u, nr, nf = fmg_solve(get_suite("fv4"), hier, f, cfg)
    ju = np.asarray(ju)
    assert np.max(np.abs(u.numpy() - ju)) <= 1e-9 * np.max(np.abs(ju))
    jrel = float(jnr) / float(jnf)
    assert abs(float(nr) / float(nf) - jrel) <= 1e-6 * jrel


def test_run_benchmark_on_cpu_names_its_device():
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    plain = S.fv4_stencil_plain.calls
    tail_calls = (T.tail_down_plain.calls, T.tail_up_plain.calls)
    res = run_benchmark(16, cfg, "cpu", min_solve_seconds=0.05, max_solves=3,
                        dynamic_range=3, verbose=False)
    assert res.device == "cpu" and res.n == 16 and res.dof == 16 ** 3
    assert 1 <= res.num_solves <= 3 and res.seconds_per_solve > 0
    assert res.dof_per_second == res.dof / res.seconds_per_solve
    hier, f = build(16, cfg, torch.device("cpu"))
    _, nr, nf = fmg_solve(get_suite("fv4"), hier, f, cfg)
    assert res.rel_residual == float(nr) / float(nf)
    assert np.isfinite(res.richardson_order)
    # CPU tensors take the plain versions; at 16^3 every V-cycle above the
    # 8^3 bottom runs through the tail (K4)
    assert S.fv4_stencil_plain.calls > plain
    assert T.tail_down_plain.calls > tail_calls[0]
    assert T.tail_up_plain.calls > tail_calls[1]
    assert all(fn.launches == 0 for fn in (
        S.fv4_stencil_cuda, S.fv4_gsrb2_cuda, S.fv4_gsrb2_cluster_cuda,
        T.tail_down_cuda, T.tail_up_cuda, R.restrict_cell_cuda))


def test_run_benchmark_vcycle_solve():
    """Under CycleType.V a benchmark solve is eleven V-cycles: about a
    digit each, so far below the F-cycle's discretization-error residual."""
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8,
                       cycle=CycleType.V)
    res = run_benchmark(16, cfg, "cpu", min_solve_seconds=0.01, max_solves=1,
                        verbose=False)
    hier, f = build(16, cfg, torch.device("cpu"))
    _, rels = mg_solve_fixed(get_suite("fv4"), hier, f, cfg, num_cycles=11)
    assert res.rel_residual == float(rels[-1])
    assert res.rel_residual < 1e-9 and res.richardson_order is None


def test_bench_main_prints_bench_json(capsys):
    assert bench_main.main(["--n", "16", "--device", "cpu", "--min-seconds",
                            "0.01", "--dynamic-range", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "n", "dtype",
                "smoother", "bottom", "rel_residual", "seconds_per_solve",
                "bicgstab_dof_per_s", "bicgstab_vs_baseline", "device"):
        assert key in out, key
    assert out["metric"] == "fv4_fcycle_dof_per_s_n16" and out["device"] == "cpu"
    assert out["unit"] == "DOF/s" and out["value"] > 0


@pytest.mark.parametrize("op", ["fv4", "fv7pt"])
def test_bench_main_periodic(capsys, op):
    """--bc periodic through the CLI on the CPU: the periodic problem, the
    plain versions, a mean-free solve in the discretization-error regime."""
    calls = T.tail_down_plain.calls
    assert bench_main.main(["--n", "16", "--device", "cpu", "--op", op, "--bc",
                            "periodic", "--min-seconds", "0.01",
                            "--dynamic-range", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == f"{op}_periodic_fcycle_dof_per_s_n16"
    assert out["device"] == "cpu" and 0 < out["rel_residual"] < 2e-2
    assert T.tail_down_plain.calls == calls  # no K4 on periodic levels


def test_profile_schedule_switch_restores_the_schedule():
    from hpgmg_tpu_torch.kernels import stencils_r1 as R

    shipped = (S.GSRB2_MAX_DIM, T.TAIL_FUSE)
    r1_gate = R.GSRB2_MAX_DIM
    assert shipped[0] >= 8 and shipped[1]
    with bench_profile.fused(False):
        assert (S.GSRB2_MAX_DIM, T.TAIL_FUSE) == (0, False)
        assert R.GSRB2_MAX_DIM == r1_gate  # an fv4 run leaves K6's gate
    with bench_profile.schedule(512, True):
        assert S.GSRB2_MAX_DIM == 512
    with bench_profile.fused(False, "fv7pt"):
        assert (R.GSRB2_MAX_DIM, S.GSRB2_MAX_DIM) == (0, shipped[0])
    assert (S.GSRB2_MAX_DIM, T.TAIL_FUSE) == shipped
    assert R.GSRB2_MAX_DIM == r1_gate


def test_entry_points_refuse_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_main.main(["--n", "16"]) == 1
    with pytest.raises(SystemExit, match="CUDA"):
        bench_profile.main(["--n", "16"])
    import chip_smoke

    assert chip_smoke.main() == 1
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py outside a checkout (no hpgmg_tpu_torch) prints no
    result and exits non-zero, whether or not a card is present."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
