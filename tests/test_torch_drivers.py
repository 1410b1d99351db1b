"""The drivers and the CLI the port adds, against the JAX package on the
CPU:

* FMGSolve2 and MGPCG at 16^3 fv7pt float64 (problem p6, coarsening to
  2^3, as tests/test_solvers_extra.py runs them): the same number of
  cycles, each relative residual to 1e-6 relative or 1e-15 absolute (CG's
  1e-14), the last below rtol 1e-10;
* the compensated FMGSolve2-DD at 16^3 fv4: its history against the JAX
  package's in float64, and in float32 at 32^3 its lowest residual below
  1e-6 and a fifth of plain FMGSolve2's, u_lo a sub-ulp correction of u_hi
  (tests/test_solvers_extra.py:47-68);
* ``post_f_vcycles``: the F-cycle with two trailing V-cycles equals the JAX
  package's and lowers rel_res;
* a Helmholtz (a = 1.5, alpha of the problem) F-cycle on fv4 and fv7pt at
  16^3 float64 against the JAX XLA path: u to 1e-10 relative;
* ``python -m hpgmg_tpu_torch.bench.cli`` on ``--device cpu`` at n = 16 for
  a smoother, a bottom solver, ``--cycle V``, each ``--driver``,
  ``--test-error`` and the reference-style positionals; without a CUDA
  device the default device makes it exit with 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpgmg_tpu.bench.driver import _build_problem as jproblem
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.problems.p6 import init_problem_p6 as jp6
from hpgmg_tpu.solve.mg import fmg_solve as jfmg
from hpgmg_tpu.solve.mg import fmg_solve2 as jfmg2
from hpgmg_tpu.solve.mg import fmg_solve2_dd as jfmg2dd
from hpgmg_tpu.solve.mg import mgpcg as jmgpcg
from hpgmg_tpu_torch.bench import cli
from hpgmg_tpu_torch.bench.driver import build_problem
from hpgmg_tpu_torch.core.config import BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import fmg_solve, fmg_solve2, fmg_solve2_dd, mgpcg

CPU = torch.device("cpu")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def build_both(op: str, n: int, dtype, problem=None, **kw):
    """The JAX and the port's hierarchy and rhs of ``op``'s problem at n^3
    (``problem`` overrides the suite's default)."""
    kw = {"op": op, "a": 0.0, "b": 1.0, **kw}
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jcfg = JConfig(dtype=jdt, kernels="xla", **kw)
    cfg = SolverConfig(dtype=dtype, **{k: (BottomSolver(v.value) if k == "bottom" else v)
                                       for k, v in kw.items()})
    if problem == "p6":
        jprob = jp6(n, dtype=jdt, a=kw["a"])
    else:
        jprob = jproblem(n, jcfg)
    jh = jbuild(jprob.beta_i, jprob.beta_j, jprob.beta_k, jcfg, alpha=jprob.alpha)
    prob = build_problem(n, cfg, CPU, problem=problem)
    alpha = prob.alpha if cfg.helmholtz else None
    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg, alpha=alpha)
    return jcfg, jh, jprob.f, cfg, hier, prob.f


@pytest.fixture(scope="module")
def fv7pt16():
    return build_both("fv7pt", 16, torch.float64, problem="p6")


def test_fmg_solve2_matches_jax(fv7pt16):
    jcfg, jh, jf, cfg, hier, f = fv7pt16
    _, jhist = jfmg2(jsuite("fv7pt"), jh, jf, jcfg)
    _, hist = fmg_solve2(get_suite("fv7pt"), hier, f, cfg)
    assert len(hist) == len(jhist)
    np.testing.assert_allclose(hist, jhist, rtol=1e-6, atol=1e-15)
    assert hist[-1] < 1e-10


def test_mgpcg_matches_jax(fv7pt16):
    jcfg, jh, jf, cfg, hier, f = fv7pt16
    jx, jhist = jmgpcg(jsuite("fv7pt"), jh, jf, jcfg)
    x, hist = mgpcg(get_suite("fv7pt"), hier, f, cfg)
    assert len(hist) == len(jhist) and len(hist) <= 12
    # CG carries the rounding of the two packages' sums into its last
    # residuals (~1e-11 of the first), so the floor is 1e-14 there
    np.testing.assert_allclose(hist, jhist, rtol=1e-6, atol=1e-14)
    assert hist[-1] < 1e-10
    assert rel(x, jx) <= 1e-9


def test_fmg_solve2_dd_matches_jax_f64():
    jcfg, jh, jf, cfg, hier, f = build_both("fv4", 16, torch.float64, min_coarse_dim=4)
    jcfg, cfg = (dataclasses.replace(c, rtol=1e-12) for c in (jcfg, cfg))
    ju_hi, ju_lo, jhist = jfmg2dd(jsuite("fv4"), jh, jf, jcfg, max_fcycles=6)
    u_hi, u_lo, hist = fmg_solve2_dd(get_suite("fv4"), hier, f, cfg, max_fcycles=6)
    assert len(hist) == len(jhist)
    np.testing.assert_allclose(hist, jhist, rtol=1e-6, atol=1e-15)
    assert rel(u_hi + u_lo, np.asarray(ju_hi) + np.asarray(ju_lo)) <= 1e-10


def test_fmg_solve2_dd_breaks_the_f32_floor():
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float32, rtol=1e-8,
                       min_coarse_dim=4)
    prob = build_problem(32, cfg, CPU, problem="p6")
    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
    op = get_suite("fv4")
    _, plain = fmg_solve2(op, hier, prob.f, cfg, max_fcycles=6)
    u_hi, u_lo, dd = fmg_solve2_dd(op, hier, prob.f, cfg, max_fcycles=6)
    assert np.isfinite(dd).all()
    assert min(dd) < 1e-6 and min(dd) < min(plain) / 5, (plain, dd)
    assert float(u_lo.abs().max()) < 1e-5 * float(u_hi.abs().max())


def test_post_f_vcycles_matches_jax(fv7pt16):
    jcfg, jh, jf, cfg, hier, f = fv7pt16
    jcfg, cfg = (dataclasses.replace(c, post_f_vcycles=2, bottom=b)
                 for c, b in ((jcfg, JBottom.DIRECT), (cfg, BottomSolver.DIRECT)))
    ju, jnr, _ = jax.jit(lambda h, f: jfmg(jsuite("fv7pt"), h, f, jcfg))(jh, jf)
    op = get_suite("fv7pt")
    u, nr, nf = fmg_solve(op, hier, f, cfg)
    assert rel(u, ju) <= 1e-10
    assert abs(float(nr) - float(jnr)) <= 1e-9 * float(jnr)
    _, nr0, _ = fmg_solve(op, hier, f, dataclasses.replace(cfg, post_f_vcycles=0))
    assert float(nr) < 0.1 * float(nr0)


@pytest.mark.parametrize("op", ["fv4", "fv7pt"])
def test_helmholtz_fcycle_matches_jax(op):
    """a * alpha * u - b div(beta grad u) = f with a = 1.5 and the
    problem's alpha (K1's and K5's alpha operand, the rebuilt diagonal),
    DIRECT bottom."""
    jcfg, jh, jf, cfg, hier, f = build_both(op, 16, torch.float64, a=1.5, helmholtz=True,
                                            min_coarse_dim=4, bottom=JBottom.DIRECT)
    assert hier.levels[0].alpha is not None
    ju, jnr, _ = jax.jit(lambda h, f: jfmg(jsuite(op), h, f, jcfg))(jh, jf)
    u, nr, _ = fmg_solve(get_suite(op), hier, f, cfg)
    assert rel(u, ju) <= 1e-10
    assert abs(float(nr) - float(jnr)) <= 1e-9 * float(jnr)


@pytest.mark.parametrize("argv", [
    ["--smoother", "chebyshev", "--bottom", "direct", "--dynamic-range", "1"],
    ["--bottom", "cacg", "--dynamic-range", "1"],
    ["--cycle", "V", "--op", "fv7pt", "--dynamic-range", "1"],
    ["--driver", "fmg2", "--dtype", "float64"],
    ["--driver", "fmg2dd", "--dtype", "float64"],
    ["--driver", "mgpcg", "--op", "fv7pt", "--dtype", "float64"],
    ["--test-error", "--op", "fv7pt"],
    ["3", "8", "--dynamic-range", "1"],
], ids=["smoother", "bottom", "cycle-V", "fmg2", "fmg2dd", "mgpcg", "test-error",
        "positionals"])
def test_cli_on_cpu(capsys, argv):
    if "3" not in argv:
        argv = ["--n", "16"] + argv
    assert cli.main(argv + ["--device", "cpu", "--min-seconds", "0.05"]) == 0
    out = capsys.readouterr().out
    if "--driver" in argv:
        assert "iterations, rel_res=" in out
    elif "--test-error" in argv:
        assert "TEST_ERROR mode" in out and "error_max=" in out
    else:
        assert "DOF/s ==" in out and "device=cpu" in out
    if "3" in argv:
        assert "-> n=16" in out


def test_cli_needs_a_card_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["--n", "16"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_driver_history_is_the_solver_s():
    """run_driver reports the driver's own history and its DOF/s."""
    from hpgmg_tpu_torch.bench.driver import build

    cfg = cli.solver_config(cli.parser().parse_args(
        ["--op", "fv7pt", "--dtype", "float64", "--bottom", "direct"]))
    res = cli.run_driver("fmg2", 16, cfg, "cpu", verbose=False)
    hier, f = build(16, cfg, CPU)
    _, hist = fmg_solve2(get_suite("fv7pt"), hier, f, cfg)
    assert res["history"] == hist and res["iterations"] == len(hist)
    assert res["dof_per_second"] == 16 ** 3 / res["seconds"]
