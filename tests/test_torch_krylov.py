"""The bottom solvers the port adds (CG, smooth-until-converged, CABiCGStab
and CACG, ``solve/bottom.py`` and ``solve/ca_krylov.py``) against the JAX
package on the CPU:

* one bottom solve on the 8^3 fv7pt level of the JAX hierarchy (carried
  across by hpgmg_tpu_torch.interop), float64, rel <= 1e-10 (max|port -
  jax| / max|jax|);
* the V-cycle histories of mg_solve at 16^3 fv7pt float64 (problem p6,
  coarsening to 2^3, as tests/test_solvers_extra.py runs them): the same
  number of cycles, each relative residual to 1e-6 relative or 1e-15
  absolute (the last ones are ~1e-10 of ||f||, where the rounding of the
  two packages' sums shows), the last below rtol 1e-10;
* the scaled monomial basis in float32: a 32^3 fv4 F-cycle over a 4^3
  CABiCGStab or CACG bottom stays finite and reaches rel_res < 1e-2 (the
  raw basis overflows the Gram matrix to NaN, tests/test_solvers_extra.py);
* CABiCGStab's s = 1, 2, 4 telescoping converges as fixed s = 4 does, and
  each history equals the JAX package's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.problems.p6 import init_problem_p6 as jp6
from hpgmg_tpu.solve.bottom import bottom_solve as jbottom_solve
from hpgmg_tpu.solve.mg import mg_solve as jmg_solve
from hpgmg_tpu_torch.bench.driver import build_problem
from hpgmg_tpu_torch.core.config import BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.bottom import bottom_solve
from hpgmg_tpu_torch.solve.mg import fmg_solve, mg_solve

CPU = torch.device("cpu")
BOTTOMS = ("cg", "smooth", "cabicgstab", "cacg")
FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "l1inv", "lambda_max")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def cfgs(bottom: str, **kw):
    kw = dict(op="fv7pt", a=0.0, b=1.0, **kw)
    return (JConfig(dtype=jnp.float64, bottom=JBottom(bottom), **kw),
            SolverConfig(dtype=torch.float64, bottom=BottomSolver(bottom), **kw))


@pytest.fixture(scope="module")
def fv7pt16():
    """The 16^3 fv7pt problem: the JAX hierarchy and rhs, the port's."""
    jcfg, cfg = cfgs("cg")
    jprob = jp6(16, dtype=jnp.float64, a=0.0)
    jh = jbuild(jprob.beta_i, jprob.beta_j, jprob.beta_k, jcfg, alpha=jprob.alpha)
    prob = build_problem(16, cfg, CPU)
    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
    return jh, jprob.f, hier, prob.f


@pytest.mark.parametrize("bottom", BOTTOMS)
def test_bottom_solve_matches_jax(fv7pt16, bottom):
    jh, _, _, _ = fv7pt16
    jcfg, cfg = cfgs(bottom)
    jlv = jh.levels[1]
    assert jlv.dim == 8
    lv = hierarchy_from_numpy([{"dim": jlv.dim, "h": jlv.h, "depth": 1,
                                **{f: np.array(getattr(jlv, f)) for f in FIELDS}}],
                              cfg, "cpu").levels[0]
    rhs = np.random.default_rng(8).standard_normal(lv.shape)
    want = jbottom_solve(jsuite("fv7pt"), jlv, jnp.zeros(lv.shape), jnp.asarray(rhs), jcfg)
    out = bottom_solve(get_suite("fv7pt"), lv, torch.zeros(lv.shape, dtype=torch.float64),
                       torch.tensor(rhs), cfg)
    assert rel(out, want) <= 1e-10


@pytest.mark.parametrize("bottom", BOTTOMS)
def test_mg_solve_history_matches_jax(fv7pt16, bottom):
    jh, jf, hier, f = fv7pt16
    jcfg, cfg = cfgs(bottom)
    _, jhist = jmg_solve(jsuite("fv7pt"), jh, jf, jcfg)
    _, hist = mg_solve(get_suite("fv7pt"), hier, f, cfg)
    assert len(hist) == len(jhist), (hist, jhist)
    np.testing.assert_allclose(hist, jhist, rtol=1e-6, atol=1e-15)
    assert hist[-1] < 1e-10


@pytest.mark.parametrize("bottom", ["cabicgstab", "cacg"])
def test_f32_scaled_basis_stays_finite(bottom):
    """The production dtype the reference never runs: A^8 r at a 4^3 fv4
    bottom is ~1e18 |r| and its Gram square overflows float32 unless the
    basis is scaled."""
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float32,
                       bottom=BottomSolver(bottom), min_coarse_dim=4)
    prob = build_problem(32, cfg, CPU, problem="p6")
    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
    assert hier.levels[-1].dim == 4
    _, nr, nf = fmg_solve(get_suite("fv4"), hier, prob.f, cfg)
    r = float(nr) / float(nf)
    assert np.isfinite(r) and r < 1e-2, r


def test_telescoping_matches_fixed_s(fv7pt16):
    """CABiCGStab with s = 1, 2, 4 (the default) and with s = 4 from the
    start both drive MGSolve to rtol, each with the JAX package's
    history."""
    jh, jf, hier, f = fv7pt16
    for telescoping in (True, False):
        jcfg, cfg = cfgs("cabicgstab", cabicgstab_telescoping=telescoping)
        _, jhist = jmg_solve(jsuite("fv7pt"), jh, jf, jcfg)
        _, hist = mg_solve(get_suite("fv7pt"), hier, f, cfg)
        assert hist[-1] < 1e-10, (telescoping, hist)
        assert len(hist) == len(jhist)
        np.testing.assert_allclose(hist, jhist, rtol=1e-6, atol=1e-15)


def test_telescoping_is_the_default():
    assert SolverConfig().cabicgstab_telescoping
    assert dataclasses.replace(SolverConfig(), cabicgstab_telescoping=False) != SolverConfig()
