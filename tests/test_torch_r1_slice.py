"""The radius-1 slice of the PyTorch port against the JAX package on the
CPU, in float64 (GSRB, DIRECT bottom):

* one F-cycle at 32^3 of fv7pt, fv2 and 27pt (min_coarse_dim 8, each
  suite's default problem) against the JAX XLA path (kernels="xla"): u to
  rel <= 1e-10 (max|port - jax| / max|jax|), rel_res to 1e-10 relative;
  for fv7pt also on the JAX hierarchy carried across by
  hpgmg_tpu_torch.interop (natural face arrays, kdinv rebuilt from dinv);
* the recorded fv7pt goldens of tests/test_golden.py (16^3, V-cycle
  history and F-cycle rel_res), reproduced by the port's mg_solve and
  fmg_solve;
* TEST_ERROR mode (run_test_error) at 32/16/8 against the JAX package's,
  and its observed order of about 2 for fv7pt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)
from test_golden import GOLDEN_FV7PT16_FCYCLE_REL, GOLDEN_FV7PT16_HISTORY, RTOL

from hpgmg_tpu.bench.driver import _build_problem as jproblem
from hpgmg_tpu.bench.driver import run_test_error as jtest_error
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.solve.mg import fmg_solve as jfmg
from hpgmg_tpu_torch.bench.driver import build_problem, run_test_error
from hpgmg_tpu_torch.core.config import BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import fmg_solve, mg_solve

CPU = torch.device("cpu")
N = 32
LEVEL_FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max",
                "bottom_ainv")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def cfgs(op, **kw):
    kw = dict(op=op, a=0.0, b=1.0, min_coarse_dim=8, **kw)
    return (JConfig(dtype=jnp.float64, kernels="xla", bottom=JBottom.DIRECT, **kw),
            SolverConfig(dtype=torch.float64, bottom=BottomSolver.DIRECT, **kw))


@pytest.fixture(scope="module")
def jax_fcycles():
    """The JAX F-cycle at 32^3 per suite: (hierarchy, u, rel_res)."""
    out = {}
    for op in ("fv7pt", "fv2", "27pt"):
        jcfg, _ = cfgs(op)
        prob = jproblem(N, jcfg)
        hier = jbuild(prob.beta_i, prob.beta_j, prob.beta_k, jcfg, alpha=prob.alpha)
        u, nr, nf = jax.jit(lambda h, f, c=jcfg, o=op: jfmg(jsuite(o), h, f, c))(
            hier, prob.f)
        out[op] = (hier, u, float(nr) / float(nf))
    return out


@pytest.mark.parametrize("op", ["fv7pt", "fv2", "27pt"])
def test_fcycle_matches_jax(jax_fcycles, op):
    _, cfg = cfgs(op)
    prob = build_problem(N, cfg, CPU)
    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
    assert hier.levels[0].beta_i.shape == (N + 1, N, N)  # natural faces kept
    u, nr, nf = fmg_solve(get_suite(op), hier, prob.f, cfg)
    _, ju, jrel = jax_fcycles[op]
    assert rel(u, ju) <= 1e-10
    assert abs(float(nr) / float(nf) - jrel) <= 1e-10 * jrel


def test_fv7pt_interop_hierarchy_matches_own_build(jax_fcycles):
    """The JAX-built fv7pt hierarchy carried across gives the port's own
    F-cycle (its levels below 32^3 carry no kdinv: rebuilt from dinv)."""
    _, cfg = cfgs("fv7pt")
    jh = jax_fcycles["fv7pt"][0]
    levels = [{"dim": lv.dim, "h": lv.h, "depth": lv.depth,
               **{f: np.array(getattr(lv, f)) for f in LEVEL_FIELDS
                  if getattr(lv, f) is not None},
               "kdinv": (None if lv.kdinv is None
                         else tuple(np.array(k) for k in lv.kdinv))}
              for lv in jh.levels]
    carried = hierarchy_from_numpy(levels, cfg, "cpu")
    assert carried.levels[0].beta_i.shape == (N + 1, N, N)
    assert all(lv.kdinv is not None for lv in carried.levels)
    prob = build_problem(N, cfg, CPU)
    own = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
    op = get_suite("fv7pt")
    u_c, nr_c, _ = fmg_solve(op, carried, prob.f, cfg)
    u_o, nr_o, _ = fmg_solve(op, own, prob.f, cfg)
    assert float((u_c - u_o).abs().max() / u_o.abs().max()) <= 1e-12
    assert abs(float(nr_c) - float(nr_o)) <= 1e-10 * float(nr_o)


def test_fv7pt_goldens():
    """tests/test_golden.py's fv7pt tables at 16^3 (min_coarse_dim 2,
    DIRECT bottom, problem p6), at the same relative tolerance."""
    cfg = SolverConfig(op="fv7pt", a=0.0, dtype=torch.float64)
    prob = build_problem(16, cfg, CPU)
    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
    op = get_suite("fv7pt")
    _, hist = mg_solve(op, hier, prob.f, cfg)
    assert len(hist) == len(GOLDEN_FV7PT16_HISTORY), hist
    np.testing.assert_allclose(hist, GOLDEN_FV7PT16_HISTORY, rtol=RTOL)
    _, nr, nf = fmg_solve(op, hier, prob.f, cfg)
    np.testing.assert_allclose(float(nr) / float(nf), GOLDEN_FV7PT16_FCYCLE_REL,
                               rtol=RTOL)


@pytest.mark.parametrize("op,problem", [("fv7pt", "p6"), ("27pt", "p4"),
                                        ("fv2", "sine")])
def test_test_error_matches_jax(op, problem):
    """Errors against the analytic u at 32/16/8 equal the JAX package's;
    for fv7pt on p6 the observed order between 32 and 16 is about 2. (The
    27pt operator ignores the problem's beta, and fv2's errors on sine are
    O(1) at these sizes: neither converges here, in either package.)"""
    jcfg, cfg = cfgs(op)
    rows = run_test_error(N, cfg, "cpu", problem=problem, verbose=False)
    jrows = jtest_error(N, jcfg, problem=problem, verbose=False)
    assert [r[0] for r in rows] == [32, 16, 8]
    for (_, emax, el2), (_, jmax, jl2) in zip(rows, jrows):
        assert abs(emax - jmax) <= 1e-9 * jmax and abs(el2 - jl2) <= 1e-9 * jl2
    if op == "fv7pt":
        assert 1.5 < np.log2(rows[1][1] / rows[0][1]) < 2.6
