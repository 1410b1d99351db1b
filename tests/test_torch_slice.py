"""The whole slice of the PyTorch port against the JAX package on the CPU:
one fv4 F-cycle at 32^3 in float64 (GSRB, DIRECT bottom, min_coarse_dim
8) and the Richardson order over 32/16/8, against the JAX XLA path
(kernels="xla"). Once on the port's own hierarchy build, once on the JAX
hierarchy carried across by hpgmg_tpu_torch.interop. u agrees to rel <=
1e-9 (max|port - jax| / max|jax|), rel_res and the order to 1e-6
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.problems.fv import init_problem_fv as jinit
from hpgmg_tpu.solve.mg import fmg_solve as jfmg
from hpgmg_tpu.solve.mg import richardson_error as jrichardson
from hpgmg_tpu_torch.core.config import BottomSolver, CycleType, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.problems.fv import init_problem_fv
from hpgmg_tpu_torch.solve.mg import (MGSolver, fmg_solve, mg_solve,
                                      mg_solve_fixed, richardson_error, vcycle)

CPU = torch.device("cpu")
JCFG = JConfig(op="fv4", a=0.0, b=1.0, dtype=jnp.float64, kernels="xla",
               bottom=JBottom.DIRECT, min_coarse_dim=8)
CFG = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64,
                   bottom=BottomSolver.DIRECT, min_coarse_dim=8)
LEVEL_FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max",
                "bottom_ainv")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX F-cycle at 32, 16 and 8: (hierarchy, u, rel_res) each."""
    solve = jax.jit(lambda h, f: jfmg(jsuite("fv4"), h, f, JCFG))
    out = {}
    for n in (32, 16, 8):
        prob = jinit(n, dtype=jnp.float64)
        hier = jbuild(prob.beta_i, prob.beta_j, prob.beta_k, JCFG, alpha=prob.alpha)
        u, nr, nf = solve(hier, prob.f)
        out[n] = (hier, u, float(nr) / float(nf))
    return out


def _port_hierarchy(n, source, jax_solves):
    if source == "port":
        prob = init_problem_fv(n, torch.float64, CPU)
        return build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, CFG), prob.f
    jh = jax_solves[n][0]
    levels = [{"dim": lv.dim, "h": lv.h, "depth": lv.depth,
               **{f: np.array(getattr(lv, f)) for f in LEVEL_FIELDS
                  if getattr(lv, f) is not None},
               "kdinv": (None if lv.kdinv is None
                         else tuple(np.array(k) for k in lv.kdinv))}
              for lv in jh.levels]
    f = torch.tensor(np.array(jinit(n, dtype=jnp.float64).f))
    return hierarchy_from_numpy(levels, CFG, "cpu"), f


@pytest.mark.parametrize("source", ["port", "interop"])
def test_fcycle_and_order_match_jax(jax_solves, source):
    op = get_suite("fv4")
    sols = []
    for n in (32, 16, 8):
        hier, f = _port_hierarchy(n, source, jax_solves)
        u, nr, nf = fmg_solve(op, hier, f, CFG)
        _, ju, jrel = jax_solves[n]
        assert rel(u, ju) <= 1e-9, n
        if n > 8:  # at 8^3 the ladder is the exact DIRECT solve: roundoff
            assert abs(float(nr) / float(nf) - jrel) <= 1e-6 * jrel, n
        sols.append(u)
    _, order = richardson_error(op, *sols)
    _, jorder = jrichardson(jsuite("fv4"), *(jax_solves[n][1] for n in (32, 16, 8)))
    assert abs(float(order) - float(jorder)) <= 1e-6 * abs(float(jorder))
    # the one-F-cycle oracle: discretization-error regime at 32^3
    assert jax_solves[32][2] < 1e-3


def test_vcycles_converge_and_fixed_count_agrees(jax_solves):
    """MGSolve: the V-cycle residual drops about a digit per cycle, and
    the fixed-count variant takes the same path."""
    hier, f = _port_hierarchy(16, "port", jax_solves)
    op = get_suite("fv4")
    cfg = SolverConfig(op="fv4", a=0.0, dtype=torch.float64, min_coarse_dim=8,
                       cycle=CycleType.V,
                       max_vcycles=4, rtol=1e-30)
    u, hist = mg_solve(op, hier, f, cfg)
    assert len(hist) == 4
    assert all(b < 0.2 * a for a, b in zip(hist, hist[1:])), hist
    u2, rels = mg_solve_fixed(op, hier, f, cfg, num_cycles=4)
    assert torch.equal(u, u2)
    assert np.allclose(rels.numpy(), hist, rtol=1e-14)
    e = vcycle(op, hier.levels, 0, torch.zeros_like(f), f, cfg)
    assert torch.equal(e, mg_solve_fixed(op, hier, f, cfg, num_cycles=1)[0])
    uf, hist_f = MGSolver(hier, CFG).solve(f)
    assert len(hist_f) == 1 and hist_f[0] < 1e-2
