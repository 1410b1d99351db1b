"""The periodic slice of the PyTorch port against the JAX package on the
CPU, in float64 (GSRB, DIRECT bottom, min_coarse_dim 8, --bc periodic):

* one F-cycle of fv4 at 32^3 (the periodic fv problem) and of fv7pt, fv2
  and 27pt at 16^3 (the periodic p6 problem) against the JAX XLA path
  (kernels="xla"): u to rel <= 1e-10 (max|port - jax| / max|jax|), rel_res
  to 1e-8 relative, and mean(u) = 0 to 1e-12 of max|u| (the singular
  operator's constant null space projected out);
* the Richardson order over 32/16/8 of fv4 and fv7pt, equal to the JAX
  package's to 1e-8 relative;
* the JAX periodic fv4 hierarchy (wrapped betas, pseudo-inverted bottom)
  carried across by hpgmg_tpu_torch.interop gives the port's own F-cycle;
* the plain versions a periodic F-cycle calls: K7a's or K7b's, never K2's,
  K4's or K6's, which the same Dirichlet F-cycle does call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.bench.driver import _build_problem as jproblem
from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.solve.mg import fmg_solve as jfmg
from hpgmg_tpu.solve.mg import richardson_error as jrichardson
from hpgmg_tpu_torch.bench.driver import build_problem
from hpgmg_tpu_torch.core.config import BC, BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import stencils_r1 as K
from hpgmg_tpu_torch.kernels import tail as T
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import fmg_solve, richardson_error

CPU = torch.device("cpu")
SIZE = {"fv4": 32, "fv7pt": 16, "fv2": 16, "27pt": 16}
LEVEL_FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max",
                "bottom_ainv")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def problem(op):
    return "fv" if op == "fv4" else "p6"


def cfgs(op, bc=BC.PERIODIC):
    kw = dict(op=op, a=0.0, b=1.0, min_coarse_dim=8)
    return (JConfig(dtype=jnp.float64, kernels="xla", bottom=JBottom.DIRECT,
                    bc=JBC(bc.value), **kw),
            SolverConfig(dtype=torch.float64, bottom=BottomSolver.DIRECT, bc=bc, **kw))


def jax_fcycle(op, n):
    """The JAX periodic F-cycle at n^3: (hierarchy, u, rel_res)."""
    jcfg, _ = cfgs(op)
    prob = jproblem(n, jcfg, problem(op))
    hier = jbuild(prob.beta_i, prob.beta_j, prob.beta_k, jcfg, alpha=prob.alpha)
    u, nr, nf = jax.jit(lambda h, f: jfmg(jsuite(op), h, f, jcfg))(hier, prob.f)
    return hier, u, float(nr) / float(nf)


def port_fcycle(op, n, hier=None):
    _, cfg = cfgs(op)
    prob = build_problem(n, cfg, CPU, problem(op))
    if hier is None:
        hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
    u, nr, nf = fmg_solve(get_suite(op), hier, prob.f, cfg)
    return u, float(nr) / float(nf)


@pytest.fixture(scope="module")
def jax_solves():
    return {(op, n): jax_fcycle(op, n)
            for op, sizes in (("fv4", (32, 16, 8)), ("fv7pt", (32, 16, 8)),
                              ("fv2", (16,)), ("27pt", (16,)))
            for n in sizes}


@pytest.mark.parametrize("op", ["fv4", "fv7pt", "fv2", "27pt"])
def test_periodic_fcycle_matches_jax(jax_solves, op):
    n = SIZE[op]
    u, rel_res = port_fcycle(op, n)
    _, ju, jrel = jax_solves[(op, n)]
    assert rel(u, ju) <= 1e-10
    assert abs(rel_res - jrel) <= 1e-8 * jrel
    assert abs(float(u.mean())) <= 1e-12 * float(u.abs().max())
    assert jrel < 2e-2  # one F-cycle reaches the discretization-error regime


@pytest.mark.parametrize("op", ["fv4", "fv7pt"])
def test_periodic_richardson_order_matches_jax(jax_solves, op):
    sols = [port_fcycle(op, n)[0] for n in (32, 16, 8)]
    _, order = richardson_error(get_suite(op), *sols)
    _, jorder = jrichardson(jsuite(op), *(jax_solves[(op, n)][1] for n in (32, 16, 8)))
    assert abs(float(order) - float(jorder)) <= 1e-8 * abs(float(jorder))


def test_periodic_interop_hierarchy(jax_solves):
    """The JAX periodic fv4 hierarchy at 32^3 carried across as it is: its
    tangentially wrapped betas and pinv bottom solve the port's F-cycle to
    the port's own build and to the JAX package's u."""
    jh, ju, _ = jax_solves[("fv4", 32)]
    _, cfg = cfgs("fv4")
    carried = hierarchy_from_numpy(
        [{"dim": lv.dim, "h": lv.h, "depth": lv.depth,
          **{f: np.array(getattr(lv, f)) for f in LEVEL_FIELDS
             if getattr(lv, f) is not None},
          "kdinv": (None if lv.kdinv is None
                    else tuple(np.array(k) for k in lv.kdinv))}
         for lv in jh.levels], cfg, "cpu")
    assert carried.levels[0].beta_i.shape == (33, 34, 34)
    assert carried.levels[-1].bottom_ainv.shape == (512, 512)
    u_c, rel_c = port_fcycle("fv4", 32, carried)
    u_o, rel_o = port_fcycle("fv4", 32)
    assert rel(u_c, u_o.numpy()) <= 1e-12
    assert abs(rel_c - rel_o) <= 1e-10 * rel_o
    assert rel(u_c, ju) <= 1e-10


@pytest.mark.parametrize("op", ["fv4", "fv7pt"])
def test_periodic_fcycle_takes_no_fused_kernel(op):
    """Plain-version calls during a 16^3 F-cycle: periodic runs K7a (fv4)
    or K7b (fv7pt) and never K2, K4 or K6; the Dirichlet F-cycle of the
    same problem does run them (fv4 at 16^3: the K4 tail)."""
    counters = (S.fv4_stencil_plain, K.r1_stencil_plain, S.fv4_gsrb2_plain,
                K.r1_gsrb2_plain, T.tail_down_plain, T.tail_up_plain, T.tail_v_plain)
    for bc in (BC.PERIODIC, BC.DIRICHLET):
        _, cfg = cfgs(op, bc)
        prob = build_problem(16, cfg, CPU, problem(op))
        hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
        before = [c.calls for c in counters]
        fmg_solve(get_suite(op), hier, prob.f, cfg)
        calls = dict(zip(("fv4", "r1", "k2", "k6", "down", "up", "v"),
                         (c.calls - b for c, b in zip(counters, before))))
        stencil, fused = ("fv4", ("k2", "down", "up")) if op == "fv4" else ("r1", ("k6",))
        assert calls[stencil] > 0
        if bc == BC.PERIODIC:
            assert not any(calls[k] for k in ("k2", "k6", "down", "up", "v")), calls
        else:
            assert any(calls[k] > 0 for k in fused), calls
