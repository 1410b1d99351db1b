"""The smoothers the port adds (Chebyshev, weighted Jacobi, L1-Jacobi,
SymGS) against the JAX package on the CPU, in float64:

* one smoother call on a 16^3 level of fv4 and of fv7pt against the JAX
  ``smooth`` on the XLA path (kernels="xla"), rel <= 1e-12 (max|port -
  jax| / max|jax|), on the JAX level carried across by
  hpgmg_tpu_torch.interop (dinv, l1inv, lambda_max; kdinv rebuilt from
  dinv);
* each suite's Chebyshev degree (fv4 6, fv2 6, 27pt 4, fv7pt the default
  4) equals the JAX suite's;
* interop carries l1inv (it did not: an L1-Jacobi hierarchy taken from the
  JAX package smoothed with nothing);
* a smoother whose field a slimmed hierarchy dropped raises.

Each smoother's residuals go through the suite's kernel entry (K1, K1s or
K5 on CUDA; their plain versions here).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpgmg_tpu.bench.driver import _build_problem as jproblem
from hpgmg_tpu.core.config import Smoother as JSmoother
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.solve.smoothers import smooth as jsmooth
from hpgmg_tpu_torch.core.config import Smoother, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import slim_hierarchy
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.smoothers import smooth

N = 16
TOL = 1e-12
FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "l1inv", "lambda_max")
SMOOTHERS = ("chebyshev", "jacobi", "l1jacobi", "symgs")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def carried(jhier, cfg):
    """The JAX hierarchy's levels as the port's, through interop."""
    return hierarchy_from_numpy(
        [{"dim": lv.dim, "h": lv.h, "depth": lv.depth,
          **{f: np.array(getattr(lv, f)) for f in FIELDS if getattr(lv, f) is not None}}
         for lv in jhier.levels], cfg, "cpu")


@pytest.fixture(scope="module")
def levels():
    """Per suite: the JAX 16^3 hierarchy, its carried copy, and x, rhs."""
    out = {}
    rng = np.random.default_rng(16)
    for op in ("fv4", "fv7pt"):
        jcfg = JConfig(op=op, a=0.0, b=1.0, dtype=jnp.float64, kernels="xla",
                       min_coarse_dim=8)
        prob = jproblem(N, jcfg)
        jh = jbuild(prob.beta_i, prob.beta_j, prob.beta_k, jcfg, alpha=prob.alpha)
        cfg = SolverConfig(op=op, a=0.0, b=1.0, dtype=torch.float64, min_coarse_dim=8)
        out[op] = (jcfg, jh, cfg, carried(jh, cfg), *rng.standard_normal((2, N, N, N)))
    return out


@pytest.mark.parametrize("smoother", SMOOTHERS)
@pytest.mark.parametrize("op", ["fv4", "fv7pt"])
def test_smoother_matches_jax(levels, op, smoother):
    jcfg, jh, cfg, hier, x, rhs = levels[op]
    jcfg = dataclasses.replace(jcfg, smoother=JSmoother(smoother))
    cfg = dataclasses.replace(cfg, smoother=Smoother(smoother))
    want = jsmooth(jsuite(op), jh.levels[0], jnp.asarray(x), jnp.asarray(rhs), jcfg)
    out = smooth(get_suite(op), hier.levels[0], torch.tensor(x), torch.tensor(rhs), cfg)
    assert rel(out, want) <= TOL


@pytest.mark.parametrize("op,degree", [("fv4", 6), ("fv2", 6), ("27pt", 4), ("fv7pt", 4)])
def test_chebyshev_degree_per_suite(op, degree):
    cfg = SolverConfig(op=op, smoother=Smoother.CHEBYSHEV)
    jcfg = JConfig(op=op, smoother=JSmoother.CHEBYSHEV)
    assert cfg.resolved_chebyshev_degree(get_suite(op)) == degree
    assert jcfg.resolved_chebyshev_degree(jsuite(op)) == degree
    assert dataclasses.replace(cfg, chebyshev_degree=2).resolved_chebyshev_degree(
        get_suite(op)) == 2


def test_interop_carries_l1inv(levels):
    """Every level's l1inv arrives as the JAX package built it, and
    L1-Jacobi on a coarse carried level equals the JAX smoother there."""
    jcfg, jh, cfg, hier, _, _ = levels["fv4"]
    for jlv, lv in zip(jh.levels, hier.levels):
        assert lv.l1inv is not None
        assert rel(lv.l1inv, jlv.l1inv) == 0.0
    jlv, lv = jh.levels[1], hier.levels[1]
    rhs = np.random.default_rng(8).standard_normal(lv.shape)
    jcfg = dataclasses.replace(jcfg, smoother=JSmoother.L1JACOBI)
    cfg = dataclasses.replace(cfg, smoother=Smoother.L1JACOBI)
    want = jsmooth(jsuite("fv4"), jlv, jnp.zeros(lv.shape), jnp.asarray(rhs), jcfg)
    out = smooth(get_suite("fv4"), lv, torch.zeros(lv.shape, dtype=torch.float64),
                 torch.tensor(rhs), cfg)
    assert rel(out, want) <= TOL


def test_smoother_refuses_a_dropped_field(levels):
    """slim_hierarchy for GSRB drops l1inv everywhere and dinv above the
    bottom: L1-Jacobi and Jacobi on such a level raise instead of smoothing
    with nothing."""
    _, _, cfg, hier, x, rhs = levels["fv7pt"]
    slim = slim_hierarchy(hier, cfg).levels[0]  # cfg.smoother is GSRB
    assert slim.l1inv is None and slim.dinv is None
    for name in ("l1jacobi", "jacobi", "chebyshev"):
        with pytest.raises(ValueError, match="slim_hierarchy"):
            smooth(get_suite("fv7pt"), slim, torch.tensor(x), torch.tensor(rhs),
                   dataclasses.replace(cfg, smoother=Smoother(name)))
