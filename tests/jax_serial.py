"""The JAX package's serial solves that the port's decomposed runs
(tests/torch_ranks.py:solve_body) are held to: the same case tuple
(driver, op, bc, smoother, bottom, min_coarse_dim, n, a), the XLA path
(kernels="xla") in float64, b = 1, Helmholtz where a is not 0, on the
benchmark problem of the suite (hpgmg_tpu/bench/driver.py:_build_problem).
Used by tests/test_torch_parallel_cases.py and tests/test_torch_mesh3d.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from hpgmg_tpu.bench.driver import _build_problem
from hpgmg_tpu.core.config import BC, BottomSolver, Smoother, SolverConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy
from hpgmg_tpu.ops.base import get_suite
from hpgmg_tpu.solve import mg


def rel_diff(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(port) - ref)) / np.max(np.abs(ref)))


@functools.lru_cache(maxsize=None)
def solve(case):
    """(u, rel): rel the relative residual ("fcycle", "timed") or the list
    of relative residuals ("vcycles", "mgpcg", "fmg2")."""
    driver, op, bc, smoother, bottom, mcd, n, a = case
    cfg = SolverConfig(op=op, bc=BC(bc), a=a, b=1.0, helmholtz=a != 0.0,
                       smoother=Smoother(smoother), bottom=BottomSolver(bottom),
                       min_coarse_dim=mcd, dtype=jnp.float64, kernels="xla")
    prob = _build_problem(n, cfg)
    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg, alpha=prob.alpha)
    suite = get_suite(op)
    if driver in ("fcycle", "timed"):
        u, nr, nf = jax.jit(lambda h, f: mg.fmg_solve(suite, h, f, cfg))(hier, prob.f)
        return np.asarray(u), float(nr) / float(nf)
    if driver == "vcycles":
        u, rels = jax.jit(lambda h, f: mg.mg_solve_fixed(suite, h, f, cfg, num_cycles=3))(
            hier, prob.f)
        return np.asarray(u), [float(r) for r in np.asarray(rels)]
    if driver == "mgpcg":
        u, hist = mg.mgpcg(suite, hier, prob.f, cfg, max_iters=4)
    else:
        u, hist = mg.fmg_solve2(suite, hier, prob.f, cfg, max_fcycles=2)
    return np.asarray(u), [float(r) for r in hist]
