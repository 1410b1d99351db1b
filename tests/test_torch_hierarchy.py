"""Hierarchy build of the PyTorch port (hpgmg_tpu_torch) against the JAX
package on the CPU: every level's fields and the DIRECT bottom inverse,
rel <= 1e-12 in float64 and 1e-5 in float32 (rel = max|port - jax| /
max|jax|); plus slimming and the numpy interop.

Both packages start from the same fine-level coefficients (the port's
problem fields, copied). In float32 the JAX build runs op by op
(``jit=False``), as the port computes: the doubly-extrapolated corner
entries of the extended betas (which the stencil never reads) amplify
rounding ~1000x, so XLA's fused evaluation of the extrapolation (or a
1-ulp difference in the inputs) moves them by ~1e-5. In float64 that is
~1e-13, so there the JAX build runs jitted (faster).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu_torch.core.config import BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import (build_hierarchy, level_dims,
                                            slim_hierarchy)
from hpgmg_tpu_torch.core.level import rb_mask
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.problems.fv import init_problem_fv

CPU = torch.device("cpu")
DTYPES = {"f64": (torch.float64, jnp.float64, 1e-12),
          "f32": (torch.float32, jnp.float32, 1e-5)}
FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max")


def rel(port, ref) -> float:
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.max(np.abs(port - ref)) / np.max(np.abs(ref)))


def _both(n, dt, min_coarse_dim):
    tdt, jdt, tol = DTYPES[dt]
    prob = init_problem_fv(n, tdt, CPU)
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=tdt,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=min_coarse_dim)
    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg,
                           alpha=prob.alpha)
    jcfg = JConfig(op="fv4", a=0.0, b=1.0, dtype=jdt, kernels="xla",
                   bottom=JBottom.DIRECT, min_coarse_dim=min_coarse_dim)
    jin = [jnp.asarray(getattr(prob, f).numpy())
           for f in ("beta_i", "beta_j", "beta_k", "alpha")]
    jh = jbuild(*jin[:3], jcfg, alpha=jin[3], jit=dt == "f64")
    return hier, jh, tdt, tol


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n,min_coarse_dim", [(16, 4), (32, 8)])
def test_build_hierarchy(n, min_coarse_dim, dt):
    """Per-level fields, the parity-folded kdinv pair and the DIRECT
    bottom inverse."""
    hier, jh, tdt, tol = _both(n, dt, min_coarse_dim)
    assert [lv.dim for lv in hier.levels] == [lv.dim for lv in jh.levels]
    assert [lv.dim for lv in hier.levels] == level_dims(n, min_coarse_dim)
    for lv, jlv in zip(hier.levels, jh.levels):
        assert lv.h == jlv.h and lv.depth == jlv.depth
        for name in FIELDS + ("l1inv",):
            out = getattr(lv, name)
            assert out.dtype == tdt
            assert rel(out, getattr(jlv, name)) <= tol, (lv.dim, name)
        for p in (0, 1):
            assert torch.equal(lv.kdinv[p], rb_mask(lv.dim, p, tdt, CPU) * lv.dinv)
            if jlv.kdinv is not None:
                assert rel(lv.kdinv[p], jlv.kdinv[p]) <= tol
    assert rel(hier.levels[-1].bottom_ainv, jh.levels[-1].bottom_ainv) <= tol


def test_hierarchy_from_numpy_carries_jax_levels():
    """Every JAX level field arrives unchanged; kdinv is rebuilt from dinv
    where the JAX level has none."""
    _, jh, _, _ = _both(16, "f64", 4)
    cfg = SolverConfig(op="fv4", a=0.0, dtype=torch.float64, min_coarse_dim=4)
    levels = [{"dim": lv.dim, "h": lv.h, "depth": lv.depth,
               **{f: np.array(getattr(lv, f)) for f in FIELDS + ("bottom_ainv",)
                  if getattr(lv, f) is not None},
               "kdinv": (None if lv.kdinv is None
                         else tuple(np.array(k) for k in lv.kdinv))}
              for lv in jh.levels]
    assert any(lv["kdinv"] is None for lv in levels)
    hier = hierarchy_from_numpy(levels, cfg, "cpu")
    for lv, src in zip(hier.levels, levels):
        assert lv.dim == src["dim"] and lv.h == src["h"]
        for f in FIELDS:
            assert np.array_equal(getattr(lv, f).numpy(), src[f])
        for p in (0, 1):
            want = (src["kdinv"][p] if src["kdinv"] is not None
                    else rb_mask(lv.dim, p, torch.float64, CPU).numpy() * src["dinv"])
            assert np.array_equal(lv.kdinv[p].numpy(), want)
    assert np.array_equal(hier.levels[-1].bottom_ainv.numpy(), levels[-1]["bottom_ainv"])
    assert hier.levels[0].bottom_ainv is None


def test_slim_hierarchy_keeps_what_gsrb_reads():
    cfg = SolverConfig(op="fv4", a=0.0, dtype=torch.float64, min_coarse_dim=4,
                       bottom=BottomSolver.BICGSTAB)
    prob = init_problem_fv(16, torch.float64, CPU)
    hier = slim_hierarchy(build_hierarchy(prob.beta_i, prob.beta_j,
                                          prob.beta_k, cfg), cfg)
    assert all(lv.l1inv is None and lv.kdinv is not None for lv in hier.levels)
    assert all(lv.dinv is None for lv in hier.levels[:-1])
    assert hier.levels[-1].dinv is not None  # BiCGStab preconditions with it
    assert all(lv.bottom_ainv is None for lv in hier.levels)


def test_direct_bottom_rejects_large_coarsest_grid():
    cfg = SolverConfig(op="fv4", a=0.0, dtype=torch.float64, min_coarse_dim=32)
    prob = init_problem_fv(32, torch.float64, CPU)
    with pytest.raises(ValueError, match="DIRECT bottom"):
        build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
