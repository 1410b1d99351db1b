"""Per-module parity of the port's periodic-BC path with the JAX package on
the CPU, float64: the periodic ghost fills (every ghost cell, edges and
corners included), the tangential beta wrap, the p0/p1/p2/v2/v4
interpolations, the periodic fv problem, the fv7pt validity masks, the
pseudo-inverted DIRECT bottom and the mean-projected bottom solves. The
same seeded numpy inputs go through the JAX function and its port;
rel = max|port - jax| / max|jax| <= 1e-12 unless a test states otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops import bc as jbc
from hpgmg_tpu.ops import bc_fv as jbc_fv
from hpgmg_tpu.ops import transfer as jtr
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.ops.fv7pt import _valid_masks as jvalid_masks
from hpgmg_tpu.problems.fv import init_problem_fv as jinit_fv
from hpgmg_tpu.problems.p6 import init_problem_p6 as jinit_p6
from hpgmg_tpu.solve.bottom import bottom_solve as jbottom_solve
from hpgmg_tpu_torch.core import blas
from hpgmg_tpu_torch.core.config import BC, BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import direct_bottom_inverse
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.ops import bc, bc_fv, transfer
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.ops.fv7pt import _valid_masks
from hpgmg_tpu_torch.problems.fv import init_problem_fv
from hpgmg_tpu_torch.solve.bottom import bottom_solve

TOL = 1e-12
CPU = torch.device("cpu")
FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max",
          "bottom_ainv")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("fill,radius", [("ghost_fill_linear", 1),
                                         ("ghost_fill_linear", 2),
                                         ("ghost_fill_quadratic_fd", 1)])
def test_periodic_fd_ghost_fills(n, fill, radius):
    a = np.random.default_rng(n + radius).standard_normal((n, n, n))
    out = getattr(bc, fill)(torch.tensor(a), BC.PERIODIC, radius=radius)
    ref = getattr(jbc, fill)(jnp.asarray(a), JBC.PERIODIC, radius=radius)
    assert out.shape == ref.shape == (n + 2 * radius,) * 3
    assert rel(out, ref) <= TOL
    # a corner ghost is the opposite corner cell
    assert out[0, 0, 0] == torch.tensor(a)[n - radius, n - radius, n - radius]


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("order,radius", [(1, 1), (2, 1), (4, 2)])
def test_periodic_ghost_fill_fv(n, order, radius):
    a = np.random.default_rng(n + order).standard_normal((n, n, n))
    out = bc_fv.ghost_fill_fv(torch.tensor(a), BC.PERIODIC, order, radius)
    ref = jbc_fv.ghost_fill_fv(jnp.asarray(a), JBC.PERIODIC, order, radius)
    assert out.shape == ref.shape == (n + 2 * radius,) * 3
    assert rel(out, ref) <= TOL


@pytest.mark.parametrize("n", [16, 32])
def test_periodic_extend_beta_tangential(n):
    rng = np.random.default_rng(n + 3)
    for axis in range(3):
        shape = [n, n, n]
        shape[axis] += 1
        b = rng.standard_normal(shape)
        out = bc_fv.extend_beta_tangential(torch.tensor(b), axis, BC.PERIODIC)
        ref = jbc_fv.extend_beta_tangential(jnp.asarray(b), axis, JBC.PERIODIC)
        assert out.shape == ref.shape
        assert out.shape[axis] == n + 1  # the face axis is not wrapped
        assert rel(out, ref) <= TOL


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("name", ["p0", "p1", "p2", "v2", "v4"])
def test_periodic_interpolations(n, name):
    rng = np.random.default_rng(n + len(name))
    m = n // 2
    xc, xf = rng.standard_normal((m, m, m)), rng.standard_normal((n, n, n))
    port = transfer.get_interpolation(name)
    ref = jtr.get_interpolation(name)
    for prescale in (0.0, 1.0):
        out = port(torch.tensor(xc), prescale, torch.tensor(xf), BC.PERIODIC)
        want = ref(jnp.asarray(xc), prescale, jnp.asarray(xf), JBC.PERIODIC)
        assert out.is_contiguous()
        assert rel(out, want) <= TOL
    # a constant coarse field interpolates to the same constant
    ones = port(torch.ones((m, m, m), dtype=torch.float64), 0.0, None, BC.PERIODIC)
    assert torch.allclose(ones, torch.ones_like(ones), rtol=0, atol=1e-14)


@pytest.mark.parametrize("n", [16, 32])
def test_periodic_problem_fv(n):
    prob = init_problem_fv(n, torch.float64, CPU, periodic=True)
    jprob = jinit_fv(n, dtype=jnp.float64, periodic=True)
    assert abs(float(blas.mean(prob.f))) <= 1e-15 * float(blas.norm(prob.f))
    for f in ("beta_i", "beta_j", "beta_k", "f"):
        assert rel(getattr(prob, f), getattr(jprob, f)) <= TOL
    dirichlet = init_problem_fv(n, torch.float64, CPU)
    assert torch.equal(dirichlet.beta_i, prob.beta_i)


def test_fv7pt_valid_masks():
    for n in (2, 16):
        for b, jb in ((BC.PERIODIC, JBC.PERIODIC), (BC.DIRICHLET, JBC.DIRICHLET)):
            lo, hi = _valid_masks(n, b, torch.float64, CPU)
            jlo, jhi = jvalid_masks(n, jb, jnp.float64)
            assert np.array_equal(lo.numpy(), np.asarray(jlo))
            assert np.array_equal(hi.numpy(), np.asarray(jhi))
    lo, hi = _valid_masks(8, BC.PERIODIC, torch.float64, CPU)
    assert bool((lo == 1).all()) and bool((hi == 1).all())


def _jax_hierarchy(op, n, bottom):
    """A JAX periodic hierarchy (XLA path, min_coarse_dim 8) of the suite's
    problem, and the port's copy of it."""
    jcfg = JConfig(op=op, a=0.0, b=1.0, bc=JBC.PERIODIC, dtype=jnp.float64,
                   bottom=bottom, min_coarse_dim=8, kernels="xla")
    jprob = (jinit_fv(n, dtype=jnp.float64, periodic=True) if op == "fv4"
             else jinit_p6(n, dtype=jnp.float64, periodic=True))
    jh = jbuild(jprob.beta_i, jprob.beta_j, jprob.beta_k, jcfg, alpha=jprob.alpha)
    cfg = SolverConfig(op=op, a=0.0, b=1.0, bc=BC.PERIODIC, dtype=torch.float64,
                       bottom=BottomSolver(bottom.value), min_coarse_dim=8)
    levels = [{"dim": lv.dim, "h": lv.h, "depth": lv.depth,
               **{f: np.array(getattr(lv, f)) for f in FIELDS
                  if getattr(lv, f, None) is not None}}
              for lv in jh.levels]
    return jcfg, jh, jprob, cfg, hierarchy_from_numpy(levels, cfg, "cpu")


@pytest.mark.parametrize("op", ["fv4", "fv7pt", "27pt"])
def test_direct_bottom_pseudo_inverse(op):
    """The 8^3 bottom of a 16^3 periodic hierarchy: the port's probes and
    pinv (with the JAX cutoff) against the JAX package's bottom_ainv, and
    its null space, the constants."""
    jcfg, jh, _, cfg, hier = _jax_hierarchy(op, 16, JBottom.DIRECT)
    bot = hier.levels[-1]
    ainv = direct_bottom_inverse(get_suite(op), bot, cfg)
    assert rel(ainv, jh.levels[-1].bottom_ainv) <= 1e-11
    ones = torch.ones(bot.ncells, dtype=torch.float64)
    assert float((ainv @ ones).abs().max()) <= 1e-10 * float(ainv.abs().max())


@pytest.mark.parametrize("bottom", [JBottom.DIRECT, JBottom.BICGSTAB])
@pytest.mark.parametrize("op", ["fv4", "fv7pt"])
def test_bottom_solve_subtracts_mean(op, bottom):
    """bottom_solve with must_subtract_mean on the 8^3 bottom, against the
    JAX package's, from a zero and from a random start; the result is
    mean-free and so is its residual."""
    jcfg, jh, _, cfg, hier = _jax_hierarchy(op, 16, bottom)
    rng = np.random.default_rng(8)
    rhs = rng.standard_normal((8, 8, 8)) + 0.5  # a mean to project out
    x0 = rng.standard_normal((8, 8, 8))
    for start in (np.zeros_like(x0), x0):
        want = jbottom_solve(jsuite(op), jh.levels[-1], jnp.asarray(start),
                             jnp.asarray(rhs), jcfg, must_subtract_mean=True)
        got = bottom_solve(get_suite(op), hier.levels[-1], torch.tensor(start),
                           torch.tensor(rhs), cfg, must_subtract_mean=True)
        assert rel(got, want) <= 1e-10
    if bottom == JBottom.DIRECT:
        assert abs(float(got.mean())) <= 1e-14 * float(got.abs().max())


def test_reduce_dtype_accumulation():
    """dot and mean accumulate in cfg.reduce_dtype as the JAX package's."""
    from hpgmg_tpu.core import blas as jblas

    a = np.random.default_rng(3).standard_normal((16, 16, 16)).astype(np.float32)
    u = torch.tensor(a)
    for acc, jacc in ((None, None), (torch.float64, jnp.float64)):
        assert blas.dot(u, u, acc).dtype == torch.float32
        assert rel(blas.dot(u, u, acc), jblas.dot(jnp.asarray(a), jnp.asarray(a), jacc)) <= 1e-6
        assert rel(blas.mean(u, acc), jblas.mean(jnp.asarray(a), jacc)) <= 1e-5
    with pytest.raises(ValueError, match="reduce dtype"):
        SolverConfig(reduce_dtype=torch.int32)
