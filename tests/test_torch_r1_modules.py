"""Per-module parity of the port's radius-1 suites (fv7pt, fv2, 27pt) with
the JAX package on the CPU, at 16^3 in float64: the cell-centered ghost
fills (ops/bc.py), the p0/p1/p2 interpolations, the fv7pt analytic rebuild
and the fv2/27pt black-box rebuilds, and the pointwise problems p4, p6 and
sine. The same seeded numpy inputs go through the JAX function and its
port; rel = max|port - jax| / max|jax| <= 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.level import Level as JLevel
from hpgmg_tpu.core.level import rb_mask as jrb_mask
from hpgmg_tpu.ops import bc as jbc
from hpgmg_tpu.ops import transfer as jtr
from hpgmg_tpu.ops import transfer_fv as jtrfv
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.problems.p4 import init_problem_p4 as jp4
from hpgmg_tpu.problems.p6 import init_problem_p6 as jp6
from hpgmg_tpu.problems.sine import init_problem_sine as jsine
from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.ops import bc, transfer, transfer_fv
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.problems.p4 import init_problem_p4
from hpgmg_tpu_torch.problems.p6 import init_problem_p6
from hpgmg_tpu_torch.problems.sine import init_problem_sine

N = 16
TOL = 1e-12
CPU = torch.device("cpu")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("bc_name", ["dirichlet", "periodic"])
@pytest.mark.parametrize("fill", ["ghost_fill_linear", "ghost_fill_quadratic_fd"])
@pytest.mark.parametrize("shape", [(N, N, N), (1, 4, 4)])
def test_ghost_fills(fill, shape, bc_name):
    """Every ghost, edges and corners included, under both BCs; the 1-cell
    extent takes the linear fallback of the quadratic Dirichlet fill and
    wraps onto itself under periodic BCs."""
    a = np.random.default_rng(1).standard_normal(shape)
    out = getattr(bc, fill)(torch.tensor(a), BC(bc_name), radius=1)
    ref = getattr(jbc, fill)(jnp.asarray(a), JBC(bc_name), radius=1)
    assert out.shape == ref.shape
    assert rel(out, ref) <= TOL


@pytest.mark.parametrize("name", ["p0", "p1", "p2"])
def test_interpolations(name):
    rng = np.random.default_rng(2)
    m = N // 2
    xc, xf = rng.standard_normal((m, m, m)), rng.standard_normal((N, N, N))
    port = transfer.get_interpolation(name)
    ref = {"p0": jtr.interp_p0, "p1": jtr.interp_p1, "p2": jtrfv.interp_p2}[name]
    for prescale in (0.0, 1.0):
        out = port(torch.tensor(xc), prescale, torch.tensor(xf), BC.DIRICHLET)
        assert out.is_contiguous()
        assert rel(out, ref(jnp.asarray(xc), prescale, jnp.asarray(xf),
                            JBC.DIRICHLET)) <= TOL
    assert transfer.get_interpolation("p2") is transfer_fv.interp_p2


def _levels(rng, helmholtz):
    """The same random positive face arrays and alpha as a JAX and a port
    level at N^3."""
    b = [1.0 + rng.random(s) for s in ((N + 1, N, N), (N, N + 1, N), (N, N, N + 1))]
    alpha = 0.5 + rng.random((N, N, N)) if helmholtz else None
    jlv = JLevel(dim=N, h=1.0 / N, depth=0, beta_i=jnp.asarray(b[0]),
                 beta_j=jnp.asarray(b[1]), beta_k=jnp.asarray(b[2]),
                 alpha=None if alpha is None else jnp.asarray(alpha))
    lv = Level(dim=N, h=1.0 / N, depth=0, beta_i=torch.tensor(b[0]),
               beta_j=torch.tensor(b[1]), beta_k=torch.tensor(b[2]),
               alpha=None if alpha is None else torch.tensor(alpha))
    return jlv, lv


@pytest.mark.parametrize("helmholtz", [False, True])
@pytest.mark.parametrize("op", ["fv7pt", "fv2", "27pt"])
def test_rebuild_operator(op, helmholtz):
    """fv7pt's analytic Dinv / L1inv / Gershgorin bound, fv2's and 27pt's
    2-colour black-box probes (through the K5 plain version here), and the
    parity-folded kdinv pair."""
    jlv, lv = _levels(np.random.default_rng(3), helmholtz)
    kw = dict(op=op, a=1.5 if helmholtz else 0.0, b=1.0, helmholtz=helmholtz)
    jout = jsuite(op).rebuild_operator(jlv, JConfig(dtype=jnp.float64, kernels="xla", **kw))
    out = get_suite(op).rebuild_operator(lv, SolverConfig(dtype=torch.float64, **kw))
    for name in ("dinv", "l1inv", "lambda_max"):
        assert rel(getattr(out, name), getattr(jout, name)) <= TOL, name
    for p in (0, 1):
        assert rel(out.kdinv[p], jrb_mask(N, p, jnp.float64) * jout.dinv) <= TOL
    assert out.beta_i.shape == (N + 1, N, N)  # natural face arrays kept


@pytest.mark.parametrize("helmholtz", [False, True])
@pytest.mark.parametrize("problem", ["p4", "p6", "sine"])
def test_pointwise_problems(problem, helmholtz):
    kw = dict(a=1.5 if helmholtz else 0.0, b=1.0, helmholtz=helmholtz)
    port = {"p4": init_problem_p4, "p6": init_problem_p6,
            "sine": init_problem_sine}[problem](N, torch.float64, CPU, **kw)
    ref = {"p4": jp4, "p6": jp6, "sine": jsine}[problem](N, dtype=jnp.float64, **kw)
    for name in ("beta_i", "beta_j", "beta_k", "alpha", "f", "u_true"):
        out = getattr(port, name)
        assert out.dtype == torch.float64 and out.is_contiguous(), name
        assert tuple(out.shape) == getattr(ref, name).shape, name
        assert rel(out, getattr(ref, name)) <= TOL, name


def test_suite_defaults():
    """Smooths per suite (fv7pt 2, fv2 3, 27pt 2), interpolations, and the
    operator names SolverConfig accepts."""
    for op, smooths, interp in (("fv7pt", 2, ("p0", "p1")), ("fv2", 3, ("v2", "v2")),
                                ("27pt", 2, ("p2", "p2")), ("fv4", 3, ("v2", "v4"))):
        suite = get_suite(op)
        assert SolverConfig(op=op).resolved_num_smooths(suite) == smooths
        assert (suite.interpolation_vcycle, suite.interpolation_fcycle) == interp
        assert SolverConfig(op=op).resolved_num_smooths(suite) == \
            JConfig(op=op).resolved_num_smooths(jsuite(op))
    with pytest.raises(ValueError):
        SolverConfig(op="fv6")
