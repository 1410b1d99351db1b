"""The port's bfloat16 solve with periodic BCs (fv4, fv7pt, fv2, 27pt)
against the JAX package's (``--dtype bfloat16 --bc periodic``) on the CPU.

As tests/test_torch_bf16_r1.py does for the Dirichlet radius-1 suites:
the same seeded bf16 inputs through both packages, the JAX package on its
XLA path (kernels="xla"), each port result held to JAX's in units of
2^-8 * max|JAX| (``gap``) with a tolerance of about twice the gap measured
here, which its comment gives. Covered: K7a's plain version (the fv4
stencil with wrapped ghosts) and K7b's (both radius-1 bodies) in their
four modes at 8^3-32^3 on the suites' own periodic bf16 levels; the
periodic ghost fills and interpolations; every level of the periodic
rebuilds from the same fine bf16 coefficients; the periodic problems; the
mean-free projection of the singular operator (``blas.mean``: both
packages sum a bf16 field in float32 and round the mean to bf16 once) and
the singular BiCGStab bottom on the coarsest level; and one bf16 F-cycle
per suite at 16^3 with its solves at 8^3 and 4^3 for the order, and the
27pt one against the JAX package's float32 F-cycle rounded to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)
from test_torch_bf16_r1 import (BF, build_both, fcycles, gap, hold_fcycles,
                                hold_problem, hold_witness, jax_half_sweep, jcfg, pcfg, to_port)

from hpgmg_tpu.core import blas as jblas
from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.ops import bc as jbc
from hpgmg_tpu.ops import bc_fv as jbc_fv
from hpgmg_tpu.ops import transfer as jtr
from hpgmg_tpu.ops import transfer_fv as jtrfv
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.ops.transfer import restrict_cell as jrestrict
from hpgmg_tpu.problems.fv import init_problem_fv as jfv
from hpgmg_tpu.problems.p4 import init_problem_p4 as jp4
from hpgmg_tpu.problems.p6 import init_problem_p6 as jp6
from hpgmg_tpu.solve.bottom import bottom_solve as jbottom
from hpgmg_tpu_torch.core import blas
from hpgmg_tpu_torch.core.config import BC
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy
from hpgmg_tpu_torch.ops import bc, bc_fv, transfer
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.problems.fv import init_problem_fv
from hpgmg_tpu_torch.problems.p4 import init_problem_p4
from hpgmg_tpu_torch.problems.p6 import init_problem_p6
from hpgmg_tpu_torch.solve.bottom import bottom_solve

SUITES = ("fv4", "fv7pt", "fv2", "27pt")
SIZES = (8, 16, 32)
CPU = torch.device("cpu")

# largest gap (units of 2^-8 max|JAX|) measured at 8^3-32^3 -> tolerance
TOL = {
    # measured: apply 1.94, residual 1.98, gsrb 2.32, fres 3.61
    "fv4": {"apply": 4.0, "residual": 4.0, "gsrb": 5.0, "fres": 7.5},
    # 2.05, 2.05, 2.57, 2.06
    "fv7pt": {"apply": 4.5, "residual": 4.5, "gsrb": 5.5, "fres": 4.5},
    # 2.40, 2.40, 2.20, 2.88
    "fv2": {"apply": 5.0, "residual": 5.0, "gsrb": 4.5, "fres": 6.0},
    # 2.88, 2.88, 3.46, 3.12
    "27pt": {"apply": 6.0, "residual": 6.0, "gsrb": 7.0, "fres": 6.5},
}
# the wraps and the interpolations: the same copies and weights in both
# (measured 0.0 each)
FILL_TOL = {"linear": 1.0, "quadratic_fd": 1.0, "fv2": 1.0, "fv4": 1.0}
INTERP_TOL = {"p0": 1.0, "p1": 1.0, "p2": 1.0, "v2": 1.0, "v4": 1.0}
# every level's fields (measured 3.40, 0.0, 3.37, 0.0)
REBUILD_TOL = {"fv4": 7.0, "fv7pt": 1.0, "fv2": 7.0, "27pt": 1.0}
# the BiCGStab bottom's solution (measured 1.86-2.09)
BOTTOM_TOL = 4.5
# the F-cycle at 16^3: u (measured 1.65, 2.44, 1.57, 8.16), rel_res ratio
# to JAX's (1.21, 1.02, 0.65, 0.40) and order (port / JAX: 0.31 / 0.30,
# 3.42 / 3.44, -0.24 / -0.24, 4.28 / 4.22: set by rounding); the 27pt gaps
# are the JAX operator's bf16 rounding (tests/test_torch_bf16_r1.py; the
# float32 witness, test_periodic_27pt_bf16_fcycle_matches_jax_float32,
# holds the port's tightly)
U_TOL = {"fv4": 3.5, "fv7pt": 5.0, "fv2": 3.5, "27pt": 16.5}
RES_BAND = {"fv4": 2.0, "fv7pt": 2.0, "fv2": 2.0, "27pt": 5.0}
ORDER_BAND = {"fv4": 0.25, "fv7pt": 0.25, "fv2": 0.25, "27pt": 0.25}


@pytest.fixture(scope="module")
def levels():
    """Per (suite, n): the JAX periodic bf16 hierarchy, the port's copy,
    seeded bf16 x and rhs."""
    rng = np.random.default_rng(1908)
    out = {}
    for op in SUITES:
        for n in SIZES:
            _, jh, ph = build_both(op, n, "periodic")
            x, rhs = (jnp.asarray(a, BF) for a in rng.standard_normal((2, n, n, n)))
            out[op, n] = (jh, ph, x, rhs)
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", SUITES)
def test_k7a_k7b_plain_modes_match_jax(levels, op, n):
    """K7a's (fv4) and K7b's (radius-1) plain versions in their four modes,
    the suite's entries on CPU tensors, against the JAX suite's XLA ops."""
    jh, ph, x, rhs = levels[op, n]
    jl, pl = jh.levels[0], ph[0]
    J, P, jc, cfg = jsuite(op), get_suite(op), jcfg(op, "periodic"), pcfg(op, "periodic")
    xp, rp = to_port(x), to_port(rhs)
    assert pl.dtype == torch.bfloat16
    got = {"apply": gap(P.apply_op(pl, xp, cfg), J.apply_op(jl, x, jc)),
           "residual": gap(P.residual(pl, xp, rp, cfg), J.residual(jl, x, rhs, jc)),
           "fres": gap(P.restrict_residual(pl, xp, rp, cfg),
                       jrestrict(J.residual(jl, x, rhs, jc)))}
    for p in (0, 1):
        got[f"gsrb{p}"] = gap(P.gsrb_sweep(pl, xp, rp, cfg, p),
                              jax_half_sweep(J, jl, x, rhs, jc, p))
    for name, g in got.items():
        assert g <= TOL[op][name.rstrip("01")], (name, g)


@pytest.mark.parametrize("fill", ["linear", "quadratic_fd", "fv2", "fv4"])
def test_periodic_ghost_fills_match_jax(fill):
    """The wrap of each fill (radius 1, and 2 for the fv4 suite)."""
    a = jnp.asarray(np.random.default_rng(8).standard_normal((16, 16, 16)), BF)
    radius = 2 if fill == "fv4" else 1
    if fill in ("linear", "quadratic_fd"):
        out = getattr(bc, f"ghost_fill_{fill}")(to_port(a), BC.PERIODIC, radius=radius)
        ref = getattr(jbc, f"ghost_fill_{fill}")(a, JBC.PERIODIC, radius=radius)
    else:
        order = int(fill[2])
        out = bc_fv.ghost_fill_fv(to_port(a), BC.PERIODIC, order=order, radius=radius)
        ref = jbc_fv.ghost_fill_fv(a, JBC.PERIODIC, order=order, radius=radius)
    assert out.dtype == torch.bfloat16 and out.shape == (16 + 2 * radius,) * 3
    g = gap(out, ref)
    assert g <= FILL_TOL[fill], g


@pytest.mark.parametrize("name", ["p0", "p1", "p2", "v2", "v4"])
def test_periodic_interpolations_match_jax(name):
    rng = np.random.default_rng(20)
    xc, xf = (jnp.asarray(rng.standard_normal(s), BF) for s in ((8, 8, 8), (16, 16, 16)))
    ref = {"p0": jtr.interp_p0, "p1": jtr.interp_p1, "p2": jtrfv.interp_p2,
           "v2": jtrfv.interp_v2, "v4": jtrfv.interp_v4}[name]
    for prescale in (0.0, 1.0):
        out = transfer.get_interpolation(name)(to_port(xc), prescale, to_port(xf),
                                               BC.PERIODIC)
        assert out.dtype == torch.bfloat16
        g = gap(out, ref(xc, prescale, xf, JBC.PERIODIC))
        assert g <= INTERP_TOL[name], (prescale, g)


@pytest.mark.parametrize("op", SUITES)
def test_periodic_rebuild_matches_jax(op):
    """Every level of the port's periodic bf16 hierarchy against JAX's, from
    the same fine bf16 coefficients at 32^3 (fv4's face arrays wrapped
    tangentially at build time)."""
    prob, jh, _ = build_both(op, 32, "periodic")
    hier = build_hierarchy(to_port(prob.beta_i), to_port(prob.beta_j),
                           to_port(prob.beta_k), pcfg(op, "periodic"))
    assert [lv.dim for lv in hier.levels] == [lv.dim for lv in jh.levels]
    worst = 0.0
    for lv, jl in zip(hier.levels, jh.levels):
        for f in ("beta_i", "beta_j", "beta_k", "dinv", "l1inv", "lambda_max"):
            got = getattr(lv, f)
            assert got.dtype == torch.bfloat16, f
            worst = max(worst, gap(got.reshape(-1), np.asarray(getattr(jl, f)).reshape(-1)))
    assert worst <= REBUILD_TOL[op], worst


@pytest.mark.parametrize("problem", ["fv", "p4", "p6"])
def test_periodic_problems_match_jax(problem):
    """The periodic variants (the fv problem's rhs made mean-free, p4 and p6
    shifted so that their integrals vanish), held as
    test_torch_bf16_r1.py:hold_problem holds the Dirichlet ones (measured
    to the float64 problem 0.33-0.79 units, to the float32 one rounded 0.0,
    to the JAX bf16 one fv f 20.21, p4 u_true 62.66, p6 u_true 108.69,
    against JAX's own 19.77, 62.50, 115.99 from float64)."""
    if problem == "fv":
        port = init_problem_fv(16, torch.bfloat16, CPU, periodic=True)
        hold_problem(port, lambda d: jfv(16, dtype=d, periodic=True),
                     ("beta_i", "beta_j", "beta_k", "f"))
    else:
        kw = dict(periodic=True, a=0.0, b=1.0)
        port = {"p4": init_problem_p4, "p6": init_problem_p6}[problem](
            16, torch.bfloat16, CPU, **kw)
        ref = {"p4": jp4, "p6": jp6}[problem]
        hold_problem(port, lambda d: ref(16, dtype=d, **kw),
                     ("beta_i", "beta_j", "beta_k", "f", "u_true"))


def test_mean_accumulates_in_float32():
    """blas.mean of a bf16 field, the periodic solve's projection: both
    packages sum in float32 (a bf16 running sum of 4096 values would stall
    at 2^8 times its terms) and round the mean to bf16 once, so they agree
    bit for bit; so do the projected fields."""
    u = jnp.asarray(np.random.default_rng(9).standard_normal((16, 16, 16)) + 3.0, BF)
    m, jm = blas.mean(to_port(u)), jblas.mean(u)
    assert m.dtype == torch.bfloat16 and float(m) == float(jm)
    assert float(blas.mean(torch.ones(4096, dtype=torch.bfloat16))) == 1.0
    assert gap(to_port(u) - m, u - jm) == 0.0


@pytest.mark.parametrize("op", SUITES)
def test_singular_bicgstab_bottom_matches_jax(levels, op):
    """The BiCGStab bottom on the 8^3 hierarchy's coarsest (2^3) periodic
    level, projecting out the constants after every residual update, from
    a zero guess and a seeded mean-free rhs."""
    jh, ph, _, _ = levels[op, 8]
    jl, pl = jh.levels[-1], ph[-1]
    assert pl.dim == 2
    rhs = np.random.default_rng(10).standard_normal((2, 2, 2))
    rhs = jnp.asarray(rhs - rhs.mean(), BF)
    got = bottom_solve(get_suite(op), pl, torch.zeros((2, 2, 2), dtype=torch.bfloat16),
                       to_port(rhs), pcfg(op, "periodic"), must_subtract_mean=True)
    want = jbottom(jsuite(op), jl, jnp.zeros((2, 2, 2), BF), rhs, jcfg(op, "periodic"),
                   must_subtract_mean=True)
    assert got.dtype == torch.bfloat16
    g = gap(got, want)
    assert g <= BOTTOM_TOL, g


@pytest.mark.parametrize("op", SUITES)
def test_periodic_bf16_fcycle_matches_jax(op):
    hold_fcycles(op, fcycles(op, "periodic"), U_TOL[op], RES_BAND[op], ORDER_BAND[op])


def test_periodic_27pt_bf16_fcycle_matches_jax_float32():
    """As test_torch_bf16_r1.py's Dirichlet one: the periodic 27pt bf16
    F-cycle against JAX's float32 F-cycle rounded to bf16."""
    hold_witness("27pt", "periodic")
