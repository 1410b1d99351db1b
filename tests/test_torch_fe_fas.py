"""The port's FE FAS solver (hpgmg_tpu_torch/fe/fas.py) on the CPU, float64.

Two kinds of oracle:

* the reference's own expected tables, run on the port alone against the
  constants the JAX package's tests hold (tests/test_reference_golden.py:
  t220, t230 at rtol 5e-3, t120 at 1e-4 with 15-19 iterations;
  tests/test_golden.py: the Q2 G[8^3] diagnostics at its RTOL), the FMG
  discretization-error rate and the KSP/FAS cross-check;
* Chebyshev, CG, one V-cycle and one F-cycle against the JAX package's on
  the same levels (the JAX package's fields carried over by
  ``interop.fe_levels_from_numpy``), max|port - jax| / max|jax| <= 1e-11.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.fe import fas as jfas
from hpgmg_tpu.fe.grid import FEGrid as JGrid
from hpgmg_tpu.fe.op import get_fe_op as jget_op
from hpgmg_tpu_torch.fe import fas
from hpgmg_tpu_torch.fe.grid import FEGrid
from hpgmg_tpu_torch.fe.op import get_fe_op
from hpgmg_tpu_torch.interop import fe_levels_from_numpy

CPU = torch.device("cpu")
F64 = torch.float64
# tests/test_golden.py: (r_2, e_max, e_L2) after the F-cycle and after one
# trailing V-cycle, and its tolerance
GOLDEN_FE_Q2_M8_F = (1.168401e-03, 1.023855e-02, 7.655858e-03)
GOLDEN_FE_Q2_M8_V1 = (2.944131e-05, 1.021663e-02, 7.789023e-03)
GOLDEN_RTOL = 2e-3


def check_table(results, expected):
    got = [(s["rel_e"], s["rel_r"]) for _, s in results]
    assert len(got) == len(expected)
    for (ge, gr), (ee, er) in zip(got, expected):
        np.testing.assert_allclose(ge, ee, rtol=5e-3)
        np.testing.assert_allclose(gr, er, rtol=5e-3)


def test_t220_fmg_poisson1_table():
    """t220-fmg.sh:8-14: fmg -op_type poisson1 -M 8,16,24 -smooth 3,3
    -mg_eig_target 2,0.2 -poisson_solution sine."""
    grid = FEGrid(M=(8, 16, 24), degree=1, L=(8 / 24, 16 / 24, 1.0))
    _, _, _, results = fas.run_fmg(grid, get_fe_op("poisson1"), solution="sine",
                                   pre=3, post=3, num_vcycles=2, monitor=False,
                                   eig=(0.2, 2.0), device=CPU)
    check_table(results, [(2.26e-02, 3.37e-02), (2.58e-02, 2.05e-03),
                          (2.60e-02, 1.25e-04)])


def test_t230_fmg_poisson2_table():
    """t230-fmg-poisson2.sh:8-14: fmg -op_type poisson2 -M 4,4,6 -smooth 4,3
    (wave solution, eig target [0.4, 1.4])."""
    grid = FEGrid(M=(4, 4, 6), degree=2, L=(4 / 6, 4 / 6, 1.0))
    _, _, _, results = fas.run_fmg(grid, get_fe_op("poisson2"), solution="wave",
                                   pre=4, post=3, num_vcycles=2, monitor=False,
                                   device=CPU)
    check_table(results, [(9.08e-03, 3.35e-04), (9.17e-03, 8.27e-07),
                          (9.17e-03, 5.54e-09)])


def test_t120_ksp_chebyshev():
    """t120-poissonksp.sh: test-kspsolve -op_type poisson1 -M 8,12,16
    -ksp_type chebyshev -ksp_chebyshev_eigenvalues 0.2,2 -L 1,1,1 ->
    iterations 17 and |v-u|_2/|u|_2 = 0.0393766."""
    grid = FEGrid(M=(8, 12, 16), degree=1, L=(1.0, 1.0, 1.0))
    _, its, err = fas.run_ksp(grid, get_fe_op("poisson1"), solution="sine",
                              ksp_type="chebyshev", rtol=1e-5, eig=(0.2, 2.0),
                              monitor=False, device=CPU)
    np.testing.assert_allclose(err, 0.0393766, rtol=1e-4)
    assert 15 <= its <= 19, its


def test_ksp_matches_fas_solution():
    """The CG KSP solve and the FAS cycles agree on the fine grid."""
    grid = FEGrid(M=(8, 12, 16), degree=1, L=(8 / 16, 12 / 16, 1.0))
    op = get_fe_op("poisson1")
    v, _, _ = fas.run_ksp(grid, op, solution="sine", ksp_type="cg", rtol=1e-10,
                          monitor=False, device=CPU)
    u, _, _, _ = fas.run_fmg(grid, op, solution="sine", pre=3, post=3,
                             num_vcycles=6, monitor=False, device=CPU)
    assert float(torch.linalg.norm(u - v) / torch.linalg.norm(v)) < 1e-6


def test_q2_golden_table():
    """tests/test_golden.py's FE table: F(2,3) then V(2,3) at Q2 G[8^3]."""
    op = get_fe_op("poisson2")
    levels = fas.build_fe_levels(FEGrid(M=(8, 8, 8), degree=2), op, device=CPU)
    f = op.forcing(levels[0].grid, levels[0].coords, "sine")
    u = fas.fas_fcycle(op, levels, 0, f)
    got = [float(x) for x in fas.diagnostics(op, levels[0], f, u, "sine")]
    np.testing.assert_allclose(got, GOLDEN_FE_Q2_M8_F, rtol=GOLDEN_RTOL)
    u = fas.fas_vcycle(op, levels, 0, f, u)
    got = [float(x) for x in fas.diagnostics(op, levels[0], f, u, "sine")]
    np.testing.assert_allclose(got, GOLDEN_FE_Q2_M8_V1, rtol=GOLDEN_RTOL)


@pytest.mark.parametrize("name,rate_lo", [("poisson1", 1.6), ("poisson2", 2.5)])
def test_fmg_rate_and_vcycle(name, rate_lo):
    """One F-cycle reaches discretization error: e_L2 falls at about order
    degree+1 from M=4 to M=8; a V-cycle after it cuts r below 0.3x and
    leaves e (tests/test_fe.py::TestFAS)."""
    op = get_fe_op(name)
    stats = {}
    for m in (4, 8):
        levels = fas.build_fe_levels(FEGrid(M=(m, m, m), degree=op.degree), op,
                                     device=CPU)
        f = op.forcing(levels[0].grid, levels[0].coords, "sine")
        u = fas.fas_fcycle(op, levels, 0, f)
        stats[m] = [float(x) for x in fas.diagnostics(op, levels[0], f, u, "sine")]
    assert math.log2(stats[4][2] / stats[8][2]) > rate_lo, stats
    u = fas.fas_vcycle(op, levels, 0, f, u)
    r1, e1, _ = [float(x) for x in fas.diagnostics(op, levels[0], f, u, "sine")]
    r0, e0, _ = stats[8]
    assert r1 < 0.3 * r0, (r0, r1)
    assert abs(e1 - e0) < 0.3 * e0 + 1e-12, (e0, e1)


def test_run_fmg_prints_the_reference_table(capsys):
    """run_fmg prints fmg.c:467's lines and the diagnostics lines."""
    fas.run_fmg(FEGrid(M=(2, 2, 2), degree=2), get_fe_op("poisson2"), device=CPU)
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:19] for ln in lines[:3]] == ["F(2,3)  0: |e|_2/|u", "V(2,3)  1: |e|_2/|u",
                                           "V(2,3)  2: |e|_2/|u"]
    assert lines[3].startswith("F(2,3) Q2 G[    2    2    2] e_max ")
    assert len(lines) == 6


# ---------------------------------------------------------------------------
# cycles against the JAX package on the same levels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def same_levels():
    """Q2 on a distorted G[4^3] (the full non-affine metric): the JAX
    package's levels and forcing, the port's copies of them, and a
    starting guess."""
    jop, op = jget_op("poisson2"), get_fe_op("poisson2")
    jlevels = jfas.build_fe_levels(JGrid(M=(4, 4, 4), degree=2), jop,
                                   distort=0.05)
    jf = jop.forcing(jlevels[0].grid, jlevels[0].coords, "sine")
    fields = [{k: np.asarray(getattr(L, k)) for k in
               ("coords", "dinv", "metric_a", "metric_w")} for L in jlevels]
    levels = fe_levels_from_numpy(fields, FEGrid(M=(4, 4, 4), degree=2), CPU, F64)
    u0 = np.asarray(jlevels[0].grid.zero_boundaries(
        jnp.asarray(np.random.default_rng(7).standard_normal(levels[0].grid.nodes))))
    return jop, jlevels, jf, op, levels, torch.tensor(np.asarray(jf)), u0


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def test_levels_carried_over(same_levels):
    jop, jlevels, jf, op, levels, f, _ = same_levels
    assert [L.grid.M for L in levels] == [L.grid.M for L in jlevels]
    # the port's own build of the same levels agrees with the carried ones
    own = fas.build_fe_levels(FEGrid(M=(4, 4, 4), degree=2), op, distort=0.05,
                              device=CPU)
    for a, b in zip(own, levels):
        for k in ("coords", "dinv", "metric_a", "metric_w"):
            assert rel(getattr(a, k), getattr(b, k).numpy()) <= 1e-12, k


def test_chebyshev_matches_jax(same_levels):
    jop, jlevels, jf, op, levels, f, u0 = same_levels
    out = fas.chebyshev(op, levels[0], f, torch.tensor(u0), 3)
    assert rel(out, jfas.chebyshev(jop, jlevels[0], jf, jnp.asarray(u0), 3)) <= 1e-11


def test_cg_matches_jax(same_levels):
    jop, jlevels, jf, op, levels, f, u0 = same_levels
    x, its, conv = fas.cg_info(op, levels[0], f, torch.tensor(u0), max_iters=12)
    jx, jits, jconv = jfas.cg_info(jop, jlevels[0], jf, jnp.asarray(u0), max_iters=12)
    assert (its, conv) == (int(jits), bool(jconv))
    assert rel(x, jx) <= 1e-11


def test_vcycle_matches_jax(same_levels):
    jop, jlevels, jf, op, levels, f, u0 = same_levels
    out = fas.fas_vcycle(op, levels, 0, f, torch.tensor(u0))
    ref = jax.jit(lambda lv, b, u: jfas.fas_vcycle(jop, lv, 0, b, u))(
        jlevels, jf, jnp.asarray(u0))
    assert rel(out, ref) <= 1e-11


def test_fcycle_matches_jax(same_levels):
    jop, jlevels, jf, op, levels, f, _ = same_levels
    out = fas.fas_fcycle(op, levels, 0, f)
    ref = jax.jit(lambda lv, b: jfas.fas_fcycle(jop, lv, 0, b))(jlevels, jf)
    assert rel(out, ref) <= 1e-11
