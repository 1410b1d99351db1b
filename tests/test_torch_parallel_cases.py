"""The decomposed cases the JAX package holds to serial runs
(tests/test_sharded.py), on the port's i/j grid over gloo on the CPU, each
held to the JAX package's serial solve (tests/jax_serial.py: XLA path,
float64): one spawned job of 4 ranks (the 2x2 grid, 32^3) and one of 2
ranks (2x1), tests/torch_ranks.py:solve_body.

* 2x2: Chebyshev with the CABiCGStab bottom (test_sharded.py:117, u to
  1e-11); three V-cycles through mg_solve_fixed (:95); MGPCG, four
  iterations, its history to 1e-9 (:145); the Helmholtz fv4 and fv7pt
  F-cycles (a = 0.9, b = 1, the problem's alpha); the fv2 and 27pt
  F-cycles; fmg_solve2 (two F-cycles); the timed F-cycle (``timers``),
  whose u also equals the untimed one's. u and the relative residuals to
  1e-10 relative unless noted.
* 2x1 with min_coarse_dim 16: the bottom (16^3) is itself decomposed, and
  the CABiCGStab (27pt), CACG and smooth-until-converged (fv4) bottoms run
  on it: all-reduced Gram matrices, dots and norms.
* Which levels are decomposed, and that only the slab kernels' plain
  versions and K3's (and on the replicated bottom the suite's own) ran.
"""

import pytest

import jax_serial
import torch_cpu  # noqa: F401  (one intra-op thread a test process)
import torch_ranks
from hpgmg_tpu_torch.kernels import stencils as S

TOL = 1e-10
CASES = {
    "chebyshev-cabicgstab": ("fcycle", "fv4", "dirichlet", "chebyshev", "cabicgstab", 8, 32, 0.0),
    "vcycles": ("vcycles", "fv7pt", "dirichlet", "gsrb", "direct", 8, 32, 0.0),
    "mgpcg": ("mgpcg", "fv7pt", "dirichlet", "gsrb", "direct", 8, 32, 0.0),
    "helmholtz-fv4": ("fcycle", "fv4", "dirichlet", "gsrb", "direct", 8, 32, 0.9),
    "helmholtz-fv7pt": ("fcycle", "fv7pt", "dirichlet", "gsrb", "direct", 8, 32, 0.9),
    "fv2": ("fcycle", "fv2", "dirichlet", "gsrb", "direct", 8, 32, 0.0),
    "27pt": ("fcycle", "27pt", "dirichlet", "gsrb", "direct", 8, 32, 0.0),
    "fmg2": ("fmg2", "fv4", "dirichlet", "gsrb", "direct", 8, 32, 0.0),
    "timed": ("timed", "fv4", "dirichlet", "gsrb", "direct", 8, 32, 0.0),
}
# u's tolerance where the JAX test states its own
U_TOL = {"chebyshev-cabicgstab": 1e-11}
BOTTOMS = {
    "cabicgstab": ("fcycle", "27pt", "dirichlet", "gsrb", "cabicgstab", 16, 32, 0.0),
    "cacg": ("fcycle", "fv4", "dirichlet", "gsrb", "cacg", 16, 32, 0.0),
    "smooth": ("fcycle", "fv4", "dirichlet", "gsrb", "smooth", 16, 32, 0.0),
}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Rank 0's results of each grid (u and the residuals are global)."""
    four, two = torch_ranks.spawn([
        (torch_ranks.solve_body, 4, tmp_path_factory.mktemp("gloo4"), "ij",
         list(CASES.values())),
        (torch_ranks.solve_body, 2, tmp_path_factory.mktemp("gloo2"), "ij",
         list(BOTTOMS.values()))])
    return {"2x2": four[0], "2x1": two[0]}


def _check(res, case, u_tol=TOL, rel_tol=TOL):
    u, rel = jax_serial.solve(case)
    assert jax_serial.rel_diff(res["u"].numpy(), u) <= u_tol
    got = res["rel"] if isinstance(rel, list) else [res["rel"]]
    want = rel if isinstance(rel, list) else [rel]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= rel_tol * w


@pytest.mark.parametrize("name", list(CASES))
def test_decomposed_case_equals_jax_serial(jobs, name):
    case = CASES[name]
    _check(jobs["2x2"][case], case, U_TOL.get(name, TOL),
           1e-9 if name == "mgpcg" else TOL)


@pytest.mark.parametrize("name", list(BOTTOMS))
def test_decomposed_bottom_equals_jax_serial(jobs, name):
    _check(jobs["2x1"][BOTTOMS[name]], BOTTOMS[name])


def test_timed_fcycle_equals_untimed(jobs):
    res = jobs["2x2"][CASES["timed"]]
    assert jax_serial.rel_diff(res["u"].numpy(), res["untimed_u"].numpy()) <= 1e-12
    assert {"smooth", "residual", "restriction", "interpolation", "bottom"} <= set(
        res["phases"])


def test_levels_and_kernels_of_the_decomposed_cases(jobs):
    """2x2: 32^3 and 16^3 decomposed over i and j, 8^3 replicated; 2x1
    with min_coarse_dim 16: both levels decomposed over i. On the
    decomposed levels only the slab kernels' and K3's plain versions ran;
    on the replicated 8^3 bottom the suite's stencil (Chebyshev's and
    CABiCGStab's applies)."""
    out = jobs["2x2"]
    assert tuple(out["grid"]) == (2, 2, 1)
    k1 = "fv4_subtile_plain" if S.SUBTILE else "fv4_stencil_plain"
    for name, case in CASES.items():
        res = out[case]
        assert res["split"] == [(True, True, False)] * 2 + [None], name
        slab = "fv4_slab_plain" if case[1] == "fv4" else "r1_slab_plain"
        assert res["plain_calls"].get(slab, 0) > 0, name
        allowed = {slab, "restrict_cell_plain", "r1_gsrb2_slab_plain"}
        if case[4] == "cabicgstab":
            allowed.add(k1)
        assert set(res["plain_calls"]) <= allowed, (name, res["plain_calls"])
    two = jobs["2x1"]
    assert tuple(two["grid"]) == (2, 1, 1)
    for name, case in BOTTOMS.items():
        res = two[case]
        assert res["split"] == [(True, False, False)] * 2, name
        slab = "fv4_slab_plain" if case[1] == "fv4" else "r1_slab_plain"
        assert set(res["plain_calls"]) == {slab, "restrict_cell_plain"}, (
            name, res["plain_calls"])
