"""The port's decomposed F-cycle (hpgmg_tpu_torch/parallel) against the JAX
package's serial one on the CPU: one spawned gloo job of 4 ranks (the 2x2
grid) and one of 2 ranks (2x1), tests/torch_ranks.py:fcycle_body, at 32^3
float64, GSRB, min_coarse_dim 8: levels 32 and 16 decomposed, 8
replicated. The fv4 and fv7pt Dirichlet F-cycles and the fv4 periodic
F-cycle (DIRECT bottom), and on the 2x2 grid the fv4 F-cycle over the
BiCGStab bottom, each equal the JAX serial fmg_solve (kernels="xla") of
the same problem: u and rel_residual to 1e-10 relative. On the 2x1 grid
with min_coarse_dim 16 the bottom (16^3) is itself decomposed: BiCGStab
(fv4) all-reduces its dots and norms, DIRECT (fv7pt) gathers its rhs;
both equal the JAX serial solve too. On the 2x2 grid the fv4 and fv7pt
Dirichlet F-cycles at 36^3 (ladder 36-18-9) decompose 36^3 only: the 18^3
level would split into 9x9 blocks, which the slab kernels do not take, so
it is replicated (``parallel/mesh.py:level_part``); both equal the JAX
serial solve. No kernel's plain version other than the slab kernels' (and
K3's, and on a replicated level the suite's own) runs on the decomposed
levels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one intra-op thread a test process)
import torch_ranks
from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.problems.fv import init_problem_fv
from hpgmg_tpu.problems.p6 import init_problem_p6
from hpgmg_tpu.solve.mg import fmg_solve as jfmg

N = 32
TOL = 1e-10
CASES = [("fv4", "dirichlet", "direct", 8), ("fv7pt", "dirichlet", "direct", 8),
         ("fv4", "periodic", "direct", 8)]
BICGSTAB = ("fv4", "dirichlet", "bicgstab", 8)
# the bottom level decomposed (2x1 grid, 16^3 bottom)
BOTTOM16 = [("fv4", "dirichlet", "bicgstab", 16), ("fv7pt", "dirichlet", "direct", 16)]
# 36^3 on the 2x2 grid: the 18^3 level's blocks would be 9x9, so it is
# replicated under the decomposed 36^3
ODD36 = [("fv4", "dirichlet", "direct", 8, 36), ("fv7pt", "dirichlet", "direct", 8, 36)]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each grid's results (rank 0's: u and rel_residual are global)."""
    four, two = torch_ranks.spawn([
        (torch_ranks.fcycle_body, 4, tmp_path_factory.mktemp("gloo4"), N,
         CASES + [BICGSTAB] + ODD36),
        (torch_ranks.fcycle_body, 2, tmp_path_factory.mktemp("gloo2"), N,
         CASES + BOTTOM16)])
    return {"2x2": four[0], "2x1": two[0]}


@functools.lru_cache(maxsize=None)
def _jax_fcycle(op, bc, bottom, mcd, n=N):
    cfg = JConfig(op=op, bc=JBC(bc), a=0.0, b=1.0, dtype=jnp.float64, kernels="xla",
                  bottom=JBottom(bottom), min_coarse_dim=mcd)
    periodic = bc == "periodic"
    if op == "fv4":
        prob = init_problem_fv(n, dtype=jnp.float64, periodic=periodic)
    else:
        prob = init_problem_p6(n, dtype=jnp.float64, periodic=periodic, a=0.0, b=1.0)
    hier = jbuild(prob.beta_i, prob.beta_j, prob.beta_k, cfg, alpha=prob.alpha)
    u, nr, nf = jax.jit(lambda h, f: jfmg(jsuite(op), h, f, cfg))(hier, prob.f)
    return np.asarray(u), float(nr) / float(nf)


@pytest.mark.parametrize("grid,case", [(g, c) for g in ("2x2", "2x1") for c in CASES]
                         + [("2x2", BICGSTAB)] + [("2x1", c) for c in BOTTOM16]
                         + [("2x2", c) for c in ODD36],
                         ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v)))
def test_decomposed_fcycle_equals_jax_serial(jobs, grid, case):
    res = jobs[grid][case]
    u, rel = _jax_fcycle(*case)
    diff = float(np.max(np.abs(res["u"].numpy() - u)) / np.max(np.abs(u)))
    assert diff <= TOL
    assert abs(res["rel"] - rel) <= TOL * rel


@pytest.mark.parametrize("grid", ["2x2", "2x1"])
def test_levels_and_kernels_of_the_decomposed_cycle(jobs, grid):
    """32^3 and 16^3 are decomposed, 8^3 replicated; only the slab kernels,
    K3 and, on the replicated bottom, the suite's stencil (BiCGStab's
    applies) ran their plain versions."""
    out = jobs[grid]
    assert tuple(out["grid"]) == ((2, 2, 1) if grid == "2x2" else (2, 1, 1))
    for case in CASES + ([BICGSTAB] + ODD36 if grid == "2x2" else BOTTOM16):
        res = out[case]
        want = ([True, False, False] if case in ODD36 else
                [True, True] if case[3] == 16 else [True, True, False])
        assert res["decomposed"] == want, case
        slab = "fv4_slab_plain" if case[0] == "fv4" else "r1_slab_plain"
        assert res["plain_calls"].get(slab, 0) > 0, case
        allowed = {slab, "restrict_cell_plain", "r1_gsrb2_slab_plain"}
        if case[2] == "bicgstab" and case[3] == 8:  # the replicated bottom's applies
            allowed.add("fv4_stencil_plain")
        if case in ODD36:  # the replicated 18^3 level's stencil and smoother
            allowed |= ({"fv4_stencil_plain", "fv4_gsrb2_plain"} if case[0] == "fv4"
                        else {"r1_stencil_plain", "r1_gsrb2_plain"})
        assert set(res["plain_calls"]) <= allowed, (case, res["plain_calls"])
    assert out[("fv7pt", "dirichlet", "direct", 8)]["plain_calls"]["r1_gsrb2_slab_plain"] > 0

