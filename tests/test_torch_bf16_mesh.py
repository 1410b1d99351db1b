"""bfloat16 on the i/j process grid: the port's decomposed bf16 path
against its one-rank bf16 path and against the JAX package, on the CPU
over gloo (one spawned job of 4 ranks, the 2x2 grid of make_mesh_ij;
tests/torch_ranks.py:bf16_grid_body; the references in tests/bf16_grid.py,
computed while the ranks run).

* The slab kernels' plain versions in bf16 on each rank's block: K8a
  (apply, residual, gsrb at both parities) on the fv4 32^3 Dirichlet and
  periodic levels; K8c (every mode) on the fv7pt, fv2 and 27pt 32^3
  Dirichlet levels and the fv7pt periodic one; K8d's sweep on the fv7pt
  and fv2 Dirichlet levels. Each is bit for bit the port's bf16
  whole-level plain version cut to the block, at every cell: a bf16
  block's slabs are float32, the neighbours' cells exact and a Dirichlet
  domain face's ghosts unrounded, as the whole level makes them. Each is
  within the bounds of the whole-level tests of the JAX package's bf16
  operator, and within one bf16 unit in the last place of each cell of
  the JAX package's operator in float32 on the same bf16 inputs, rounded
  once (the JAX bf16 operators round at places of their own: a few units
  of 2^-8 max, as on one rank). K8b's two passes, whose split takes blocks
  of three column tiles of 16 along j (a 68^3 level on this grid), are
  held on one 34^3 block in the test process: bit for bit K8a's and the
  whole level's plain versions.
* The decomposed bf16 F-cycle over the BiCGStab bottom of fv4, fv7pt,
  fv2 and 27pt on Dirichlet levels and of fv4 and fv7pt on periodic ones
  at 16^3 (min_coarse_dim 2: 16^3 in (8,8,16) blocks, the rest
  replicated), and of fv7pt at 32^3 with min_coarse_dim 16 (the bottom,
  16^3, itself decomposed: its dots and norms all-reduced, a rank's
  partial sums in float32): u within ONE_RANK_UNITS units of 2^-8
  max|u_one| of the port's one-rank bf16 F-cycle on the same carried
  hierarchy through the same operations (tests/bf16_grid.py:
  one_rank_fcycle), and within the one-rank bounds of the JAX package's
  serial bf16 F-cycle (27pt: its float32 witness); the decomposed levels
  ran only the slab kernels' plain versions.
"""

import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

import bf16_grid as G
import torch_ranks
from hpgmg_tpu_torch.core.config import BC, BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy
from hpgmg_tpu_torch.bench.driver import build_problem
from hpgmg_tpu_torch.kernels import stencils as S

# (label, op, bc, n) of each slab set
SLAB_SETS = (("fv4", "fv4", "dirichlet", 32), ("fv4 periodic", "fv4", "periodic", 32),
             ("fv7pt", "fv7pt", "dirichlet", 32), ("fv2", "fv2", "dirichlet", 32),
             ("27pt", "27pt", "dirichlet", 32),
             ("fv7pt periodic", "fv7pt", "periodic", 32))
# (op, bc, n, min_coarse_dim) of each F-cycle
FCYCLES = (("fv4", "dirichlet", 16, 2), ("fv7pt", "dirichlet", 16, 2),
           ("fv2", "dirichlet", 16, 2), ("27pt", "dirichlet", 16, 2),
           ("fv4", "periodic", 16, 2), ("fv7pt", "periodic", 16, 2),
           ("fv7pt", "dirichlet", 32, 16))
# the decomposed u against the one-rank u, units of 2^-8 max|u_one|: bit
# for bit (the same operations on the same values, the 16^3 bottom's dots
# too, measured 0), but where u's mean over the decomposed finest level
# enters it (periodic: each rank's partial sum, then the all-reduce, sums
# in another order than one rank; measured 0.83 fv4, 0 fv7pt)
ONE_RANK_UNITS = {"dirichlet": 0.0, "periodic": 1.0}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the 2x2 job; the references computed while
    it runs."""
    finish = torch_ranks.start([
        (torch_ranks.bf16_grid_body, 4, tmp_path_factory.mktemp("gloo4"), "ij",
         [G.slab_job(*s) for s in SLAB_SETS], [G.fcycle_job(c) for c in FCYCLES])],
        timeout=600.0)
    for _, op, bc, n in SLAB_SETS:
        G.whole_level_refs(op, bc, n)
    for case in FCYCLES:
        G.one_rank_fcycle(case)
        G.jax_fcycle(case, witness=case[0] == "27pt")
    return finish()[0]


@pytest.mark.parametrize("label, op, bc, n", SLAB_SETS, ids=[s[0] for s in SLAB_SETS])
def test_slab_plain_versions_on_the_2x2_blocks(ranks, label, op, bc, n):
    assert tuple(ranks[0]["grid"]) == (2, 2, 1)
    G.hold_slab_set(ranks, label, op, bc, n)


def test_k8b_bf16_plain_versions_equal_k8a_and_the_whole_level():
    """K8b's interior and edge passes in bf16 on a 34^3 Dirichlet level as
    one block (three column tiles of 16 along j: the fewest K8b's split
    takes), its float32 slabs of the quartic fill: bit for bit K8a's plain
    version and the whole-level plain version, every mode."""
    n = 34
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.bfloat16,
                       bottom=BottomSolver.BICGSTAB, min_coarse_dim=n)
    prob = build_problem(n, cfg, torch.device("cpu"))
    lv = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg).levels[0]
    x, rhs = (torch_ranks.bf16_field(n, G.SEED + d) for d in (0, 1))
    slabs = S.single_chip_slabs(x, BC.DIRICHLET)
    assert S.overlap_grid_shape(n, n) is not None
    assert all(t.dtype == torch.float32 for t in slabs)
    for mode, kw in [("apply", {}), ("residual", {"rhs": rhs})] + [
            ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}) for p in (0, 1)]:
        k8a = S.fv4_slab_plain(lv, x, slabs, cfg, mode, **kw)
        inner = S.fv4_overlap_interior_plain(lv, x, cfg, mode, **kw)
        k8b = S.fv4_overlap_edge_plain(lv, x, slabs, cfg, mode, inner, **kw)
        whole = S.fv4_stencil_plain(lv, x, cfg, mode, kw.get("rhs"), kw.get("kdinv"))
        assert k8a.dtype == torch.bfloat16
        assert torch.equal(k8b, k8a) and torch.equal(k8a, whole), mode


@pytest.mark.parametrize("case", FCYCLES, ids=["-".join(map(str, c)) for c in FCYCLES])
def test_decomposed_bf16_fcycle_matches_one_rank_and_jax(ranks, case):
    G.hold_fcycle(ranks[0][case], case, ONE_RANK_UNITS[case[1]])


@pytest.mark.parametrize("case", FCYCLES, ids=["-".join(map(str, c)) for c in FCYCLES])
def test_decomposed_bf16_levels_run_the_slab_kernels(ranks, case):
    split = ranks[0][case]["split"]
    if case[3] == 16:
        assert split == [(True, True, False)] * 2
    else:
        assert split == [(True, True, False)] + [None] * 3
    for res in ranks:
        G.hold_launches(res[case], case)
