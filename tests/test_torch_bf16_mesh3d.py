"""bfloat16 on the 3D process grid: the port's decomposed bf16 path with k
slabs against its one-rank bf16 path and against the JAX package, on the
CPU over gloo (one spawned job of 8 ranks, the (2,2,2) grid of make_mesh;
tests/torch_ranks.py:bf16_grid_body; the references in tests/bf16_grid.py,
computed while the ranks run).

* The slab kernels' plain versions in bf16 on each rank's (16,16,16) block
  of a 32^3 level, six slabs each: K8a (apply, residual, gsrb at both
  parities) on the fv4 Dirichlet and periodic levels, K8c (every mode) on
  the fv2 (var7 body) and 27pt Dirichlet levels, K8d's sweep on the fv2
  one. Held as on the 2x2 grid (tests/test_torch_bf16_mesh.py): bit for
  bit the whole-level bf16 plain version at every cell, domain faces (k
  faces too) included; within the whole-level bounds of the JAX package's
  bf16 operators and within one bf16 unit of each cell of its float32
  operators on the same inputs. K8b's split needs three column tiles of
  32 along a split k, a
  (66+)-cell block: no CPU-sized level of this grid has one (the card
  tests take K8b's bf16 passes with k slabs).
* The decomposed bf16 F-cycles of fv4 and 27pt at 16^3 on Dirichlet
  levels over the BiCGStab bottom (min_coarse_dim 2: 16^3 in (8,8,8)
  blocks, every axis split, the rest replicated): u bit for bit the
  one-rank bf16 F-cycle through the same operations (tests/bf16_grid.py:
  one_rank_fcycle) and within the one-rank bounds of the JAX
  package's serial F-cycle (27pt: its float32 witness); the decomposed
  level ran only the slab kernels' plain versions.
"""

import pytest
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

import bf16_grid as G
import torch_ranks

SLAB_SETS = (("fv4", "fv4", "dirichlet", 32), ("fv4 periodic", "fv4", "periodic", 32),
             ("fv2", "fv2", "dirichlet", 32), ("27pt", "27pt", "dirichlet", 32))
FCYCLES = (("fv4", "dirichlet", 16, 2), ("27pt", "dirichlet", 16, 2))
# the decomposed u against the one-rank u, units of 2^-8 max|u_one|: the
# same operations on the same values, the bottom replicated
ONE_RANK_UNITS = 0.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    finish = torch_ranks.start([
        (torch_ranks.bf16_grid_body, 8, tmp_path_factory.mktemp("gloo8"), "3d",
         [G.slab_job(*s) for s in SLAB_SETS], [G.fcycle_job(c) for c in FCYCLES])],
        timeout=600.0)
    for _, op, bc, n in SLAB_SETS:
        G.whole_level_refs(op, bc, n)
    for case in FCYCLES:
        G.one_rank_fcycle(case)
        G.jax_fcycle(case, witness=case[0] == "27pt")
    return finish()[0]


@pytest.mark.parametrize("label, op, bc, n", SLAB_SETS, ids=[s[0] for s in SLAB_SETS])
def test_slab_plain_versions_on_the_2x2x2_blocks(ranks, label, op, bc, n):
    assert tuple(ranks[0]["grid"]) == (2, 2, 2)
    for res in ranks:
        assert len(res[("slabs", label)]["extents"]) == 3
        assert res[("slabs", label)]["extents"] == (16, 16, 16)
    G.hold_slab_set(ranks, label, op, bc, n)


@pytest.mark.parametrize("case", FCYCLES, ids=["-".join(map(str, c)) for c in FCYCLES])
def test_decomposed_bf16_fcycle_on_the_3d_grid(ranks, case):
    assert ranks[0][case]["split"] == [(True, True, True)] + [None] * 3
    G.hold_fcycle(ranks[0][case], case, ONE_RANK_UNITS)
    for res in ranks:
        G.hold_launches(res[case], case)
