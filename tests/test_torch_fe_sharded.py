"""The port's decomposed FE FAS solver (hpgmg_tpu_torch/fe/mesh.py and the
decomposed path of fe/grid.py, fe/op.py and fe/fas.py) on gloo CPU ranks,
against the JAX package's serial F-cycles.

One spawned job of 8 ranks on the (2, 2, 2) grid of ``make_mesh`` and one
of 4 on its (2, 2, 1) grid (tests/torch_ranks.py:fe_solve_body), float64,
the sine forcing; each rank builds its blocks (or, build "cut", builds the
whole levels and cuts them with ``shard_fe_levels``). The gathered u after
the F-cycle and after each V-cycle equals the JAX package's serial u
(``hpgmg_tpu.fe.fas``, jitted, the whole levels) within 1e-11 relative, as
tests/test_fe_sharded.py holds its sharded run, and the port's one-rank u
within 1e-12 of max|u|. The cases: tests/test_fe_sharded.py's three
(Poisson1 F-cycle at M=(8,8,8); the anisotropic Poisson2 at M=(4,4,6),
L=(4/6, 4/6, 1), F-cycle plus one V-cycle; the Q2 M=(8,8,8) levels whose
fine metric holds M/2 elements an axis on a rank), a ladder whose middle
level is split on y and z only (M=(4,8,8)), one that ends on a bottom
split on x and y ((8,8,6) -> (4,4,3)) and the 4-rank grid.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

import torch_ranks
from hpgmg_tpu.fe import fas as jfas
from hpgmg_tpu.fe.grid import FEGrid as JGrid
from hpgmg_tpu.fe.op import get_fe_op as jget_op
from hpgmg_tpu_torch.fe import fas
from hpgmg_tpu_torch.fe.grid import FEGrid
from hpgmg_tpu_torch.fe.op import get_fe_op

UNIT = (1.0, 1.0, 1.0)
# (op, M, L, V-cycles after the F-cycle, build)
POISSON1 = ("poisson1", (8, 8, 8), UNIT, 0, "blocks")
POISSON2 = ("poisson2", (4, 4, 6), (4 / 6, 4 / 6, 1.0), 1, "blocks")
Q2_REAL = ("poisson2", (8, 8, 8), UNIT, 0, "blocks")
MIXED = ("poisson2", (4, 8, 8), (0.5, 1.0, 1.0), 1, "blocks")
BOTTOM = ("poisson1", (8, 8, 6), (1.0, 1.0, 0.75), 1, "blocks")
CUT = ("poisson1", (8, 8, 8), UNIT, 0, "cut")
EIGHT = {"poisson1": POISSON1, "poisson2": POISSON2, "q2": Q2_REAL, "mixed": MIXED,
         "bottom": BOTTOM, "cut": CUT}
FOUR = {"poisson2-4": ("poisson2", (4, 4, 6), (4 / 6, 4 / 6, 1.0), 1, "blocks"),
        "poisson1-4": ("poisson1", (8, 8, 8), UNIT, 1, "blocks")}
CASES = {**EIGHT, **FOUR}
JAX_TOL = 1e-11
ONE_RANK_TOL = 1e-12
T, F = True, False


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every rank's results of the 8-rank and the 4-rank job."""
    eight, four = torch_ranks.spawn([
        (torch_ranks.fe_solve_body, 8, tmp_path_factory.mktemp("fe8"), list(EIGHT.values())),
        (torch_ranks.fe_solve_body, 4, tmp_path_factory.mktemp("fe4"), list(FOUR.values()))])
    return {**{k: (eight, c) for k, c in EIGHT.items()},
            **{k: (four, c) for k, c in FOUR.items()}}


# the V-cycles each problem needs: the cases of one problem share one solve
CYCLES = {}
for _c in CASES.values():
    CYCLES[_c[:3]] = max(CYCLES.get(_c[:3], 0), _c[3])


@functools.lru_cache(maxsize=None)
def jax_serial(problem):
    """The JAX package's u after the F-cycle and each V-cycle of
    ``problem`` (op, M, L), whole levels, jitted."""
    name, M, L = problem
    op = jget_op(name)
    levels = jfas.build_fe_levels(JGrid(M=M, degree=op.degree, L=L), op, jnp.float64)
    f = jax.jit(lambda L0: op.forcing(L0.grid, L0.coords, "sine"))(levels[0])
    us = [jax.jit(lambda lv, b: jfas.fas_fcycle(op, lv, 0, b))(levels, f)]
    vcycle = jax.jit(lambda lv, b, u: jfas.fas_vcycle(op, lv, 0, b, u))
    for _ in range(CYCLES[problem]):
        us.append(vcycle(levels, f, us[-1]))
    return [np.asarray(u) for u in us]


@functools.lru_cache(maxsize=None)
def one_rank(case):
    """The port's u on one rank, the same cycles."""
    name, M, L, cycles, _ = case
    op = get_fe_op(name)
    levels = fas.build_fe_levels(FEGrid(M=M, degree=op.degree, L=L), op, torch.float64,
                                 device="cpu")
    f = op.forcing(levels[0].grid, levels[0].coords, "sine")
    u = fas.fas_fcycle(op, levels, 0, f)
    us = [u.numpy()]
    for _ in range(cycles):
        u = fas.fas_vcycle(op, levels, 0, f, u)
        us.append(u.numpy())
    return us


def rel(port, ref) -> float:
    return float(np.max(np.abs(np.asarray(port) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("name", list(CASES))
def test_decomposed_u_equals_jax_serial(jobs, name):
    ranks, case = jobs[name]
    us = ranks[0][case]["u"]
    for got, ref in zip(us, jax_serial(case[:3])[:len(us)], strict=True):
        assert rel(got.numpy(), ref) <= JAX_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_decomposed_u_equals_one_rank(jobs, name):
    """Every rank gathers the same u, within 1e-12 of max|u| of the
    one-rank u after each cycle."""
    ranks, case = jobs[name]
    for got, ref in zip(ranks[0][case]["u"], one_rank(case), strict=True):
        assert rel(got.numpy(), ref) <= ONE_RANK_TOL
    for res in ranks[1:]:
        for a, b in zip(res[case]["u"], ranks[0][case]["u"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name,split", [
    ("poisson1", [(T, T, T), (T, T, T), None, None]),
    ("poisson2", [(T, T, T), None]),
    ("q2", [(T, T, T), (T, T, T), None, None]),
    ("mixed", [(T, T, T), (F, T, T), None]),
    ("bottom", [(T, T, T), (T, T, F)]),
    ("cut", [(T, T, T), (T, T, T), None, None]),
    ("poisson2-4", [(T, T, F), None]),
    ("poisson1-4", [(T, T, F), (T, T, F), None, None]),
])
def test_levels_split_by_the_jax_rule(jobs, name, split):
    """Each level split where _axis_spec splits an axis (a rank keeps >= 2
    elements along it), replicated below; the mixed ladder's middle level
    on y and z only, the (8,8,6) ladder's bottom on x and y."""
    ranks, case = jobs[name]
    for res in ranks:
        assert res[case]["split"] == split


def test_sharding_is_real(jobs):
    """The fine level is distributed, not replicated: a rank's metric_a
    holds M/2 elements an axis (tests/test_fe_sharded.py:test_sharding_is_real)
    and the coarsest level is replicated."""
    ranks, case = jobs["q2"]
    assert tuple(ranks[0]["grid"]) == (2, 2, 2)
    for res in ranks:
        assert res[case]["metric_a"] == (3, 3, 3, 3, 3, 4, 4, 4)
        assert res[case]["split"][-1] is None
    four, case4 = jobs["poisson1-4"]
    assert tuple(four[0]["grid"]) == (2, 2, 1)
    assert four[0][case4]["metric_a"] == (3, 3, 2, 2, 2, 4, 4, 8)


def test_cut_levels_equal_block_built(jobs):
    """Levels built whole and cut (shard_fe_levels, shard_fe_field) give the
    u of levels built on the blocks."""
    ranks, cut = jobs["cut"]
    _, blocks = jobs["poisson1"]
    assert rel(ranks[0][cut]["u"][0].numpy(), ranks[0][blocks]["u"][0].numpy()) <= 1e-13
