"""The port's FE placement (hpgmg_tpu_torch/fe/mesh.py) and each block
operation of a decomposed level against the whole level's.

* ``_axis_spec`` equals hpgmg_tpu.fe.mesh._axis_spec over a table of M
  and process-grid shapes (the JAX function given a stub with a ``.shape``
  dict: no devices needed).
* ``FEPart``'s blocks, seen from every rank of a grid, cover each node of
  the level, own each exactly once, and agree on the planes they share.
* One spawned job of 8 gloo ranks on the (2, 2, 2) grid
  (tests/torch_ranks.py:fe_ops_body), float64, three ladders: Q2 (8,8,8)
  (split, split alike, replicated), Q1 (4,8,8) (split on x, y and z, then
  on y and z, then replicated) and Q1 (6,6,4) (blocks of 3 elements, odd
  node offsets, then replicated). On every rank and level the coords,
  dinv (the diagonal), the forcing, the operator, assemble_interior of an
  element field, restrict, interpolate and inject equal the whole level's
  cut to the block (to 1e-13 of the field's max; coords and inject bit for
  bit), and the owned node sum of a product equals the level's sum.
* A block's local node sums (fe/grid.py:_assemble_local) equal the
  block's own assembly with its domain faces zeroed, for blocks with low
  domain faces, high ones only, and none (an inner block of a 3x3x3 grid).
* A function that is not decomposed raises on a block instead of giving
  the block's answer.
"""

import types

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

import torch_ranks
from hpgmg_tpu.fe.mesh import _axis_spec as jaxis_spec
from hpgmg_tpu_torch.fe import fas
from hpgmg_tpu_torch.fe import mesh as FM
from hpgmg_tpu_torch.fe.grid import FEGrid, _assemble_local
from hpgmg_tpu_torch.fe.op import get_fe_op
from hpgmg_tpu_torch.parallel.mesh import Mesh

CPU = torch.device("cpu")
F64 = torch.float64
SPEC_M = [(8, 8, 8), (4, 4, 6), (2, 2, 2), (4, 8, 8), (6, 6, 4), (3, 5, 7), (16, 2, 4),
          (1, 1, 1), (4, 4, 3), (12, 6, 8), (64, 64, 64)]
SPEC_SHAPES = [(2, 2, 2), (2, 2, 1), (4, 2, 1), (1, 1, 1), (8, 1, 1), (2, 1, 2), (4, 4, 4),
               (3, 1, 1)]
OPS_CASES = [("poisson2", (8, 8, 8)), ("poisson1", (4, 8, 8)), ("poisson1", (6, 6, 4))]
TOL = 1e-13


@pytest.mark.parametrize("shape", SPEC_SHAPES)
def test_axis_spec_equals_jax(shape):
    stub = types.SimpleNamespace(shape=dict(zip(("x", "y", "z"), shape)))
    for M in SPEC_M:
        assert FM._axis_spec(shape, M) == jaxis_spec(stub, M), (shape, M)
        assert FM._axis_spec(Mesh(shape, 0, "gloo", CPU), M) == jaxis_spec(stub, M)


def parts(shape, M, degree):
    """The FEPart of level M on every rank of the grid ``shape``."""
    grid = FEGrid(M=M, degree=degree)
    size = int(np.prod(shape))
    return grid, [FM.fe_level_part(Mesh(shape, r, "gloo", CPU), grid) for r in range(size)]


@pytest.mark.parametrize("shape,M,degree", [((2, 2, 2), (8, 8, 8), 2), ((2, 2, 2), (6, 6, 4), 1),
                                            ((2, 2, 1), (4, 8, 6), 2), ((4, 2, 1), (8, 4, 4), 1),
                                            ((2, 2, 2), (4, 8, 8), 1)])
def test_blocks_cover_and_own_each_node_once(shape, M, degree):
    grid, ps = parts(shape, M, degree)
    assert all(p is not None for p in ps)
    covered = np.zeros(grid.nodes, int)
    owned = np.zeros(grid.nodes, int)
    for p in ps:
        box = tuple(slice(o, o + n) for o, n in zip(p.node_offsets, p.nodes))
        covered[box] = 1
        if p.owner:
            owned[tuple(slice(o, o + n) for o, n in zip(p.node_offsets, p.owned))] += 1
        assert p.block.M == p.elems and p.block.nodes == p.nodes
        assert p.block.spacing == grid.spacing and p.block.L == grid.L
        for a in range(3):
            lo, hi = p.domain_faces[a]
            assert lo == (p.node_offsets[a] == 0)
            assert hi == (p.node_offsets[a] + p.nodes[a] == grid.nodes[a])
            up = p.neighbor(a, +1)
            if hi:
                assert up is None
            else:  # the rank above starts at this block's last plane
                assert ps[up].node_offsets[a] == p.node_offsets[a] + p.nodes[a] - 1
    assert covered.all() and (owned == 1).all()


def test_replicated_levels_have_no_part():
    mesh = Mesh((2, 2, 2), 0, "gloo", CPU)
    assert FM.fe_level_part(None, FEGrid((8, 8, 8), 2)) is None
    assert FM.fe_level_part(mesh, FEGrid((2, 2, 2), 2)) is None
    assert FM.fe_level_part(mesh, FEGrid((3, 3, 3), 1)) is None
    assert FM.fe_level_part(mesh, FEGrid((2, 4, 4), 1)).split == (False, True, True)
    levels = [types.SimpleNamespace(grid=FEGrid((2, 2, 2), 1))]
    assert FM.shard_fe_levels(None, levels) is levels
    assert FM.shard_fe_levels(mesh, levels)[0] is levels[0]
    x = torch.zeros(3, 3, 3)
    assert FM.shard_fe_field(mesh, levels[0], x) is x


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Every rank's results of the 8-rank job."""
    ranks, = torch_ranks.spawn([(torch_ranks.fe_ops_body, 8, tmp_path_factory.mktemp("feops"),
                                 OPS_CASES)])
    return ranks


def whole(name, M):
    """The whole levels of the case and the fields fe_ops_body draws."""
    op = get_fe_op(name)
    levels = fas.build_fe_levels(FEGrid(M=M, degree=op.degree), op, F64, device=CPU)
    return op, levels


def held(place, x):
    """The part of the whole level's node field a rank holds."""
    if place is None:
        return x
    _, off, n = place
    return x[(Ellipsis,) + tuple(slice(o, o + m) for o, m in zip(off, n))]


def close(got, want, tol=TOL):
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    assert got.shape == want.shape
    assert np.max(np.abs(got.numpy() - want)) <= tol * np.max(np.abs(want))


def field(shape, seed):
    return torch.tensor(torch_ranks.fe_field(shape, seed))


def reference(op, levels, lev, what):
    """The whole level's answer to fe_ops_body's ``what`` on level ``lev``."""
    lv = levels[lev]
    g = lv.grid
    x = field(g.nodes, lev)
    if what == "coords":
        return lv.coords
    if what == "dinv":
        return lv.dinv
    if what == "forcing":
        return op.forcing(g, lv.coords, "sine")
    if what == "apply":
        return op.apply(g, lv.coords, x, metric=(lv.metric_a, lv.metric_w))
    if what == "assemble":
        return g.assemble_interior(field((op.degree + 1,) * 3 + tuple(g.M), lev + 200))
    if what == "dot":
        return torch.sum(x * field(g.nodes, lev + 100))
    gc = levels[lev + 1].grid
    if what == "restrict":
        return g.restrict(gc, x)
    if what == "interpolate":
        return g.interpolate(gc, field(gc.nodes, lev + 300))
    return g.inject(x)


@pytest.mark.parametrize("case", OPS_CASES, ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}")
@pytest.mark.parametrize("what", ["coords", "dinv", "forcing", "apply", "assemble", "dot",
                                  "restrict", "interpolate", "inject"])
def test_block_op_equals_whole_level_cut(job, case, what):
    op, levels = whole(*case)
    assert tuple(job[0]["grid"]) == (2, 2, 2)
    for rank, res in enumerate(job):
        rows = res[case]["levels"]
        assert len(rows) == len(levels)
        for lev, row in enumerate(rows):
            if what not in row:  # the transfers of the coarsest level
                assert lev == len(levels) - 1
                continue
            want = reference(op, levels, lev, what)
            got = row[what]
            if what == "dot":
                assert abs(float(got) - float(want)) <= TOL * float(
                    torch.sum(torch.abs(field(levels[lev].grid.nodes, lev)
                                        * field(levels[lev].grid.nodes, lev + 100))))
                continue
            to = rows[lev + 1]["place"] if what in ("restrict", "inject") else row["place"]
            want = held(to, want)
            if what in ("coords", "inject"):
                assert torch.equal(got, want), (rank, lev)
            else:
                close(got, want)


def test_ladders_are_placed_as_expected(job):
    T, F = True, False
    want = {OPS_CASES[0]: [(T, T, T), (T, T, T), None, None],
            OPS_CASES[1]: [(T, T, T), (F, T, T), None],
            OPS_CASES[2]: [(T, T, T), None]}
    for res in job:
        for case, split in want.items():
            assert [r["place"] and r["place"][0] for r in res[case]["levels"]] == split


def block_level():
    """Rank 0's block of a Q2 (4,4,4) level on a (2,2,2) grid, built whole
    and cut: no process group is needed to reach the refusals."""
    mesh = Mesh((2, 2, 2), 0, "gloo", CPU)
    op = get_fe_op("poisson2")
    levels = FM.shard_fe_levels(mesh, fas.build_fe_levels(FEGrid((4, 4, 4), 2), op, F64,
                                                          device=CPU))
    return op, levels[0]


@pytest.mark.parametrize("degree,M", [(1, (3, 4, 2)), (2, (2, 3, 2))])
@pytest.mark.parametrize("keep", [((False, True), (True, True), (True, True)),
                                  ((True, True), (True, False), (True, True)),
                                  ((True, False), (True, False), (True, False)),
                                  ((True, True), (True, True), (True, True)),
                                  ((False, False), (False, False), (False, False))])
def test_block_local_sums_equal_masked_assembly(keep, degree, M):
    """The local sums of a block with domain faces where ``keep`` says
    False: the block's assemble_add with those faces zeroed, whichever
    value of E the missing contributions point at; E itself is changed
    only in that one value."""
    P = degree + 1
    E = torch.tensor(np.random.default_rng(7).standard_normal((P, P, P) + M))
    want = FEGrid(M=M, degree=degree).assemble_add(E)
    for a, (lo, hi) in enumerate(keep):
        idx = [slice(None)] * 3
        if not lo:
            idx[a] = 0
            want[tuple(idx)] = 0
        if not hi:
            idx[a] = -1
            want[tuple(idx)] = 0
    E0 = E.clone()
    got = _assemble_local(E, M, degree, keep).view(want.shape)
    assert (got - want).abs().max() <= 1e-14 * want.abs().max()
    assert int((E != E0).sum()) <= 1


@pytest.mark.parametrize("what", ["diagnostics", "nodal_diagnostics", "ksp_chebyshev",
                                  "integrate_norms", "assemble_add"])
def test_not_decomposed_raises_on_a_block(what):
    op, L = block_level()
    assert L.part is not None
    u = torch.zeros(L.block.nodes, dtype=F64)
    calls = {"diagnostics": lambda: fas.diagnostics(op, L, u, u, "sine"),
             "nodal_diagnostics": lambda: fas.nodal_diagnostics(op, L, u, u, "sine"),
             "ksp_chebyshev": lambda: fas.ksp_chebyshev(op, L, u),
             "integrate_norms": lambda: op.integrate_norms(L.block, L.coords, u, "sine"),
             "assemble_add": lambda: L.block.assemble_add(
                 torch.zeros((3, 3, 3) + L.block.M, dtype=F64))}
    with pytest.raises(NotImplementedError, match="decomposed level"):
        calls[what]()
