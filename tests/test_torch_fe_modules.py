"""Per-module parity of the port's FE path (hpgmg_tpu_torch/fe) with the
JAX package on the CPU, float64.

The same seeded numpy inputs go through the JAX function and its port.
The reference element is equal bit for bit; the solutions agree to
max|port - jax| / max|jax| <= 1e-14; the grid's gather, assembly and
transfers to 1e-13 (the port sums each node's element contributions in
another order than the JAX package's 0/1-matrix products); the operator
layer (metric, apply, diagonal, forcing, norms) to 1e-12. The invariants
of tests/test_fe.py hold on the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.fe.grid import FEGrid as JGrid
from hpgmg_tpu.fe.op import get_fe_op as jget_op
from hpgmg_tpu.fe.reference import ReferenceElement as JRef
from hpgmg_tpu.fe.solutions import get_solution as jget_solution
from hpgmg_tpu_torch.fe.grid import FEGrid
from hpgmg_tpu_torch.fe.op import get_fe_op
from hpgmg_tpu_torch.fe.reference import ReferenceElement
from hpgmg_tpu_torch.fe.solutions import get_solution

CPU = torch.device("cpu")
F64 = torch.float64
# (M, L, distort): the cube and a distorted anisotropic grid
GRIDS = {"cube": ((4, 4, 4), (1.0, 1.0, 1.0), 0.0),
         "aniso_distorted": ((2, 4, 6), (2 / 6, 4 / 6, 1.0), 0.05)}
OPS = ["poisson1", "poisson2", "poisson2affine", "project", "project2"]


def rel(port, ref) -> float:
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.max(np.abs(port - ref)) / np.max(np.abs(ref)))


def grids(M, degree, L=(1.0, 1.0, 1.0)):
    return FEGrid(M=M, degree=degree, L=L), JGrid(M=M, degree=degree, L=L)


@pytest.mark.parametrize("degree,addquadpts", [(1, 0), (2, 0), (2, 1)])
def test_reference_element_equal(degree, addquadpts):
    ours, theirs = ReferenceElement(degree, addquadpts), JRef(degree, addquadpts)
    assert (ours.P, ours.Q) == (theirs.P, theirs.Q)
    for a, b in zip(ours.tensors() + (ours.interp_weights(),),
                    theirs.tensors() + (theirs.interp_weights(),)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["sine", "hump", "wave"])
def test_solutions(name):
    x = np.random.default_rng(3).uniform(0.0, 0.75, (3, 7, 5))
    L = (0.75, 1.0, 1.25)
    for port, ref in zip(get_solution(name)(torch.tensor(x), L),
                         jget_solution(name)(jnp.asarray(x), L)):
        assert rel(port, ref) <= 1e-14


@pytest.mark.parametrize("M", [(8, 8, 8), (8, 16, 24), (2, 4, 6), (3, 4, 4)])
@pytest.mark.parametrize("degree", [1, 2])
def test_grid_nodes_and_ladder(M, degree):
    g, jg = grids(M, degree)
    assert g.num_levels() == jg.num_levels()
    while True:
        assert (g.M, g.nodes, g.ndof, g.neq) == (jg.M, jg.nodes, jg.ndof, jg.neq)
        assert g.can_coarsen() == jg.can_coarsen()
        if not g.can_coarsen():
            break
        g, jg = g.coarsen(), jg.coarsen()


@pytest.mark.parametrize("distort", [0.0, 0.05])
@pytest.mark.parametrize("degree", [1, 2])
def test_node_coords(degree, distort):
    g, jg = grids((2, 4, 6), degree, (2 / 6, 4 / 6, 1.0))
    X = g.node_coords(F64, distort, CPU)
    assert X.shape == (3,) + g.nodes
    np.testing.assert_allclose(X.numpy(), np.asarray(jg.node_coords(distort=distort)),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("kind", ["extract", "assemble", "assemble_interior", "inject",
                                  "interpolate", "restrict"])
@pytest.mark.parametrize("M", [(4, 4, 4), (2, 4, 6)])
@pytest.mark.parametrize("degree", [1, 2])
def test_grid_operations(degree, M, kind):
    g, jg = grids(M, degree)
    rng = np.random.default_rng(11)
    P = degree + 1
    if kind == "extract":
        u = rng.standard_normal(g.nodes)
        out, ref = g.extract_elements(torch.tensor(u)), jg.extract_elements(jnp.asarray(u))
    elif kind == "assemble":
        E = rng.standard_normal((P, P, P) + M)
        out, ref = g.assemble_add(torch.tensor(E)), jg.assemble_add(jnp.asarray(E))
    elif kind == "assemble_interior":
        E = rng.standard_normal((P, P, P) + M)
        out = g.assemble_interior(torch.tensor(E))
        ref = jg.zero_boundaries(jg.assemble_add(jnp.asarray(E)))
    elif kind == "inject":
        u = rng.standard_normal(g.nodes)
        out, ref = g.inject(torch.tensor(u)), jg.inject(jnp.asarray(u))
    elif kind == "interpolate":
        uc = rng.standard_normal(g.coarsen().nodes)
        out = g.interpolate(g.coarsen(), torch.tensor(uc))
        ref = jg.interpolate(jg.coarsen(), jnp.asarray(uc))
    else:
        v = rng.standard_normal(g.nodes)
        out = g.restrict(g.coarsen(), torch.tensor(v))
        ref = jg.restrict(jg.coarsen(), jnp.asarray(v))
    assert tuple(out.shape) == ref.shape
    assert rel(out, ref) <= 1e-13


@pytest.mark.parametrize("name", OPS)
@pytest.mark.parametrize("case", sorted(GRIDS))
def test_operator(name, case):
    """metric, apply, diagonal, forcing and integrate_norms on the port's
    own coordinates against the JAX package's."""
    M, L, distort = GRIDS[case]
    op, jop = get_fe_op(name), jget_op(name)
    g, jg = grids(M, op.degree, L)
    X = g.node_coords(F64, distort, CPU)
    JX = jg.node_coords(distort=distort)
    metric = op.make_metric(g, X, F64, CPU)
    jmetric = jop.make_metric(jg, JX, jnp.float64)
    for port, ref in zip(metric, jmetric):
        assert tuple(port.shape) == ref.shape
        assert rel(port, ref) <= 1e-12
    rng = np.random.default_rng(5)
    u = np.asarray(jg.zero_boundaries(jnp.asarray(rng.standard_normal(g.nodes))))
    assert rel(op.apply(g, X, torch.tensor(u)), jop.apply(jg, JX, jnp.asarray(u))) <= 1e-12
    assert rel(op.diagonal(g, X, F64), jop.diagonal(jg, JX)) <= 1e-12
    assert rel(op.forcing(g, X, "sine"), jop.forcing(jg, JX, "sine")) <= 1e-12
    for port, ref in zip(op.integrate_norms(g, X, torch.tensor(u), "sine"),
                         jop.integrate_norms(jg, JX, jnp.asarray(u), "sine")):
        assert abs(float(port) - float(ref)) <= 1e-12 * abs(float(ref))


@pytest.mark.parametrize("degree", [1, 2])
def test_restrict_is_interp_transpose(degree):
    """<P uc, vf> == <uc, R vf> (t045-ferestrict analog)."""
    gf = FEGrid(M=(4, 4, 4), degree=degree)
    gc = gf.coarsen()
    rng = np.random.default_rng(0)
    uc = torch.tensor(rng.standard_normal(gc.nodes))
    vf = torch.tensor(rng.standard_normal(gf.nodes))
    lhs = float(torch.sum(gf.interpolate(gc, uc) * vf))
    rhs = float(torch.sum(uc * gf.restrict(gc, vf)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("name", ["poisson1", "poisson2"])
def test_apply_symmetric(name):
    op = get_fe_op(name)
    g = FEGrid(M=(4, 4, 4), degree=op.degree)
    X = g.node_coords(F64, 0.05, CPU)
    rng = np.random.default_rng(1)
    u = g.zero_boundaries(torch.tensor(rng.standard_normal(g.nodes)))
    v = g.zero_boundaries(torch.tensor(rng.standard_normal(g.nodes)))
    d1 = float(torch.sum(op.apply(g, X, u) * v))
    d2 = float(torch.sum(u * op.apply(g, X, v)))
    np.testing.assert_allclose(d1, d2, rtol=1e-12)


@pytest.mark.parametrize("name", ["poisson1", "poisson2", "poisson2affine"])
def test_diagonal_matches_probe(name):
    """diag(A) matches one-hot probes of the operator (t110-poissondiag)."""
    op = get_fe_op(name)
    g = FEGrid(M=(2, 2, 2), degree=op.degree)
    X = g.node_coords(F64, 0.0, CPU)
    d = op.diagonal(g, X, F64)
    for idx in [(1, 1, 1)] + ([(1, 2, 1), (3, 2, 1)] if op.degree == 2 else []):
        e = torch.zeros(g.nodes, dtype=F64)
        e[idx] = 1.0
        np.testing.assert_allclose(float(op.apply(g, X, e)[idx]), float(d[idx]),
                                   rtol=1e-12, err_msg=str(idx))
