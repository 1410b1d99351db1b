"""The port's 3D process grid (hpgmg_tpu_torch/parallel/mesh.py:
make_mesh, make_pod_mesh) on the CPU over gloo, against the JAX package.

* The rank -> (cx, cy, cz) maps of ``make_mesh`` on 1, 2, 4 and 8 ranks and
  of ``make_pod_mesh(n_slices=2)`` on 4 ranks equal where the JAX
  factories place the device of the same index (conftest gives JAX 8
  virtual CPU devices); ``_factor3`` equals JAX's for 1, 4, 8, 12 and 64.
* One spawned job of 8 ranks on the (2, 2, 2) grid at 32^3 float64
  (tests/torch_ranks.py:solve_body): the fv4 Dirichlet, fv7pt and fv4
  periodic F-cycles with the DIRECT bottom and the fv4 F-cycle with
  BiCGStab, each equal to the JAX package's serial solve
  (tests/jax_serial.py) to 1e-10 relative on u and rel_residual; the
  32^3 and 16^3 levels split along all three axes (16^3 in 8^3 blocks),
  8^3 replicated, and only the slab kernels' plain versions and K3's ran
  on them. The same ranks build every slab set of their block of a
  random field (slab3_body): K8a's (fv4, 2 deep) and K8c's (the fv7pt,
  fv2 and 27pt taps, 1 deep), Dirichlet and periodic, six slabs each,
  equal the slices of the globally ghost-extended field (the JAX fills,
  edges and corners included); the explicit 2-deep exchange, K8d's
  3D rhs ring, the gather and the mesh-aware reductions equal the global
  field's.
* One job of 4 ranks on ``make_pod_mesh(n_slices=2)``, the (2, 1, 2) grid:
  the fv4 F-cycle equals the JAX serial solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jax_serial
import torch_cpu  # noqa: F401  (one intra-op thread a test process)
import torch_ranks
from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.ops.bc import ghost_fill_linear, ghost_fill_periodic, ghost_fill_quadratic_fd
from hpgmg_tpu.ops.bc_fv import ghost_fill_fv
from hpgmg_tpu.parallel.mesh import _factor3 as jfactor3
from hpgmg_tpu.parallel.mesh import make_mesh as jmake_mesh
from hpgmg_tpu.parallel.mesh import make_pod_mesh as jmake_pod_mesh
from hpgmg_tpu_torch.parallel import mesh as M

N = 32
TOL = 1e-10
CASES = {
    "fv4": ("fcycle", "fv4", "dirichlet", "gsrb", "direct", 8, N, 0.0),
    "fv7pt": ("fcycle", "fv7pt", "dirichlet", "gsrb", "direct", 8, N, 0.0),
    "fv4-periodic": ("fcycle", "fv4", "periodic", "gsrb", "direct", 8, N, 0.0),
    "fv4-bicgstab": ("fcycle", "fv4", "dirichlet", "gsrb", "bicgstab", 8, N, 0.0),
}
POD = ("fcycle", "fv4", "dirichlet", "gsrb", "direct", 8, N, 0.0)


def _jax_places(jmesh, n):
    """The grid position of jax.devices()[r], r < n, in the JAX mesh."""
    devs = list(jax.devices())
    arr = np.vectorize(devs.index)(np.asarray(jmesh.devices))
    return [tuple(int(c) for c in np.argwhere(arr == r)[0]) for r in range(n)]


@pytest.mark.parametrize("n", [1, 4, 8, 12, 64])
def test_factor3_matches_jax(n):
    assert M._factor3(n) == jfactor3(n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_places_ranks_as_jax(n):
    jmesh = jmake_mesh(jax.devices()[:n])
    shape = M._factor3(n)
    assert shape == tuple(jmesh.shape[a] for a in M.MESH_AXES)
    mesh = M.Mesh(shape, 0, "gloo", None)
    assert [mesh.coords_of(r) for r in range(n)] == _jax_places(jmesh, n)
    for r in range(n):
        assert mesh.rank_at(*mesh.coords_of(r)) == r


def test_make_pod_mesh_places_ranks_as_jax():
    jmesh = jmake_pod_mesh(jax.devices()[:4], n_slices=2)
    shape, order = M.pod_layout(4, 2)
    assert shape == (2, 1, 2) == tuple(jmesh.shape[a] for a in M.MESH_AXES)
    mesh = M.Mesh(shape, 0, "gloo", None, order)
    assert [mesh.coords_of(r) for r in range(4)] == _jax_places(jmesh, 4)
    for r in range(4):
        assert mesh.rank_at(*mesh.coords_of(r)) == r


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every rank's results of the (2, 2, 2) job, and rank 0's of the pod
    job."""
    eight, pod = torch_ranks.spawn([
        (torch_ranks.mesh3d_body, 8, tmp_path_factory.mktemp("gloo8"), N,
         list(CASES.values())),
        (torch_ranks.solve_body, 4, tmp_path_factory.mktemp("gloo4"), "pod2", [POD])])
    return {"3d": eight, "pod": pod[0]}


@pytest.mark.parametrize("name", list(CASES))
def test_3d_fcycle_equals_jax_serial(jobs, name):
    res = jobs["3d"][0][CASES[name]]
    u, rel = jax_serial.solve(CASES[name])
    assert jax_serial.rel_diff(res["u"].numpy(), u) <= TOL
    assert abs(res["rel"] - rel) <= TOL * rel


def test_pod_fcycle_equals_jax_serial(jobs):
    res = jobs["pod"]
    assert tuple(res["grid"]) == (2, 1, 2)
    u, rel = jax_serial.solve(POD)
    assert jax_serial.rel_diff(res[POD]["u"].numpy(), u) <= TOL
    assert abs(res[POD]["rel"] - rel) <= TOL * rel
    assert res[POD]["split"] == [(True, False, True)] * 2 + [None]


def test_levels_and_kernels_of_the_3d_cycle(jobs):
    """32^3 and 16^3 split along i, j and k, 8^3 replicated; only the slab
    kernels, K3 and (BiCGStab's applies on the replicated bottom) the
    suite's stencil ran their plain versions."""
    out = jobs["3d"][0]
    assert tuple(out["grid"]) == (2, 2, 2)
    for name, case in CASES.items():
        res = out[case]
        assert res["split"] == [(True, True, True)] * 2 + [None], name
        slab = "fv4_slab_plain" if case[1] == "fv4" else "r1_slab_plain"
        assert res["plain_calls"].get(slab, 0) > 0, name
        allowed = {slab, "restrict_cell_plain", "r1_gsrb2_slab_plain"}
        if case[4] == "bicgstab":
            allowed |= {"fv4_subtile_plain", "fv4_stencil_plain"}
        assert set(res["plain_calls"]) <= allowed, (name, res["plain_calls"])
    assert out[CASES["fv7pt"]]["plain_calls"]["r1_gsrb2_slab_plain"] > 0


def _global_fill(kind: str, bc: str):
    """(radius, the global field with its ghosts) of the JAX fills."""
    x = jnp.asarray(torch_ranks.global_field(N).numpy())
    jbc = JBC(bc)
    if kind == "fv4":
        return 2, np.asarray(ghost_fill_fv(x, jbc, order=4, radius=2))
    if kind == "v2":
        return 1, np.asarray(ghost_fill_fv(x, jbc, order=2, radius=1))
    if kind == "p1":
        return 1, np.asarray(ghost_fill_linear(x, jbc, radius=1))
    return 1, np.asarray(ghost_fill_quadratic_fd(x, jbc, radius=1))


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("kind", ["fv4", "p1", "v2", "27pt"])
def test_k_slabs_equal_global_fill(jobs, kind, bc):
    """All six slabs of every rank, the k slabs (ni+2r, nj+2r, r) with
    their edges and corners included."""
    r, xg = _global_fill(kind, bc)
    for rank, res in enumerate(jobs["3d"]):
        s = res["slabs"]
        oi, oj, ok, ni, nj, nk = s["part"]
        i, j, k = (slice(o, o + m + 2 * r) for o, m in ((oi, ni), (oj, nj), (ok, nk)))
        ext = xg[i, j, k]  # the block with its r-deep ghosts on every axis
        want = (ext[:r, r:-r, r:-r], ext[-r:, r:-r, r:-r], ext[:, :r, r:-r],
                ext[:, -r:, r:-r], ext[:, :, :r], ext[:, :, -r:])
        got = s[(kind, bc)]
        assert len(got) == 6
        for name, g, w in zip(("ilo", "ihi", "jlo", "jhi", "klo", "khi"), got, want):
            assert g.shape == w.shape, (rank, name)
            assert jax_serial.rel_diff(g.numpy(), w) <= 1e-15, (rank, name)


def test_exchange_ring_gather_reductions_and_edges(jobs):
    x = torch_ranks.global_field(N).numpy()
    y = torch_ranks.global_field(N, torch_ranks.SEED + 1).numpy()
    xz = np.pad(x, 1)  # zeros outside the domain
    xp = np.asarray(ghost_fill_periodic(jnp.asarray(x), 2))
    xd = np.pad(x, 2)
    for rank, res in enumerate(jobs["3d"]):
        s = res["slabs"]
        oi, oj, ok, ni, nj, nk = s["part"]
        assert tuple(s["grid"]) == (2, 2, 2) and s["coords"] == M.Mesh(
            (2, 2, 2), rank, "gloo", None).coords
        assert (ni, nj, nk) == (N // 2,) * 3
        box2 = (slice(oi, oi + ni + 4), slice(oj, oj + nj + 4), slice(ok, ok + nk + 4))
        assert jax_serial.rel_diff(s[("exchange2", "periodic")].numpy(), xp[box2]) <= 1e-15
        assert jax_serial.rel_diff(s[("exchange2", "dirichlet")].numpy(), xd[box2]) <= 1e-15
        box1 = (slice(oi, oi + ni + 2), slice(oj, oj + nj + 2), slice(ok, ok + nk + 2))
        assert jax_serial.rel_diff(s["rhs_ring"].numpy(), xz[box1]) <= 1e-15
        assert np.array_equal(s["gather"].numpy(), x)
        assert abs(float(s["dot"]) - float(np.sum(x * y))) <= 1e-12 * np.sum(np.abs(x * y))
        assert float(s["norm"]) == float(np.max(np.abs(x)))
        assert abs(float(s["mean"]) - float(np.mean(x))) <= 1e-15
        c = s["coords"]
        assert s["edges"] == tuple(side for a in range(3) for side in (c[a] == 0, c[a] == 1))
        # K8d's slabs at an interior face hold the neighbour's cells
        klo, khi = s["slabs2"][4:]
        if ok > 0:
            assert np.array_equal(klo.numpy()[2:-2, 2:-2], x[oi:oi + ni, oj:oj + nj, ok - 2:ok])
        else:
            assert np.array_equal(khi.numpy()[2:-2, 2:-2],
                                  x[oi:oi + ni, oj:oj + nj, ok + nk:ok + nk + 2])
