"""The port's process grid and halo exchange (hpgmg_tpu_torch/parallel)
against the JAX package on the CPU.

* ``_factor3``, the i/j grid shape of ``make_mesh_ij`` and the
  ``level_sharding`` ladder equal the JAX functions' decisions for 1-8
  ranks and level extents 8-512 (pure functions).
* One spawned gloo job of 4 CPU ranks (tests/torch_ranks.py: slab_body) at
  32^3 float64: the slabs each rank of the 2x2 grid, and each of the two
  ranks of a 2x1 grid, builds for K8a (fv4, 2 deep) and K8c (the fv7pt,
  fv2 and 27pt taps, 1 deep), Dirichlet and periodic, equal the slices of
  the globally ghost-extended field (the JAX package's ops/bc_fv.py and
  ops/bc.py fills), corners included; the explicit halo exchange and the
  7-point operator and Jacobi sweeps built on it equal their global
  versions; K8d's rhs ring, the gather and the mesh-aware dot, max norm
  and mean equal the global field's. Exact to 1e-15 relative.
* ``level_part`` on the 2x2 grid: a Part where the blocks have even
  extents (36^3, 16^3), None where the level is replicated (9^3) or its
  blocks would be odd (18^3 in 9x9 blocks, which the slab kernels do not
  take).
* The entry point ``python -m hpgmg_tpu_torch.bench.weak`` on 2 CPU ranks:
  its JSON line, and u equal to the one-rank F-cycle's to 1e-10.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

import torch_ranks
from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.ops.bc import ghost_fill_linear, ghost_fill_periodic, ghost_fill_quadratic_fd
from hpgmg_tpu.ops.bc_fv import ghost_fill_fv
from hpgmg_tpu.parallel.mesh import _factor3 as jfactor3
from hpgmg_tpu.parallel.mesh import level_sharding as jlevel_sharding
from hpgmg_tpu.parallel.mesh import make_mesh_ij as jmake_mesh_ij
from hpgmg_tpu_torch.bench import weak
from hpgmg_tpu_torch.parallel import mesh as M

N = 32
TOL = 1e-15
DIMS = (8, 12, 16, 24, 32, 40, 48, 64, 96, 128, 192, 256, 384, 512)


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(port) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("ranks", range(1, 9))
def test_grid_shapes_match_jax(ranks):
    assert M._factor3(ranks) == jfactor3(ranks)
    jmesh = jmake_mesh_ij(jax.devices()[:ranks])
    assert M.mesh_ij_shape(ranks) == tuple(jmesh.shape[a] for a in ("x", "y", "z"))


@pytest.mark.parametrize("rank", range(4))
def test_level_part_replicates_odd_blocks(rank):
    mesh = M.Mesh(shape=(2, 2, 1), rank=rank, backend="gloo",
                  device=torch.device("cpu"))
    for dim in (36, 16):
        part = M.level_part(mesh, dim)
        assert part is not None and part.split == (True, True)
        assert (part.ni, part.nj) == (dim // 2, dim // 2)
        assert (part.oi, part.oj) == (dim // 2 * (rank // 2), dim // 2 * (rank % 2))
    assert M.level_sharding(mesh, 18) == ("x", "y")  # split by the JAX rule...
    assert M.level_part(mesh, 18) is None  # ...but its 9x9 blocks are odd
    assert M.level_part(mesh, 9) is None


@pytest.mark.parametrize("ranks", range(1, 9))
def test_level_sharding_ladder_matches_jax(ranks):
    jmesh = jmake_mesh_ij(jax.devices()[:ranks])
    for dim in DIMS:
        for face_axis in (None, 0, 1):
            spec = jlevel_sharding(jmesh, dim, face_axis).spec
            want = tuple(s for s in spec if s is not None) or M.REPLICATED
            got = M.level_sharding(M.mesh_ij_shape(ranks), dim, face_axis)
            assert got == want, (dim, face_axis)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4-rank job's results, by rank."""
    return torch_ranks.spawn([(torch_ranks.slab_body, 4, tmp_path_factory.mktemp("gloo"),
                               N)])[0]


def _global_fill(kind: str, bc: str):
    """(radius, the global field with its ghosts) of the JAX fills."""
    x = jnp.asarray(torch_ranks.global_field(N).numpy())
    jbc = JBC(bc)
    if kind == "fv4":
        return 2, ghost_fill_fv(x, jbc, order=4, radius=2)
    if kind == "v2":
        return 1, ghost_fill_fv(x, jbc, order=2, radius=1)
    if kind == "p1":
        return 1, ghost_fill_linear(x, jbc, radius=1)
    return 1, ghost_fill_quadratic_fd(x, jbc, radius=1)


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("kind", ["fv4", "p1", "v2", "27pt"])
@pytest.mark.parametrize("grid", ["2x2", "2x1"])
def test_rank_slabs_equal_global_fill(ranks, grid, kind, bc):
    r, xg = _global_fill(kind, bc)
    xg = np.asarray(xg)[:, :, r:r + N]  # k is never split
    for rank, res in enumerate(ranks[:4 if grid == "2x2" else 2]):
        oi, oj, ni, nj = res[(grid, "part")]
        ilo, ihi, jlo, jhi = (s.numpy() for s in res[(grid, kind, bc)])
        want = (xg[oi:oi + r, oj + r:oj + r + nj],
                xg[oi + r + ni:oi + 2 * r + ni, oj + r:oj + r + nj],
                xg[oi:oi + ni + 2 * r, oj:oj + r],
                xg[oi:oi + ni + 2 * r, oj + r + nj:oj + 2 * r + nj])
        for name, got, ref in zip(("ilo", "ihi", "jlo", "jhi"), (ilo, ihi, jlo, jhi), want):
            assert got.shape == ref.shape, (rank, name)
            assert rel(got, ref) <= TOL, (rank, name)


def test_edge_flags(ranks):
    assert [res[("2x2", "edges")] for res in ranks] == [
        (True, False, True, False), (True, False, False, True),
        (False, True, True, False), (False, True, False, True)]
    assert [res[("2x1", "edges")] for res in ranks[:2]] == [
        (True, False, True, True), (False, True, True, True)]


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_explicit_halo_exchange_and_poisson7(ranks, bc):
    """halo_exchange(radius 2) is the global wrap (or zeros at Dirichlet
    faces); the 7-point operator on it equals the global one."""
    x = torch_ranks.global_field(N).numpy()
    if bc == "periodic":
        xg = np.asarray(ghost_fill_periodic(jnp.asarray(x), 2))
    else:
        xg = np.pad(x, 2)
    g1 = xg[1:-1, 1:-1, 1:-1]
    ref = -4.0 * (g1[:-2, 1:-1, 1:-1] + g1[2:, 1:-1, 1:-1] + g1[1:-1, :-2, 1:-1]
                  + g1[1:-1, 2:, 1:-1] + g1[1:-1, 1:-1, :-2] + g1[1:-1, 1:-1, 2:]
                  - 6.0 * g1[1:-1, 1:-1, 1:-1])
    for res in ranks:
        oi, oj, ni, nj = res[("2x2", "part")]
        ext = res[("exchange2", bc)].numpy()
        assert rel(ext, xg[oi:oi + ni + 4, oj:oj + nj + 4]) <= TOL
        assert rel(res[("poisson7", bc)].numpy(), ref[oi:oi + ni, oj:oj + nj]) <= TOL


def test_explicit_jacobi_sweeps(ranks):
    x = torch_ranks.global_field(N).numpy()
    ref = x
    for _ in range(3):
        g = np.asarray(ghost_fill_periodic(jnp.asarray(ref), 1))
        ax = -4.0 * (g[:-2, 1:-1, 1:-1] + g[2:, 1:-1, 1:-1] + g[1:-1, :-2, 1:-1]
                     + g[1:-1, 2:, 1:-1] + g[1:-1, 1:-1, :-2] + g[1:-1, 1:-1, 2:]
                     - 6.0 * g[1:-1, 1:-1, 1:-1])
        ref = ref + (2.0 / 3.0) / 24.0 * (1.0 - ax)
    for res in ranks:
        oi, oj, ni, nj = res[("2x2", "part")]
        assert rel(res["jacobi"].numpy(), ref[oi:oi + ni, oj:oj + nj]) <= 1e-14


def test_rhs_ring_gather_and_reductions(ranks):
    x = torch_ranks.global_field(N).numpy()
    y = torch_ranks.global_field(N, torch_ranks.SEED + 1).numpy()
    xz = np.pad(x, ((1, 1), (1, 1), (0, 0)))  # zeros outside the domain
    for res in ranks:
        oi, oj, ni, nj = res[("2x2", "part")]
        assert rel(res["rhs_ring"].numpy(), xz[oi:oi + ni + 2, oj:oj + nj + 2]) <= TOL
        assert np.array_equal(res["gather"].numpy(), x)
        assert abs(float(res["dot"]) - float(np.sum(x * y))) <= 1e-12 * np.sum(np.abs(x * y))
        assert float(res["norm"]) == float(np.max(np.abs(x)))
        assert abs(float(res["mean"]) - float(np.mean(x))) <= 1e-15


def test_weak_entry_point_on_the_cpu(capsys):
    """python -m hpgmg_tpu_torch.bench.weak on 2 CPU ranks over gloo: one
    JSON line with the benchmark's keys, the grid and the backend, u equal
    to the one-rank F-cycle's; the ranks are killed after 240 s."""
    rc = weak.main(["--ranks", "2", "--backend", "gloo", "--device", "cpu",
                    "--per-rank", "16", "--dtype", "float64", "--dynamic-range", "1",
                    "--check-serial", "--timeout", "240"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["grid"] == [2, 1, 1] and out["ranks"] == 2 and out["backend"] == "gloo"
    assert out["n"] == 32 and out["metric"] == "fv4_fcycle_dof_per_s_n32_ranks2"
    assert out["serial_u_rel_diff"] <= 1e-10
    assert abs(out["rel_residual"] - out["serial_rel_residual"]) <= 1e-10 * out["rel_residual"]
