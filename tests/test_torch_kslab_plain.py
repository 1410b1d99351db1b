"""The CPU side of the slab kernels on blocks split along k (the 3D
process grid): the plain versions the k-slab kernels are held to, and the
per-rank cuts of a level split along k, without a process group.

* K8a's and K8c's plain versions given k slabs that hold what the k-whole
  block makes (the periodic wrap; the quartic or 2-tap Dirichlet fill of
  the i/j-extended block) equal their k-whole plain versions, bit for bit
  (the wrap, the 2-tap fill) or to 1e-14 (the quartic fill, summed in
  another order);
* K8b's plain interior pass on a block split along k (it keeps off the
  first and last column tiles in k), then its plain edge pass with the six
  slabs, equal K8a's plain version bit for bit; ``overlap_grid_shape``
  wants 3 column tiles along a split k;
* K8d's plain version with both k sides on domain faces (the k slabs
  holding the 2-tap ghost, the ring views and rhs ring with their k ring)
  equals the k-whole plain version bit for bit;
* on every rank of the (2,2,2) grid, ``shard_level`` cuts an fv4 and an
  fv7pt level along k as along i and j (the fv4 faces with their
  tangential margins, the radius-1 faces natural, alpha, dinv and the
  kdinv pair), and ``ring_views`` adds a k ring where the block is split
  along k; ``edge_flags`` names six sides there and four on a block whole
  along k.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import stencils_r1 as K
from hpgmg_tpu_torch.parallel import shard_kernels as SK
from hpgmg_tpu_torch.parallel.mesh import Mesh, Part
from hpgmg_tpu_torch.problems.fv import init_problem_fv
from hpgmg_tpu_torch.problems.p6 import init_problem_p6

CPU = torch.device("cpu")
DT = torch.float64


def _rand(rng):
    def t(*shape, lo=None):
        a = rng.standard_normal(shape) if lo is None else lo + 0.25 * rng.random(shape)
        return torch.tensor(a, dtype=DT)
    return t


def _fv4_block(block, rng):
    ni, nj, nk = block
    n = 2 * max(block)
    t = _rand(rng)
    dinv = t(ni, nj, nk, lo=0.5) / (8.0 * n * n)
    mask = [rb_mask(n, p, DT, CPU)[:ni, :nj, :nk] for p in (0, 1)]
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=t(ni + 1, nj + 2, nk + 2, lo=1.0),
               beta_j=t(ni + 2, nj + 1, nk + 2, lo=1.0),
               beta_k=t(ni + 2, nj + 2, nk + 1, lo=1.0), alpha=t(ni, nj, nk, lo=0.0),
               dinv=dinv, kdinv=tuple(m * dinv for m in mask))
    slabs = (t(2, nj, nk), t(2, nj, nk), t(ni + 4, 2, nk), t(ni + 4, 2, nk))
    return lv, t(ni, nj, nk), t(ni, nj, nk), slabs


def _fv4_cases(lv, rhs):
    return [("apply", {}), ("residual", {"rhs": rhs}),
            ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}),
            ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[1]})]


@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("block", [(4, 4, 8), (6, 10, 12), (8, 16, 16)])
def test_k8a_plain_with_k_slabs_equals_the_k_whole_block(block, bc):
    rng = np.random.default_rng(sum(block))
    lv, x, rhs, slabs = _fv4_block(block, rng)
    xe = S.extend_slabs(x, slabs)
    if bc == BC.PERIODIC:
        k = (xe[:, :, -2:], xe[:, :, :2])
    else:
        k = (S.v4_slab(xe[:, :, :4], 2, True), S.v4_slab(xe[:, :, -4:], 2, False))
    six = slabs + tuple(t.contiguous() for t in k)
    for cfg in (SolverConfig(a=0.0, b=1.0, dtype=DT, bc=bc),
                SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=DT, bc=bc)):
        for mode, kw in _fv4_cases(lv, rhs):
            out = S.fv4_slab_plain(lv, x, six, cfg, mode, **kw)
            ref = S.fv4_slab_plain(lv, x, slabs, cfg, mode, **kw)
            if bc == BC.PERIODIC:
                assert torch.equal(out, ref), mode
            else:
                assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-14, mode


@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("block", [(6, 48, 96), (8, 34, 100)])
def test_k8b_plain_split_with_k_slabs_equals_k8a_plain(block, bc):
    rng = np.random.default_rng(7 + sum(block))
    lv, x, rhs, slabs = _fv4_block(block, rng)
    t = _rand(rng)
    ni, nj, nk = block
    six = slabs + (t(ni + 4, nj + 4, 2), t(ni + 4, nj + 4, 2))
    assert S.overlap_grid_shape(*block) is not None
    cfg = SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=DT, bc=bc)
    for mode, kw in _fv4_cases(lv, rhs):
        inner = S.fv4_overlap_interior_plain(lv, x, cfg, mode, ksplit=True, **kw)
        both = S.fv4_overlap_edge_plain(lv, x, six, cfg, mode, inner, **kw)
        assert torch.equal(both, S.fv4_slab_plain(lv, x, six, cfg, mode, **kw)), mode
        assert torch.equal(S.fv4_overlap(lv, x, six, cfg, mode, **kw), both), mode


def test_overlap_grid_shape_wants_three_tiles_along_a_split_k():
    assert S.overlap_grid_shape(8, 48) is not None
    assert S.overlap_grid_shape(8, 48, 64) is None  # 2 column tiles of 32 in k
    assert S.overlap_grid_shape(8, 48, 66) is not None
    with pytest.raises(ValueError, match="K8b"):
        lv, x, rhs, _ = _fv4_block((8, 48, 64), np.random.default_rng(1))
        S.fv4_overlap_interior_plain(lv, x, SolverConfig(dtype=DT), "apply", ksplit=True)


def _r1_block(block, rng):
    ni, nj, nk = block
    n = 2 * max(block)
    t = _rand(rng)
    dinv = t(ni, nj, nk, lo=0.5) / (8.0 * n * n)
    mask = rb_mask(n, 0, DT, CPU)[:ni, :nj, :nk]
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=t(ni + 1, nj, nk, lo=1.0),
               beta_j=t(ni, nj + 1, nk, lo=1.0), beta_k=t(ni, nj, nk + 1, lo=1.0),
               alpha=t(ni, nj, nk, lo=0.5), dinv=dinv, kdinv=(mask * dinv, (1 - mask) * dinv))
    slabs = (t(1, nj, nk), t(1, nj, nk), t(ni + 2, 1, nk), t(ni + 2, 1, nk))
    return lv, t(ni, nj, nk), t(ni, nj, nk), slabs


@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("taps,var7", [("p1", True), ("v2", True), ("27pt", False)])
def test_k8c_plain_with_k_slabs_equals_the_k_whole_block(taps, var7, bc):
    rng = np.random.default_rng(31)
    lv, x, rhs, slabs = _r1_block((6, 10, 12), rng)
    xe = S.extend_slabs(x, slabs)
    if bc == BC.PERIODIC:
        k = (xe[:, :, -1:], xe[:, :, :1])
    else:
        g = K.taps_ghost(taps)
        k = (g(xe[:, :, :2], 2, True), g(xe[:, :, -2:], 2, False))
    six = slabs + tuple(t.contiguous() for t in k)
    cfg = SolverConfig(op="fv7pt" if var7 else "27pt", a=0.0, b=1.0, dtype=DT, bc=bc)
    for mode, kw in (("apply", {}), ("residual", {"rhs": rhs}), ("fres", {"rhs": rhs}),
                     ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[1]})):
        assert torch.equal(K.r1_slab_plain(lv, x, six, cfg, mode, taps, var7, **kw),
                           K.r1_slab_plain(lv, x, slabs, cfg, mode, taps, var7, **kw)), mode


@pytest.mark.parametrize("taps,var7,helm", [("p1", True, False), ("v2", True, True),
                                            ("27pt", False, False)])
def test_k8d_plain_with_domain_k_faces_equals_the_k_whole_sweep(taps, var7, helm):
    """Both k sides on domain faces: the k slabs hold the 2-tap ghost
    twice (slabs2_for_kernel_r1 builds them so) and the ring views a k
    ring of zeros; red's k ghosts are rebuilt as the k-whole sweep makes
    them."""
    ni, nj, nk = 6, 10, 8
    rng = np.random.default_rng(41)
    t = _rand(rng)
    n = 32
    scale = 1.0 / (8.0 * n * n)
    ring = (ni + 2, nj + 2, nk)
    red = rb_mask(n, 0, DT, CPU)[:ni + 2, :nj + 2, :nk]
    faces = (t(ni + 3, nj + 2, nk, lo=1.0), t(ni + 2, nj + 3, nk, lo=1.0),
             t(ni + 2, nj + 2, nk + 1, lo=1.0))
    whole = Level(dim=n, h=1.0 / n, depth=0, beta_i=faces[0], beta_j=faces[1],
                  beta_k=faces[2],
                  kdinv=(None, (1 - rb_mask(n, 0, DT, CPU)[:ni, :nj, :nk]) * scale),
                  ring=(red * scale * t(*ring, lo=2.0), t(*ring, lo=0.5) if helm else None,
                        *faces))

    def kpad(a):
        return None if a is None else torch.nn.functional.pad(a, (1, 1)).contiguous()

    split = dataclasses.replace(whole, ring=tuple(kpad(r) for r in whole.ring))
    x, rhs2 = t(ni, nj, nk), t(*ring)
    slabs = tuple(t(*s) for s in ((2, nj, nk),) * 2 + ((ni + 4, 2, nk),) * 2)
    xe = S.extend_slabs(x, slabs)
    g2 = K.taps_ghost2(taps)
    six = slabs + (g2(xe[:, :, :2], 2, True).contiguous(),
                   g2(xe[:, :, -2:], 2, False).contiguous())
    cfg = SolverConfig(op="fv7pt" if var7 else "27pt", a=1.5 if helm else 0.0, b=1.0,
                       helmholtz=helm and var7, dtype=DT)
    for edges in ((True, False, True, False), (False,) * 4, (True,) * 4):
        out = K.r1_gsrb2_slab_plain(split, x, six, edges + (True, True), kpad(rhs2), cfg,
                                    taps, var7)
        ref = K.r1_gsrb2_slab_plain(whole, x, slabs, edges, rhs2, cfg, taps, var7)
        assert torch.equal(out, ref), edges


def _global_levels(n):
    """The fv4 and fv7pt benchmark problems' finest levels (rebuilt: the
    fv4 faces tangentially extended, the kdinv pairs folded)."""
    out = {}
    for op, prob in (("fv4", init_problem_fv(n, dtype=DT, device=CPU)),
                     ("fv7pt", init_problem_p6(n, dtype=DT, device=CPU, a=0.0, b=1.0))):
        cfg = SolverConfig(op=op, a=0.0, b=1.0, dtype=DT, min_coarse_dim=8)
        out[op] = (cfg, build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg).levels[0])
    return out


@pytest.mark.parametrize("rank", range(8))
def test_shard_level_cuts_k_on_the_3d_grid(rank):
    n = 16
    mesh = Mesh((2, 2, 2), rank, "gloo", CPU)
    part = Part(mesh, (True, True, True), n)
    (oi, oj, ok), (ni, nj, nk) = part.offsets, part.extents
    assert (ni, nj, nk) == (8, 8, 8) and part.coords == mesh.coords
    assert (oi, oj, ok) == tuple(8 * c for c in mesh.coords)
    box = (slice(oi, oi + ni), slice(oj, oj + nj), slice(ok, ok + nk))
    for op, (cfg, lv) in _global_levels(n).items():
        cut = SK.shard_level(lv, part, cfg)
        assert cut.shape == (ni, nj, nk) and cut.part is part
        m = 2 if op == "fv4" else 0  # the fv4 faces keep their tangential margins
        for name, axis in (("beta_i", 0), ("beta_j", 1), ("beta_k", 2)):
            want = getattr(lv, name)[tuple(
                slice(o, o + e + 1) if a == axis else slice(o, o + e + m)
                for a, (o, e) in enumerate(zip((oi, oj, ok), (ni, nj, nk))))]
            assert torch.equal(getattr(cut, name), want), (op, name)
        assert torch.equal(cut.dinv, lv.dinv[box])
        for p in (0, 1):
            assert torch.equal(cut.kdinv[p], lv.kdinv[p][box])
        if op == "fv7pt":
            # K8d's ring views: a 1-cell ring along every axis, zeros
            # outside the domain
            kd0 = cut.ring[0]
            pad = torch.nn.functional.pad(lv.kdinv[0], (1, 1, 1, 1, 1, 1))
            assert torch.equal(kd0, pad[oi:oi + ni + 2, oj:oj + nj + 2, ok:ok + nk + 2])
            bk = torch.nn.functional.pad(lv.beta_k, (1, 1, 1, 1, 1, 1))
            assert torch.equal(cut.ring[4], bk[oi:oi + ni + 2, oj:oj + nj + 2, ok:ok + nk + 3])
    c = mesh.coords
    assert SK.edge_flags(part) == tuple(s for a in range(3) for s in (c[a] == 0, c[a] == 1))


def test_a_part_whole_along_k_keeps_the_ij_layout():
    """A split that keeps k whole is held as the pair (so Parts of one
    placement compare equal), counts and coords have three entries, and
    edge_flags names the four i/j sides."""
    mesh = Mesh((2, 2, 1), 3, "gloo", CPU)
    a, b = Part(mesh, (True, True), 32), Part(mesh, (True, True, False), 32)
    assert a == b and a.split == (True, True) and a.axes == (True, True, False)
    assert a.counts == (2, 2, 1) and a.coords == (1, 1, 0)
    assert a.extents == (16, 16, 32) and a.offsets == (16, 16, 0)
    assert SK.edge_flags(a) == (False, True, False, True)
