"""The CPU side of K8a/K8b's streaming kernel (csrc/fv4_slab.cu): what the
kernel relies on and what its plain versions must keep.

* ``FV4.gsrb_sweep`` on a decomposed level hands the sweep's parity down
  to the slab path (K8a, and K8b's two passes under ``OVERLAP``): the
  kernel computes a half-sweep at that colour's cells only;
* on every block of the 2x2 grid at 16^3-64^3 the cut of the global
  red/black mask equals the block's local mask of the same parity (block
  offsets are even), and so does the block's cut of the level's kdinv;
* K8b's plain interior pass, then its plain edge pass, equal K8a's plain
  version bit for bit under the kernel's split (interior: column tiles
  1 .. ntj-2 in j, i-planes 2 .. ni-3), on ragged blocks, both BCs,
  Poisson and Helmholtz, float64 and float32;
* ``overlap_grid_shape`` refuses the blocks the split cannot take.

The kernel itself runs only on a card (tests/test_torch_cuda_slab.py,
chip_smoke.py).
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.ops.fv4 import FV4
from hpgmg_tpu_torch.parallel import shard_kernels
from hpgmg_tpu_torch.parallel.mesh import Mesh, Part, level_part

CPU = torch.device("cpu")


def _block_level(ni, nj, nk, dtype, rng, n=None):
    """A level of random coefficients on an ni x nj x nk block (the
    tangentially-extended fv4 faces with their margins), with alpha and
    the kdinv pair of the global mask cut at offset 0."""
    def t(a):
        return torch.tensor(a, dtype=dtype)

    n = n or max(ni, nj, nk)
    dinv = t((0.5 + rng.random((ni, nj, nk))) / (8.0 * n * n))
    mask = [rb_mask(n, p, dtype, CPU)[:ni, :nj, :nk] for p in (0, 1)]
    return Level(dim=n, h=1.0 / n, depth=0,
                 beta_i=t(1.0 + 0.25 * rng.random((ni + 1, nj + 2, nk + 2))),
                 beta_j=t(1.0 + 0.25 * rng.random((ni + 2, nj + 1, nk + 2))),
                 beta_k=t(1.0 + 0.25 * rng.random((ni + 2, nj + 2, nk + 1))),
                 alpha=t(rng.random((ni, nj, nk))), dinv=dinv,
                 kdinv=tuple(m * dinv for m in mask))


def _one_block_part(n: int) -> Part:
    """A decomposed level's Part on a 1 x 1 grid: the block is the whole
    domain and the exchange is the local wrap or the BC fill (no process
    group)."""
    return Part(Mesh((1, 1, 1), 0, "gloo", CPU), (False, False), n)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
def test_gsrb_sweep_hands_its_parity_to_the_slab_path(monkeypatch, bc, overlap):
    n = 48  # 3 column tiles along j: K8b's split takes the block
    rng = np.random.default_rng(11)
    lv = dataclasses.replace(_block_level(n, n, n, torch.float64, rng),
                             part=_one_block_part(n))
    x, rhs = (torch.tensor(a) for a in rng.standard_normal((2, n, n, n)))
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64, bc=bc)
    seen = []

    def record(name):
        orig = getattr(S, name)

        def wrapped(*args, **kw):
            bound = inspect.signature(orig).bind(*args, **kw)
            seen.append((name, bound.arguments.get("parity")))
            return orig(*args, **kw)
        return wrapped

    names = ("fv4_overlap_interior", "fv4_overlap_edge") if overlap else ("fv4_slab",)
    for name in names:
        monkeypatch.setattr(S, name, record(name))
    monkeypatch.setattr(shard_kernels, "OVERLAP", overlap)
    for p in (0, 1, 2, 3):
        seen.clear()
        out = FV4().gsrb_sweep(lv, x, rhs, cfg, p)
        assert seen == [(name, p & 1) for name in names], p
        slabs = S.single_chip_slabs(x, bc)
        ref = S.fv4_slab_plain(lv, x, slabs, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[p & 1])
        assert torch.equal(out, ref), p
        # the other colour keeps x
        other = rb_mask(n, 1 - (p & 1), torch.float64, CPU).bool()
        assert torch.equal(out[other], x[other])


@pytest.mark.parametrize("n", [16, 32, 64])
def test_global_mask_cut_is_the_blocks_local_mask(n):
    """On every rank of the 2x2 grid, the block's cut of the global
    red/black mask is the local rule (i + j + k) % 2 == parity, the rule
    the kernel applies to local indices."""
    for rank in range(4):
        part = level_part(Mesh((2, 2, 1), rank, "gloo", CPU), n)
        assert part is not None and part.ni == n // 2 and part.nj == n // 2
        assert part.oi % 2 == 0 and part.oj % 2 == 0
        ni, nj = part.ni, part.nj
        i = torch.arange(ni).view(ni, 1, 1)
        j = torch.arange(nj).view(1, nj, 1)
        k = torch.arange(n).view(1, 1, n)
        for p in (0, 1):
            local = (((i + j + k) & 1) == p).to(torch.float64)
            glob = rb_mask(n, p, torch.float64, CPU)
            assert torch.equal(part.block(glob), local), (rank, p)
            dinv = torch.rand((n, n, n), dtype=torch.float64) + 0.5
            kd = part.block(glob * dinv)
            assert torch.equal(kd != 0, local.bool()), (rank, p)


BLOCKS = [(16, 48, 32), (24, 40, 48), (32, 64, 64)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("helmholtz", [False, True])
@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("block", BLOCKS)
def test_k8b_plain_split_equals_k8a_plain(block, bc, helmholtz, dtype):
    ni, nj, nk = block
    rng = np.random.default_rng(sum(block))
    lv = _block_level(ni, nj, nk, dtype, rng, n=2 * max(ni, nj))
    kw = dict(a=1.5, helmholtz=True) if helmholtz else dict(a=0.0)
    cfg = SolverConfig(op="fv4", b=1.0, dtype=dtype, bc=bc, **kw)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype)

    x, rhs = t(ni, nj, nk), t(ni, nj, nk)
    # slabs as a neighbour would send them: any values
    slabs = (t(2, nj, nk), t(2, nj, nk), t(ni + 4, 2, nk), t(ni + 4, 2, nk))
    i0, i1, j0, j1 = S._interior_region(x)
    assert (i0, i1, j0) == (2, ni - 2, S.SLAB_TJ)
    assert j1 == (-(-nj // S.SLAB_TJ) - 1) * S.SLAB_TJ and nj - j1 >= 2
    for mode, mkw in (("apply", {}), ("residual", {"rhs": rhs}),
                      ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[1]})):
        interior = S.fv4_overlap_interior(lv, x, cfg, mode, parity=1, **mkw)
        outside = torch.ones_like(x, dtype=torch.bool)
        outside[i0:i1, j0:j1] = False
        assert interior[outside].abs().max() == 0.0, mode
        out = S.fv4_overlap_edge(lv, x, slabs, cfg, mode, interior, parity=1, **mkw)
        ref = S.fv4_slab(lv, x, slabs, cfg, mode, parity=1, **mkw)
        assert torch.equal(out, ref), mode
        assert torch.equal(S.fv4_overlap(lv, x, slabs, cfg, mode, parity=1, **mkw), ref)


def test_overlap_grid_shape_refuses_what_the_split_cannot_take():
    tj = S.SLAB_TJ
    assert S.overlap_grid_shape(6, 2 * tj + 2) == (6, 3)
    assert S.overlap_grid_shape(256, 256) == (256, 256 // tj)
    assert S.overlap_grid_shape(16, 48) == (16, 3)
    for ni, nj in ((4, 64), (64, 2 * tj), (64, 16), (8, 8), (2, 48)):
        assert S.overlap_grid_shape(ni, nj) is None, (ni, nj)
    rng = np.random.default_rng(5)
    lv = _block_level(4, 64, 16, torch.float64, rng)
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="column tiles"):
        S.fv4_overlap_interior(lv, torch.zeros((4, 64, 16), dtype=torch.float64), cfg,
                               "apply")
    # K8a takes what K8b refuses, but no odd extent
    x = torch.zeros((4, 64, 16), dtype=torch.float64)
    assert S.fv4_slab(lv, x, S.single_chip_slabs(x, BC.DIRICHLET), cfg,
                      "apply").shape == x.shape
    with pytest.raises(ValueError, match="even"):
        lv7 = _block_level(4, 8, 7, torch.float64, rng)
        x7 = torch.zeros((4, 8, 7), dtype=torch.float64)
        S.fv4_slab(lv7, x7, S.single_chip_slabs(x7, BC.DIRICHLET), cfg, "apply")
