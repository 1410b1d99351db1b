"""K6 and K8d on a card: the fused radius-1 red+black sweep as one streaming
kernel (hpgmg_tpu_torch/kernels/csrc/r1_gsrb2.cu; ``stencils_r1.
r1_gsrb2_cuda`` on a whole Dirichlet level, ``r1_gsrb2_slab_cuda`` on one
rank's block with its 2-deep halo slabs and ring views) against their plain
versions ``r1_gsrb2_plain`` and ``r1_gsrb2_slab_plain`` on the same CUDA
tensors, max|kernel - plain| / max|plain| <= 1e-5 (f32: another order of
summation than the plain version) and 1e-12 (f64):

* K6 for the var7 body with the fv7pt (p1) and fv2 (v2) taps, with and
  without a*alpha*x, and for the 27pt body with and without its constant
  a*x, float32 and float64, at n in {2, 3, 4, 8, 9, 16, 33, 48, 64} (n = 2:
  every cell a boundary cell; odd n, whose last pair straddles k = n; sizes
  that are not a multiple of the 16 x 32 column tile); every chunk of
  i-planes (1, 2, 3, n) gives the launcher's result bit for bit;
* K8d on local blocks from (2, 2, 4) to (64, 64, 128), ragged and thin,
  with random slabs, ring views and rhs ring (as neighbours would send
  them), under every edge-flag pattern a 2 x 2 grid gives its ranks and
  with all four flags and none: against its plain version, chunks of 2
  and 3 i-planes equal to the launcher's rule bit for bit;
* a call is one launch on its wrapper's counter; the wrappers refuse a
  negative chunk.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_r1_sweep.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils_r1 as K

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# (taps, var7, helmholtz): fv7pt, fv2, fv7pt with a*alpha*x, 27pt, 27pt
# with its constant a*x
BODIES = [("p1", True, False), ("v2", True, False), ("p1", True, True),
          ("27pt", False, False), ("27pt", False, True)]
# (i low, i high, j low, j high) of the 2 x 2 grid's four ranks, all four
# domain faces (one block) and none (an inner block of a larger grid)
EDGES = [(True, False, True, False), (True, False, False, True),
         (False, True, True, False), (False, True, False, True),
         (True,) * 4, (False,) * 4]
BLOCKS = [(2, 2, 4), (4, 4, 8), (8, 8, 16), (16, 48, 32), (24, 40, 48), (64, 64, 128)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def relerr(out, ref) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _level(n, dtype, dev, rng):
    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    beta = [t(1.0 + 0.25 * rng.random(s)) for s in
            ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1))]
    dinv = t((0.5 + rng.random((n, n, n))) / (8.0 * n * n))
    return Level(dim=n, h=1.0 / n, depth=0, beta_i=beta[0], beta_j=beta[1],
                 beta_k=beta[2], alpha=t(rng.random((n, n, n))), dinv=dinv,
                 kdinv=tuple(rb_mask(n, p, dtype, dev) * dinv for p in (0, 1)))


def _cfg(taps, helm, dtype):
    return SolverConfig(op="27pt" if taps == "27pt" else "fv7pt",
                        a=1.5 if helm else 0.0, b=1.0, helmholtz=helm, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 3, 4, 8, 9, 16, 33, 48, 64])
def test_k6_matches_plain_and_chunks_equal(dev, n, dtype):
    rng = np.random.default_rng(500 + n)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    launches = K.r1_gsrb2_cuda.launches
    calls = 0
    for taps, var7, helm in BODIES:
        cfg = _cfg(taps, helm, dtype)
        out = K.r1_gsrb2(lv, x, rhs, cfg, taps, var7)
        calls += 1
        assert out.is_cuda and out.shape == x.shape
        assert relerr(out, K.r1_gsrb2_plain(lv, x, rhs, cfg, taps, var7)) <= TOL[dtype], (
            taps, var7, helm)
        for chunk in (1, 2, 3, n):
            short = K.r1_gsrb2_cuda(lv, x, rhs, cfg, taps, var7, chunk=chunk)
            calls += 1
            assert torch.equal(short, out), (taps, var7, helm, chunk)
    assert K.r1_gsrb2_cuda.launches == launches + calls


def _block(ni, nj, nk, dtype, dev, rng, helm):
    """A local block's operands as the main path hands them to K8d: x,
    kdinv1 on the block, the ring views (kdinv0 folded to red, alpha, the
    three faces), the rhs ring and the 2-deep slabs, all random."""
    def t(shape, lo=0.0, span=1.0):
        return torch.tensor(lo + span * rng.random(shape), dtype=dtype, device=dev)

    n = max(2 * ni, 2 * nj, nk)
    scale = 1.0 / (8.0 * n * n)
    ring = (ni + 2, nj + 2, nk)
    # block offsets are even, so the ring's parity is the block's, shifted
    red = rb_mask(n + 2, 0, dtype, dev)[:ni + 2, :nj + 2, :nk]
    black = 1 - rb_mask(n, 0, dtype, dev)[:ni, :nj, :nk]
    faces = (t((ni + 3, nj + 2, nk), 1.0, 0.25), t((ni + 2, nj + 3, nk), 1.0, 0.25),
             t((ni + 2, nj + 2, nk + 1), 1.0, 0.25))
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=faces[0], beta_j=faces[1],
               beta_k=faces[2], kdinv=(None, black * t((ni, nj, nk), 0.5 * scale, scale)),
               ring=(red * t(ring, 0.5 * scale, scale), t(ring) if helm else None, *faces))
    x = torch.tensor(rng.standard_normal((ni, nj, nk)), dtype=dtype, device=dev)
    rhs2 = torch.tensor(rng.standard_normal(ring), dtype=dtype, device=dev)
    slabs = tuple(torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                  for s in ((2, nj, nk),) * 2 + ((ni + 4, 2, nk),) * 2)
    return lv, x, rhs2, slabs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("block", BLOCKS)
def test_k8d_blocks_match_plain_and_chunks_equal(dev, block, dtype):
    ni, nj, nk = block
    rng = np.random.default_rng(ni * 1000 + nj + nk)
    launches = K.r1_gsrb2_slab_cuda.launches
    calls = 0
    for taps, var7, helm in BODIES:
        lv, x, rhs2, slabs = _block(ni, nj, nk, dtype, dev, rng, helm)
        cfg = _cfg(taps, helm, dtype)
        for edges in EDGES:
            out = K.r1_gsrb2_slab(lv, x, slabs, edges, rhs2, cfg, taps, var7)
            calls += 1
            ref = K.r1_gsrb2_slab_plain(lv, x, slabs, edges, rhs2, cfg, taps, var7)
            assert relerr(out, ref) <= TOL[dtype], (taps, var7, helm, edges)
            for chunk in (2, 3):
                short = K.r1_gsrb2_slab_cuda(lv, x, slabs, edges, rhs2, cfg, taps, var7,
                                             chunk=chunk)
                calls += 1
                assert torch.equal(short, out), (taps, var7, helm, edges, chunk)
    assert K.r1_gsrb2_slab_cuda.launches == launches + calls


def test_k6_on_one_block_matches_k8d(dev):
    """K8d on one whole-domain block (every edge flag, the Dirichlet slabs)
    against K6 on the same level."""
    n, dtype = 48, torch.float64
    rng = np.random.default_rng(48)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    for taps, var7, helm in BODIES:
        cfg = _cfg(taps, helm, dtype)
        one = K.r1_gsrb2_one_block(lv, x, rhs, cfg, taps, var7)
        assert relerr(one, K.r1_gsrb2_cuda(lv, x, rhs, cfg, taps, var7)) <= TOL[dtype]


def test_sweep_wrappers_refuse_a_negative_chunk(dev):
    rng = np.random.default_rng(3)
    lv = _level(8, torch.float32, dev, rng)
    x = torch.zeros((8, 8, 8), device=dev)
    cfg = _cfg("p1", False, torch.float32)
    with pytest.raises(ValueError, match="chunk"):
        K.r1_gsrb2_cuda(lv, x, x, cfg, "p1", True, chunk=-1)
    lv2 = dataclasses.replace(lv, ring=K.ring_views(lv, cfg, True))
    with pytest.raises(ValueError, match="chunk"):
        K.r1_gsrb2_slab_cuda(lv2, x, K.single_chip_slabs2_r1(x, "p1"), (True,) * 4,
                             K.ring_cut(x, 0, 0, 8, 8), cfg, "p1", True, chunk=-1)
