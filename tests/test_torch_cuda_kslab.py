"""The slab kernels on blocks split along k, on a card: K8a, K8b (both
passes), K8c and K8d with their two k slabs (csrc/fv4_slab.cu,
csrc/r1_var7_stream.cu, csrc/r1_gsrb2.cu, the KSLAB instantiations)
against their plain versions on the same CUDA tensors, with random slabs
and coefficients as a neighbour would send them: every mode, Poisson and
Helmholtz, every body, both BCs (K8d: Dirichlet), float32 and float64;
K8d with the block's k sides on a domain face or not, either side or both.
Bit for bit: a gsrb's other colour equals x, any chunk of i-planes equals
the launcher's rule, K8b's passes equal K8a; K8a with k slabs that hold
the periodic wrap equals the kernel that wraps k itself (K8c to rounding:
its two instantiations round the var7 sum apart), and K8d with both k
sides on domain faces equals K8d on the same block whole along k. max|kernel - plain| / max|plain| <= 1e-13 (fv4) or 1e-12 in float64,
2e-6 (fv4) or 1e-5 in float32, the tolerances of the k-whole card tests.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_kslab.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import stencils_r1 as K

pytestmark = pytest.mark.cuda
TOL_FV4 = {torch.float32: 2e-6, torch.float64: 1e-13}
TOL_R1 = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]
# thin, ragged (no multiple of the 16 x 32 column tile) and the 2x2x2
# grid's blocks; K8b's split takes the ones with >= 3 column tiles along
# j and k
FV4_BLOCKS = [(4, 4, 8), (8, 8, 16), (16, 48, 32), (24, 40, 48), (32, 48, 130),
              (64, 64, 128), (128, 128, 256)]
R1_BLOCKS = [(2, 2, 4), (4, 4, 8), (6, 10, 12), (8, 8, 16), (16, 48, 32), (34, 18, 36),
             (64, 64, 128)]
# (taps, var7, helmholtz): fv7pt, fv2, fv7pt with a*alpha*x, 27pt, 27pt
# with its constant a*x
BODIES = [("p1", True, False), ("v2", True, False), ("p1", True, True),
          ("27pt", False, False), ("27pt", False, True)]
# K8d's (i low, i high, j low, j high, k low, k high): k split below,
# above, on both sides, and an inner block (the k slab on a domain k face
# holds the 2-tap ghost, as the exchange builds it: _domain_k_slabs)
EDGES = [(True, False, True, False, False, True), (False, True, False, True, True, False),
         (True, True, False, False, False, False), (False,) * 6]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def relerr(out, ref) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _rand(rng, dtype, dev):
    def t(*shape, lo=None):
        a = rng.standard_normal(shape) if lo is None else lo + 0.25 * rng.random(shape)
        return torch.tensor(a, dtype=dtype, device=dev)
    return t


def _fv4_block(block, dtype, dev, rng):
    """K8a's operands on an ni x nj x nk block split along k: the faces
    with their margins, alpha, the global mask's kdinv pair, x, rhs and six
    random 2-deep slabs."""
    ni, nj, nk = block
    n = 2 * max(block)
    t = _rand(rng, dtype, dev)
    dinv = t(ni, nj, nk, lo=0.5) / (8.0 * n * n)
    mask = [rb_mask(n, p, dtype, dev)[:ni, :nj, :nk] for p in (0, 1)]
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=t(ni + 1, nj + 2, nk + 2, lo=1.0),
               beta_j=t(ni + 2, nj + 1, nk + 2, lo=1.0),
               beta_k=t(ni + 2, nj + 2, nk + 1, lo=1.0), alpha=t(ni, nj, nk, lo=0.0),
               dinv=dinv, kdinv=tuple(m * dinv for m in mask))
    slabs = (t(2, nj, nk), t(2, nj, nk), t(ni + 4, 2, nk), t(ni + 4, 2, nk),
             t(ni + 4, nj + 4, 2), t(ni + 4, nj + 4, 2))
    return lv, t(ni, nj, nk), t(ni, nj, nk), slabs


def _fv4_cases(lv, rhs):
    out = [("apply", {}, None), ("residual", {"rhs": rhs}, None)]
    return out + [("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}, p) for p in (0, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("block", FV4_BLOCKS)
def test_k8a_k8b_with_k_slabs_match_plain(dev, block, bc, dtype):
    rng = np.random.default_rng(sum(block) + 7 * (dtype == torch.float64))
    lv, x, rhs, slabs = _fv4_block(block, dtype, dev, rng)
    split = S.overlap_grid_shape(*block) is not None
    before = S.fv4_slab_cuda.kslab_launches, S.fv4_overlap_edge_cuda.kslab_launches
    calls = 0
    for cfg in (SolverConfig(a=0.0, b=1.0, dtype=dtype, bc=bc),
                SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype, bc=bc)):
        for mode, kw, parity in _fv4_cases(lv, rhs):
            out = S.fv4_slab_cuda(lv, x, slabs, cfg, mode, parity=parity, **kw)
            calls += 1
            ref = S.fv4_slab_plain(lv, x, slabs, cfg, mode, **kw)
            assert relerr(out, ref) <= TOL_FV4[dtype], (mode, parity)
            if mode == "gsrb":
                other = kw["kdinv"] == 0
                assert torch.equal(out[other], x[other]), parity
            for chunk in (2, 3):
                again = S.fv4_slab_cuda(lv, x, slabs, cfg, mode, parity=parity,
                                        chunk=chunk, **kw)
                calls += 1
                assert torch.equal(again, out), (mode, parity, chunk)
            if split:
                inner = S.fv4_overlap_interior_cuda(lv, x, cfg, mode, parity=parity,
                                                    ksplit=True, **kw)
                both = S.fv4_overlap_edge_cuda(lv, x, slabs, cfg, mode, inner,
                                               parity=parity, **kw)
                assert torch.equal(both, out), (mode, parity)
                pinner = S.fv4_overlap_interior_plain(lv, x, cfg, mode, ksplit=True, **kw)
                pboth = S.fv4_overlap_edge_plain(lv, x, slabs, cfg, mode, pinner, **kw)
                assert torch.equal(pboth, ref), (mode, parity)
    assert S.fv4_slab_cuda.kslab_launches == before[0] + calls
    assert S.fv4_overlap_edge_cuda.kslab_launches == before[1] + (8 if split else 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [(8, 8, 16), (64, 64, 128)])
def test_k8a_k_slabs_of_the_wrap_equal_the_wrapping_kernel(dev, block, dtype):
    """Periodic k slabs cut from the i/j-extended block itself: K8a reads
    the same values from them as it wraps without them, bit for bit."""
    rng = np.random.default_rng(11 + sum(block))
    lv, x, rhs, slabs = _fv4_block(block, dtype, dev, rng)
    xe = S.extend_slabs(x, slabs[:4])
    wrap = slabs[:4] + (xe[:, :, -2:].contiguous(), xe[:, :, :2].contiguous())
    cfg = SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype, bc=BC.PERIODIC)
    for mode, kw, parity in _fv4_cases(lv, rhs):
        assert torch.equal(S.fv4_slab_cuda(lv, x, wrap, cfg, mode, parity=parity, **kw),
                           S.fv4_slab_cuda(lv, x, slabs[:4], cfg, mode, parity=parity,
                                           **kw)), (mode, parity)


def _r1_block(block, dtype, dev, rng):
    """K8c's operands on a block split along k: natural faces, alpha, the
    kdinv pair, x, rhs and six random 1-deep slabs."""
    ni, nj, nk = block
    n = 2 * max(block)
    t = _rand(rng, dtype, dev)
    dinv = t(ni, nj, nk, lo=0.5) / (8.0 * n * n)
    mask = rb_mask(n, 0, dtype, dev)[:ni, :nj, :nk]
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=t(ni + 1, nj, nk, lo=1.0),
               beta_j=t(ni, nj + 1, nk, lo=1.0), beta_k=t(ni, nj, nk + 1, lo=1.0),
               alpha=t(ni, nj, nk, lo=0.5), dinv=dinv, kdinv=(mask * dinv, (1 - mask) * dinv))
    slabs = (t(1, nj, nk), t(1, nj, nk), t(ni + 2, 1, nk), t(ni + 2, 1, nk),
             t(ni + 2, nj + 2, 1), t(ni + 2, nj + 2, 1))
    return lv, t(ni, nj, nk), t(ni, nj, nk), slabs


def _r1_cfg(taps, helm, dtype, bc):
    return SolverConfig(op="27pt" if taps == "27pt" else "fv7pt", a=1.5 if helm else 0.0,
                        b=1.0, helmholtz=helm and taps != "27pt", dtype=dtype, bc=bc)


def _r1_cases(lv, rhs):
    out = [("apply", {}), ("residual", {"rhs": rhs}), ("fres", {"rhs": rhs})]
    return out + [("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p], "parity": p}) for p in (0, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("block", R1_BLOCKS)
def test_k8c_with_k_slabs_matches_plain(dev, block, bc, dtype):
    rng = np.random.default_rng(100 + sum(block))
    lv, x, rhs, slabs = _r1_block(block, dtype, dev, rng)
    before = K.r1_slab_cuda.kslab_launches
    calls = 0
    for taps, var7, helm in BODIES:
        cfg = _r1_cfg(taps, helm, dtype, bc)
        for mode, kw in _r1_cases(lv, rhs):
            out = K.r1_slab_cuda(lv, x, slabs, cfg, mode, taps, var7, **kw)
            calls += 1
            kw.pop("parity", None)
            ref = K.r1_slab_plain(lv, x, slabs, cfg, mode, taps, var7, **kw)
            assert relerr(out, ref) <= TOL_R1[dtype], (taps, helm, mode)
            if mode == "gsrb":
                other = kw["kdinv"] == 0
                assert torch.equal(out[other], x[other]), (taps, helm)
    assert K.r1_slab_cuda.kslab_launches == before + calls


@pytest.mark.parametrize("dtype", DTYPES)
def test_k8c_k_slabs_of_the_wrap_equal_the_wrapping_kernel(dev, dtype):
    """To rounding, not bit for bit: the k-slab instantiation of K8c rounds
    the var7 sum of a cell in another order than the wrapping one (an ulp
    at interior cells too, whatever the ghosts)."""
    rng = np.random.default_rng(12)
    lv, x, rhs, slabs = _r1_block((16, 48, 32), dtype, dev, rng)
    xe = S.extend_slabs(x, slabs[:4])
    wrap = slabs[:4] + (xe[:, :, -1:].contiguous(), xe[:, :, :1].contiguous())
    for taps, var7, helm in BODIES:
        cfg = _r1_cfg(taps, helm, dtype, BC.PERIODIC)
        for mode, kw in _r1_cases(lv, rhs):
            out = K.r1_slab_cuda(lv, x, wrap, cfg, mode, taps, var7, **kw)
            ref = K.r1_slab_cuda(lv, x, slabs[:4], cfg, mode, taps, var7, **kw)
            assert relerr(out, ref) <= TOL_R1[dtype], (taps, helm, mode)


def _k8d_block(block, dtype, dev, rng, helm, kring=True):
    """K8d's operands on a block split along k (``kring``: ring views and
    rhs ring with a 1-cell ring along k too): x, kdinv1, the ring views
    (kdinv0 folded to red, alpha, the faces), the rhs ring and six random
    2-deep slabs (four where the block is whole along k)."""
    ni, nj, nk = block
    t = _rand(rng, dtype, dev)
    n = 2 * max(block) + 2
    scale = 1.0 / (8.0 * n * n)
    kr = nk + 2 if kring else nk
    ring = (ni + 2, nj + 2, kr)
    # block offsets are even: a ring cell (I, J, K) is cell (I-1, J-1, K-1)
    # of the block (K without a k ring)
    red = rb_mask(n, 1 if kring else 0, dtype, dev)[:ni + 2, :nj + 2, :kr]
    black = 1 - rb_mask(n, 0, dtype, dev)[:ni, :nj, :nk]
    faces = (t(ni + 3, nj + 2, kr, lo=1.0), t(ni + 2, nj + 3, kr, lo=1.0),
             t(ni + 2, nj + 2, kr + 1, lo=1.0))
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=faces[0], beta_j=faces[1],
               beta_k=faces[2], kdinv=(None, black * scale * t(ni, nj, nk, lo=2.0)),
               ring=(red * scale * t(*ring, lo=2.0), t(*ring, lo=0.5) if helm else None,
                     *faces))
    slabs = (t(2, nj, nk), t(2, nj, nk), t(ni + 4, 2, nk), t(ni + 4, 2, nk))
    if kring:
        slabs += (t(ni + 4, nj + 4, 2), t(ni + 4, nj + 4, 2))
    return lv, t(ni, nj, nk), t(*ring), slabs


def _domain_k_slabs(x, slabs, edges, taps):
    """K8d's k slabs with those on a domain k face (``edges[4:]``) holding
    the 2-tap Dirichlet ghost twice, as the exchange builds them: K8d makes
    its k ghosts there, as on a block whole along k, and reads no k slab."""
    xe = S.extend_slabs(x, slabs[:4])
    ghost = K.taps_ghost2(taps)
    klo = ghost(xe[:, :, :2], 2, True).contiguous() if edges[4] else slabs[4]
    khi = ghost(xe[:, :, -2:], 2, False).contiguous() if edges[5] else slabs[5]
    return slabs[:4] + (klo, khi)


def _k8d_cfg(taps, helm, dtype):
    return SolverConfig(op="27pt" if taps == "27pt" else "fv7pt", a=1.5 if helm else 0.0,
                        b=1.0, helmholtz=helm and taps != "27pt", dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", R1_BLOCKS)
def test_k8d_with_k_slabs_matches_plain(dev, block, dtype):
    rng = np.random.default_rng(200 + sum(block))
    before = K.r1_gsrb2_slab_cuda.kslab_launches
    calls = 0
    for taps, var7, helm in BODIES:
        lv, x, rhs2, slabs = _k8d_block(block, dtype, dev, rng, helm)
        cfg = _k8d_cfg(taps, helm, dtype)
        for edges in EDGES:
            s6 = _domain_k_slabs(x, slabs, edges, taps)
            out = K.r1_gsrb2_slab_cuda(lv, x, s6, edges, rhs2, cfg, taps, var7)
            calls += 1
            ref = K.r1_gsrb2_slab_plain(lv, x, s6, edges, rhs2, cfg, taps, var7)
            assert relerr(out, ref) <= TOL_R1[dtype], (taps, helm, edges)
            for chunk in (2, 3):
                short = K.r1_gsrb2_slab_cuda(lv, x, s6, edges, rhs2, cfg, taps, var7,
                                             chunk=chunk)
                calls += 1
                assert torch.equal(short, out), (taps, helm, edges, chunk)
    assert K.r1_gsrb2_slab_cuda.kslab_launches == before + calls


@pytest.mark.parametrize("dtype", DTYPES)
def test_k8d_with_domain_k_faces_equals_the_k_whole_sweep(dev, dtype):
    """Both k sides on domain faces: K8d reads nothing of the k slabs or
    the k ring, and equals K8d on the block whole along k (the ring views
    without their k ring) bit for bit."""
    block = (16, 48, 32)
    for taps, var7, helm in BODIES:
        lv, x, rhs2, slabs = _k8d_block(block, dtype, dev, np.random.default_rng(5), helm)
        cfg = _k8d_cfg(taps, helm, dtype)
        edges = (True, False, False, True)
        out = K.r1_gsrb2_slab_cuda(lv, x, slabs, edges + (True, True), rhs2, cfg, taps, var7)
        whole = dataclasses.replace(lv, ring=tuple(
            None if r is None else r[:, :, 1:-1].contiguous() for r in lv.ring[:4])
            + (lv.ring[4][:, :, 1:-1].contiguous(),))
        ref = K.r1_gsrb2_slab_cuda(whole, x, slabs[:4], edges, rhs2[:, :, 1:-1].contiguous(),
                                   cfg, taps, var7)
        assert torch.equal(out, ref), (taps, helm)
