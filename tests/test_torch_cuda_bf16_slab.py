"""The slab kernels' bfloat16 instantiations on a card: K8a, K8b (both
passes), K8c (var7 and 27pt bodies) and K8d (csrc/fv4_slab.cuh through
csrc/fv4_slab_bf16.cu, csrc/r1_var7_stream.cu, csrc/r1_gsrb2.cu: the bf16
entries) against their
plain versions on the same CUDA tensors: random bf16 fields and
coefficients, random float32 slabs (a bf16 block's slabs are float32: a
neighbour's cells widened, a domain face's ghosts unrounded; these hold
values no bf16 holds, so a kernel that rounded them would show), blocks
whole along k (four
slabs) and split along k (six: the KSLAB instantiations), Dirichlet and
periodic (K8d: Dirichlet, each 2x2 rank's edge flags and a k-split
block's). Each cell within one bf16 unit in the last place of the plain
version's (the same float32 arithmetic on widened operands, one rounding;
where the two float32 sums differ in order the rounding may land one unit
apart, and at a cell that cancels far below max|out| the unit is 1e-5
max|out|); K8d within half a unit of max|out| (its red half rounded to
bf16 before black reads it, as K6 is held; its red plane holds the black
cells' x rounded too, as a stored red iterate does, which the float32
slab cells make visible). Bit for bit: a gsrb's other
colour equals x, K8b's two passes equal K8a, chunks of i-planes equal
the launcher's rule. Every launch counts in the wrappers'
``bf16_launches`` (``kslab_bf16_launches`` with six slabs) and none in
``launches``.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_bf16_slab.py -q
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
BF16 = torch.bfloat16
# thin, ragged, the 2x2 grid's and the (2,2,2) grid's blocks; K8b's split
# takes those with >= 3 column tiles of 16 along j (of 32 along a split k)
BLOCKS = [(4, 4, 8), (16, 48, 32), (34, 34, 68), (64, 64, 128)]
KSPLIT_BLOCKS = [(8, 8, 16), (32, 48, 130), (64, 64, 64)]
# (taps, var7, helmholtz): fv7pt, fv2, fv7pt with a*alpha*x, 27pt, 27pt
# with its constant a*x
BODIES = [("p1", True, False), ("v2", True, False), ("p1", True, True),
          ("27pt", False, False), ("27pt", False, True)]
# K8d's edge flags: each rank of the 2x2 grid; a k-split block below and
# above a domain k face and an inner one
EDGES4 = [(True, False, True, False), (True, False, False, True),
          (False, True, True, False), (False, True, False, True)]
EDGES6 = [(True, False, True, False, False, True), (False, True, False, True, True, False),
          (False,) * 6]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def ulps(out, ref) -> float:
    """max over cells of |out - ref| in bf16 units in the last place of
    ref, a unit being at least 1e-5 max|ref|."""
    r = ref.float()
    unit = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126))) - 7)
    unit = unit.clamp_min(1e-5 * float(r.abs().max()))
    return float(((out.float() - r).abs() / unit).max())


def max_ulps(out, ref) -> float:
    """max|out - ref| in bf16 units in the last place of max|ref|."""
    top = ref.float().abs().max()
    return float((out.float() - ref.float()).abs().max()
                 / torch.exp2(torch.floor(torch.log2(top)) - 7))


def _rand(rng, dev):
    def t(*shape, lo=None):
        a = rng.standard_normal(shape) if lo is None else lo + 0.25 * rng.random(shape)
        return torch.tensor(a, dtype=torch.float32, device=dev).to(BF16)
    return t


def _slabs(rng, dev, *shapes):
    """Random float32 slabs of ``shapes`` (full float32 precision)."""
    return tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)
                 for s in shapes)


def _level(block, dev, rng, r1: bool):
    """A bf16 level cut to the block: the fv4 faces with their margins (or
    the natural radius-1 faces), alpha and the global mask's kdinv pair;
    and the maker of random bf16 tensors."""
    ni, nj, nk = block
    n = 2 * max(block)
    t = _rand(rng, dev)
    faces = (((ni + 1, nj, nk), (ni, nj + 1, nk), (ni, nj, nk + 1)) if r1 else
             ((ni + 1, nj + 2, nk + 2), (ni + 2, nj + 1, nk + 2), (ni + 2, nj + 2, nk + 1)))
    dinv = (t(ni, nj, nk, lo=0.5).float() / (8.0 * n * n)).to(BF16)
    mask = [rb_mask(n, p, BF16, dev)[:ni, :nj, :nk] for p in (0, 1)]
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=t(*faces[0], lo=1.0),
               beta_j=t(*faces[1], lo=1.0), beta_k=t(*faces[2], lo=1.0),
               alpha=t(ni, nj, nk, lo=0.0), dinv=dinv, kdinv=tuple(m * dinv for m in mask))
    return lv, t


def _ring(lv, block, dev, t, kring: bool):
    """K8d's random ring views of the block (kdinv0 on red cells only), with
    a k ring on a block split along k (ring cell (I, J, K) is block cell
    (I-1, J-1, K-1), or (I-1, J-1, K) without a k ring: block offsets are
    even, so the red cells are the mask of parity 1, or 0)."""
    ni, nj, nk = block
    kr = nk + 2 if kring else nk
    rmask = rb_mask(lv.dim, 1 if kring else 0, BF16, dev)[:ni + 2, :nj + 2, :kr]
    kd0 = rmask * (t(ni + 2, nj + 2, kr, lo=0.5).float() / (8.0 * lv.dim ** 2)).to(BF16)
    return (kd0, t(ni + 2, nj + 2, kr, lo=0.0), t(ni + 3, nj + 2, kr, lo=1.0),
            t(ni + 2, nj + 3, kr, lo=1.0), t(ni + 2, nj + 2, kr + 1, lo=1.0))


def _counts(fns):
    return [(f.launches, f.kslab_launches, f.bf16_launches, f.kslab_bf16_launches)
            for f in fns]


@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("block, six", [(b, False) for b in BLOCKS]
                         + [(b, True) for b in KSPLIT_BLOCKS])
def test_k8a_k8b_bf16_match_plain(dev, block, six, bc):
    rng = np.random.default_rng(sum(block) + 3 * six)
    lv, t = _level(block, dev, rng, r1=False)
    ni, nj, nk = block
    x, rhs = t(ni, nj, nk), t(ni, nj, nk)
    slabs = _slabs(rng, dev, (2, nj, nk), (2, nj, nk), (ni + 4, 2, nk), (ni + 4, 2, nk),
                   *[(ni + 4, nj + 4, 2)] * (2 * six))
    split = S.overlap_grid_shape(ni, nj, nk if six else None) is not None
    fns = (S.fv4_slab_cuda, S.fv4_overlap_interior_cuda, S.fv4_overlap_edge_cuda)
    before = _counts(fns)
    calls = 0
    for cfg in (SolverConfig(a=0.0, b=1.0, dtype=BF16, bc=bc),
                SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=BF16, bc=bc)):
        for mode, kw, p in [("apply", {}, None), ("residual", {"rhs": rhs}, None)] + [
                ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[q]}, q) for q in (0, 1)]:
            out = S.fv4_slab_cuda(lv, x, slabs, cfg, mode, parity=p, **kw)
            calls += 1
            assert out.dtype == BF16
            assert ulps(out, S.fv4_slab_plain(lv, x, slabs, cfg, mode, **kw)) <= 1.0, (mode, p)
            if mode == "gsrb":
                other = kw["kdinv"] == 0
                assert torch.equal(out[other], x[other])
            assert torch.equal(S.fv4_slab_cuda(lv, x, slabs, cfg, mode, parity=p, chunk=3,
                                               **kw), out)
            calls += 1
            if split:
                inner = S.fv4_overlap_interior_cuda(lv, x, cfg, mode, parity=p, ksplit=six,
                                                    **kw)
                assert torch.equal(S.fv4_overlap_edge_cuda(lv, x, slabs, cfg, mode, inner,
                                                           parity=p, **kw), out), mode
    after = _counts(fns)
    assert after[0] == (before[0][0], before[0][1], before[0][2] + calls,
                        before[0][3] + calls * six)
    for b, a in zip(before[1:], after[1:]):
        assert a[:2] == b[:2] and a[2] - b[2] == (8 if split else 0)


@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("block, six", [(b, False) for b in BLOCKS]
                         + [(b, True) for b in KSPLIT_BLOCKS])
def test_k8c_bf16_matches_plain(dev, block, six, bc):
    rng = np.random.default_rng(sum(block) + 5 + 3 * six)
    lv, t = _level(block, dev, rng, r1=True)
    ni, nj, nk = block
    x, rhs = t(ni, nj, nk), t(ni, nj, nk)
    slabs = _slabs(rng, dev, (1, nj, nk), (1, nj, nk), (ni + 2, 1, nk), (ni + 2, 1, nk),
                   *[(ni + 2, nj + 2, 1)] * (2 * six))
    before = _counts([K.r1_slab_cuda])[0]
    calls = 0
    for taps, var7, helm in BODIES:
        cfg = SolverConfig(a=1.5 if helm else 0.0, b=1.0, helmholtz=helm, dtype=BF16, bc=bc)
        for mode, kw, p in ([("apply", {}, None), ("residual", {"rhs": rhs}, None)]
                            + [("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[q]}, q) for q in (0, 1)]
                            + [("fres", {"rhs": rhs}, None)]):
            out = K.r1_slab_cuda(lv, x, slabs, cfg, mode, taps, var7, parity=p, **kw)
            ref = K.r1_slab_plain(lv, x, slabs, cfg, mode, taps, var7, **kw)
            assert out.dtype == BF16 and ulps(out, ref) <= 1.0, (taps, var7, helm, mode, p)
            if mode == "gsrb":
                other = kw["kdinv"] == 0
                assert torch.equal(out[other], x[other])
            assert torch.equal(K.r1_slab_cuda(lv, x, slabs, cfg, mode, taps, var7, parity=p,
                                              chunk=3, **kw), out)
            calls += 2
    assert _counts([K.r1_slab_cuda])[0] == (before[0], before[1], before[2] + calls,
                                            before[3] + calls * six)


@pytest.mark.parametrize("block, six", [(b, False) for b in BLOCKS]
                         + [(b, True) for b in KSPLIT_BLOCKS])
def test_k8d_bf16_matches_plain(dev, block, six):
    rng = np.random.default_rng(sum(block) + 11 + 3 * six)
    lv, t = _level(block, dev, rng, r1=True)
    ni, nj, nk = block
    lv = dataclasses.replace(lv, ring=_ring(lv, block, dev, t, six))
    x = t(ni, nj, nk)
    rhs2 = t(ni + 2, nj + 2, nk + 2 if six else nk)
    slabs = _slabs(rng, dev, (2, nj, nk), (2, nj, nk), (ni + 4, 2, nk), (ni + 4, 2, nk),
                   *[(ni + 4, nj + 4, 2)] * (2 * six))
    before = _counts([K.r1_gsrb2_slab_cuda])[0]
    calls = 0
    for taps, var7, helm in BODIES:
        cfg = SolverConfig(a=1.5 if helm else 0.0, b=1.0, helmholtz=helm, dtype=BF16)
        for edges in EDGES6 if six else EDGES4:
            out = K.r1_gsrb2_slab_cuda(lv, x, slabs, edges, rhs2, cfg, taps, var7)
            ref = K.r1_gsrb2_slab_plain(lv, x, slabs, edges, rhs2, cfg, taps, var7)
            assert out.dtype == BF16 and max_ulps(out, ref) <= 0.5, (taps, var7, helm, edges)
            for chunk in (2, 3):
                assert torch.equal(K.r1_gsrb2_slab_cuda(lv, x, slabs, edges, rhs2, cfg, taps,
                                                        var7, chunk=chunk), out)
            calls += 3
    assert _counts([K.r1_gsrb2_slab_cuda])[0] == (before[0], before[1], before[2] + calls,
                                                  before[3] + calls * six)
