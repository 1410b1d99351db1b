"""The slab kernels of the port's decomposed path on a card: K8a, K8b
(both passes), K8c and K8d on one whole-domain block against their plain
versions on the same CUDA tensors (K8b against K8a bit for bit), K8a also
against K1/K7a there; K8a (csrc/fv4_slab.cu, the streaming kernel) on
ragged and thin local blocks with random slabs, every mode, both BCs,
Poisson and Helmholtz, both dtypes, against its plain version, its gsrb
leaving the other colour equal to x bit for bit, any chunk of i-planes
and K8b's two passes equal to it bit for bit; K3 on a non-cubic local
block, and a 2-rank decomposed F-cycle through the kernels (two processes
sharing the card over gloo) against the one-rank F-cycle.
max|kernel - plain| / max|plain| <= 1e-13 in float64, 2e-6 in float32
(the kernels build their k ghosts in another rounding order than the
plain versions' separable fills).

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_slab.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import restrict as R
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import stencils_r1 as K

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-6, torch.float64: 1e-13}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def relerr(out, ref) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _levels(n, dtype, dev, rng):
    """An fv4 level (tangentially-extended faces) and a radius-1 level
    (natural faces) of random coefficients, with alpha and kdinv."""
    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    dinv = t((0.5 + rng.random((n, n, n))) / (8.0 * n * n))
    kw = dict(dim=n, h=1.0 / n, depth=0, alpha=t(rng.random((n, n, n))), dinv=dinv,
              kdinv=tuple(rb_mask(n, p, dtype, dev) * dinv for p in (0, 1)))
    fv4 = [t(1.0 + 0.25 * rng.random(s)) for s in
           ((n + 1, n + 2, n + 2), (n + 2, n + 1, n + 2), (n + 2, n + 2, n + 1))]
    r1 = [t(1.0 + 0.25 * rng.random(s)) for s in
          ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1))]
    return (Level(beta_i=fv4[0], beta_j=fv4[1], beta_k=fv4[2], **kw),
            Level(beta_i=r1[0], beta_j=r1[1], beta_k=r1[2], **kw))


@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [8, 48])
def test_k8a_k8b_match_plain(dev, n, dtype, bc):
    rng = np.random.default_rng(n)
    lv, _ = _levels(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev) for a in rng.standard_normal((2, n, n, n)))
    slabs = S.single_chip_slabs(x, bc)
    launches = S.fv4_slab_cuda.launches
    for cfg in (SolverConfig(a=0.0, b=1.0, dtype=dtype, bc=bc),
                SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype, bc=bc)):
        for mode, kw in (("apply", {}), ("residual", {"rhs": rhs}),
                         ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[1]})):
            out = S.fv4_slab(lv, x, slabs, cfg, mode, parity=1, **kw)
            assert relerr(out, S.fv4_slab_plain(lv, x, slabs, cfg, mode, **kw)) <= TOL[dtype]
            if S.overlap_grid_shape(n, n) is not None:
                assert torch.equal(S.fv4_overlap(lv, x, slabs, cfg, mode, parity=1, **kw),
                                   out)
    assert S.fv4_slab_cuda.launches == launches + 6


# local blocks: thin ones (a column tile wider than the block), ragged ones
# (extents no multiple of the 16 x 32 column tile), the 2x2 grid's
BLOCKS = [(4, 4, 8), (8, 8, 16), (16, 48, 32), (24, 40, 48), (64, 64, 128),
          (128, 128, 256)]


def _block(block, dtype, dev, rng):
    """A level cut to an ni x nj x nk block (random faces with their
    margins, alpha, the global mask's kdinv pair), x, rhs and four random
    slabs, as a neighbour would send them."""
    ni, nj, nk = block
    n = 2 * max(ni, nj)

    def t(*shape, lo=None):
        a = rng.standard_normal(shape) if lo is None else lo + 0.25 * rng.random(shape)
        return torch.tensor(a, dtype=dtype, device=dev)

    dinv = t(ni, nj, nk, lo=0.5) / (8.0 * n * n)
    mask = [rb_mask(n, p, dtype, dev)[:ni, :nj, :nk] for p in (0, 1)]
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=t(ni + 1, nj + 2, nk + 2, lo=1.0),
               beta_j=t(ni + 2, nj + 1, nk + 2, lo=1.0),
               beta_k=t(ni + 2, nj + 2, nk + 1, lo=1.0), alpha=t(ni, nj, nk, lo=0.0),
               dinv=dinv, kdinv=tuple(m * dinv for m in mask))
    slabs = (t(2, nj, nk), t(2, nj, nk), t(ni + 4, 2, nk), t(ni + 4, 2, nk))
    return lv, t(ni, nj, nk), t(ni, nj, nk), slabs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("block", BLOCKS)
def test_k8a_blocks_match_plain(dev, block, bc, dtype):
    """Every mode, Poisson and Helmholtz, against the plain version; a
    gsrb's other colour equals x bit for bit; K8b's passes equal K8a bit for
    bit where its split applies; chunks of 2, 3 and 5 i-planes equal the
    launcher's rule bit for bit; one launch a call."""
    rng = np.random.default_rng(sum(block) + (dtype == torch.float64))
    lv, x, rhs, slabs = _block(block, dtype, dev, rng)
    ni, nj, nk = block
    split = S.overlap_grid_shape(ni, nj) is not None
    for cfg in (SolverConfig(a=0.0, b=1.0, dtype=dtype, bc=bc),
                SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype, bc=bc)):
        cases = [("apply", {}, None), ("residual", {"rhs": rhs}, None)]
        cases += [("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}, p) for p in (0, 1)]
        for mode, kw, parity in cases:
            launches = S.fv4_slab_cuda.launches
            out = S.fv4_slab_cuda(lv, x, slabs, cfg, mode, parity=parity, **kw)
            assert S.fv4_slab_cuda.launches == launches + 1
            ref = S.fv4_slab_plain(lv, x, slabs, cfg, mode, **kw)
            assert relerr(out, ref) <= TOL[dtype], (mode, parity)
            if mode == "gsrb":
                other = kw["kdinv"] == 0
                assert torch.equal(out[other], x[other]), parity
            for chunk in (2, 3, 5):
                again = S.fv4_slab_cuda(lv, x, slabs, cfg, mode, parity=parity,
                                        chunk=chunk, **kw)
                assert torch.equal(again, out), (mode, parity, chunk)
            if split:
                inner = S.fv4_overlap_interior_cuda(lv, x, cfg, mode, parity=parity, **kw)
                pair = S.fv4_overlap_edge_cuda(lv, x, slabs, cfg, mode, inner,
                                               parity=parity, **kw)
                assert torch.equal(pair, out), (mode, parity)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("n", [8, 24, 64])
def test_k8a_on_one_block_matches_k1(dev, n, bc, dtype):
    """K8a on a block that is the whole domain (single_chip_slabs) against
    K1 (K7a) on the same level: its k ghosts round otherwise, so within
    K1S_TOL (2e-6 f32, 1e-13 f64)."""
    rng = np.random.default_rng(n)
    lv, _ = _levels(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev) for a in rng.standard_normal((2, n, n, n)))
    slabs = S.single_chip_slabs(x, bc)
    cfg = SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype, bc=bc)
    for mode, kw, parity in (("apply", {}, None), ("residual", {"rhs": rhs}, None),
                             ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}, 0)):
        out = S.fv4_slab_cuda(lv, x, slabs, cfg, mode, parity=parity, **kw)
        ref = S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity, **kw)
        assert relerr(out, ref) <= TOL[dtype], mode


def test_k8a_refuses_a_gsrb_without_parity_and_odd_slabs(dev):
    lv, x, rhs, slabs = _block((8, 8, 16), torch.float32, dev, np.random.default_rng(0))
    cfg = SolverConfig(a=0.0, b=1.0, dtype=torch.float32)
    with pytest.raises(ValueError, match="parity"):
        S.fv4_slab_cuda(lv, x, slabs, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[0])
    strided = torch.empty((2, 8, 32), dtype=torch.float32, device=dev)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        S.fv4_slab_cuda(lv, x, (strided,) + slabs[1:], cfg, "apply")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("taps,var7", [("p1", True), ("v2", True), ("27pt", False)])
def test_k8c_k8d_match_plain(dev, taps, var7, dtype):
    n = 32
    rng = np.random.default_rng(7)
    _, lv = _levels(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev) for a in rng.standard_normal((2, n, n, n)))
    for bc in (BC.DIRICHLET, BC.PERIODIC):
        cfg = SolverConfig(a=0.0 if var7 else 1.5, b=1.0, dtype=dtype, bc=bc)
        slabs = K.single_chip_slabs_r1(x, bc, taps)
        for mode, kw, par in (("apply", {}, {}), ("residual", {"rhs": rhs}, {}),
                              ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}, {"parity": 0}),
                              ("fres", {"rhs": rhs}, {})):
            out = K.r1_slab(lv, x, slabs, cfg, mode, taps, var7, **kw, **par)
            ref = K.r1_slab_plain(lv, x, slabs, cfg, mode, taps, var7, **kw)
            assert relerr(out, ref) <= TOL[dtype], (bc, mode)
    cfg = SolverConfig(a=0.0 if var7 else 1.5, b=1.0, dtype=dtype)
    lv2 = dataclasses.replace(lv, ring=K.ring_views(lv, cfg, var7))
    s2, r2 = K.single_chip_slabs2_r1(x, taps), K.ring_cut(rhs, 0, 0, n, n)
    out = K.r1_gsrb2_slab(lv2, x, s2, (True,) * 4, r2, cfg, taps, var7)
    assert relerr(out, K.r1_gsrb2_slab_plain(lv2, x, s2, (True,) * 4, r2, cfg, taps,
                                             var7)) <= TOL[dtype]
    assert relerr(out, K.r1_gsrb2_cuda(lv, x, rhs, cfg, taps, var7)) <= TOL[dtype]


def test_k3_on_a_local_block(dev):
    x = torch.randn((16, 8, 64), dtype=torch.float64, device=dev)
    out = R.restrict_cell(x)
    assert out.shape == (8, 4, 32)
    assert relerr(out, R.restrict_cell_plain(x)) <= 1e-15


def test_decomposed_fcycle_on_the_card_equals_one_rank(dev):
    """Two ranks (the 2x1 grid) sharing the card over gloo, 64^3 f64 fv4:
    the slab kernels launch, and u equals the one-rank F-cycle's."""
    from hpgmg_tpu_torch.bench.weak import run_weak

    r = run_weak(32, 2, "fv4", "float64", backend="gloo", dynamic_range=1,
                 check_serial=True, timeout=300.0)
    assert r["grid"] == [2, 1, 1]
    assert r["launches"]["fv4_slab"] > 0 and r["launches"]["fv4_stencil"] == 0
    assert r["serial_u_rel_diff"] <= 1e-9
