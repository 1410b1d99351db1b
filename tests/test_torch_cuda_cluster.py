"""The two thread-block-cluster kernels on a card, on the same CUDA tensors
as their plain versions:

* K2c, the full fv4 red+black GSRB sweep in one launch of clusters
  (hpgmg_tpu_torch/kernels/csrc/fv4_gsrb2_cluster.cu,
  ``stencils.fv4_gsrb2_cluster_cuda``): against ``fv4_gsrb2_plain`` and
  against two K1 gsrb launches, at n from 8 to the kernel's largest
  (``GSRB2_CLUSTER_MAX_N``), odd n included, float32 and float64, with and
  without a*alpha*x;
* K4a, K4b and K4c, the tail's descent, climb and one-launch V-cycle
  (csrc/tail.cu) against ``tail_down_plain``, ``tail_up_plain`` and
  ``tail_v_plain`` on the ladders 32-16 and 16 (and 32-16-8), float32 and
  float64, with and without a*alpha*x;
* both refuse a periodic level and a size beyond their limits.

max|kernel - plain| / max|plain| <= 1e-5 in float32 (the kernels sum in
another order than the plain versions) and 1e-12 in float64.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_cluster.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import tail as T

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]


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
            ((n + 1, n + 2, n + 2), (n + 2, n + 1, n + 2), (n + 2, n + 2, n + 1))]
    dinv = t((0.5 + rng.random((n, n, n))) / (8.0 * n * n))  # ~ h^2/8
    return Level(dim=n, h=1.0 / n, depth=0, beta_i=beta[0], beta_j=beta[1],
                 beta_k=beta[2], alpha=t(rng.random((n, n, n))), dinv=dinv,
                 kdinv=tuple(rb_mask(n, p, dtype, dev) * dinv for p in (0, 1)))


def _cfgs(dtype):
    return (SolverConfig(a=0.0, dtype=dtype),
            SolverConfig(a=1.5, helmholtz=True, dtype=dtype))


def _two_k1(lv, x, rhs, cfg):
    y = S.fv4_stencil_cuda(lv, x, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[0], parity=0)
    return S.fv4_stencil_cuda(lv, y, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[1], parity=1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [8, 9, 12, 16, 20, 32, 33, 36, 48, S.GSRB2_CLUSTER_MAX_N])
def test_k2c_matches_plain_and_two_k1(dev, n, dtype):
    rng = np.random.default_rng(n)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    for cfg in _cfgs(dtype):
        launches = S.fv4_gsrb2_cluster_cuda.launches
        out = S.fv4_gsrb2(lv, x, rhs, cfg)  # the entry launches K2c
        assert S.fv4_gsrb2_cluster_cuda.launches == launches + 1
        assert relerr(out, S.fv4_gsrb2_plain(lv, x, rhs, cfg)) <= TOL[dtype], cfg
        assert relerr(out, _two_k1(lv, x, rhs, cfg)) <= TOL[dtype], cfg


def test_k2c_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(0)
    n = S.GSRB2_CLUSTER_MAX_N + 2
    lv = _level(n, torch.float32, dev, rng)
    x = torch.zeros((n, n, n), device=dev)
    with pytest.raises(ValueError, match="K2c takes n"):
        S.fv4_gsrb2(lv, x, x, SolverConfig(a=0.0))
    lv8, x8 = _level(8, torch.float32, dev, rng), torch.zeros((8, 8, 8), device=dev)
    with pytest.raises(NotImplementedError):
        S.fv4_gsrb2_cluster_cuda(lv8, x8, x8, SolverConfig(a=0.0, bc=BC.PERIODIC))


def _bottom(d, dtype, dev, rng):
    m = d ** 3
    ainv = (np.eye(m) + 0.1 * rng.standard_normal((m, m)) / np.sqrt(m)) / (8.0 * d * d)
    return dataclasses.replace(_level(d, dtype, dev, rng),
                               bottom_ainv=torch.tensor(ainv, dtype=dtype, device=dev))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", [(32, 16), (16,), (32, 16, 8)])
def test_k4_matches_plain(dev, dims, dtype):
    """K4a's e and res of every level, K4b's solution and K4c's, each
    against its plain version."""
    rng = np.random.default_rng(dims[0] + len(dims))
    for cfg in _cfgs(dtype):
        tail = [_level(d, dtype, dev, rng) for d in dims]
        e, rhs = (torch.tensor(a, dtype=dtype, device=dev)
                  for a in rng.standard_normal((2,) + tail[0].shape))
        es, rhss = T.tail_down_cuda(tail, e, rhs, cfg, 6)
        es_p, rhss_p = T.tail_down_plain(tail, e, rhs, cfg, 6)
        for got, want in zip(es + rhss, es_p + rhss_p):
            assert relerr(got, want) <= TOL[dtype], (cfg, "down")
        d = dims[-1] // 2
        u_bot = torch.tensor(rng.standard_normal((d, d, d)), dtype=dtype, device=dev)
        up = T.tail_up_cuda(tail, es_p, [rhs] + rhss_p[:-1], u_bot, cfg, 6)
        want = T.tail_up_plain(tail, es_p, [rhs] + rhss_p[:-1], u_bot, cfg, 6)
        assert relerr(up, want) <= TOL[dtype], (cfg, "up")
        bottom = _bottom(d, dtype, dev, rng)
        v = T.tail_v_cuda(tail, bottom, e, rhs, cfg, 6)
        assert relerr(v, T.tail_v_plain(tail, bottom, e, rhs, cfg, 6)) <= TOL[dtype], \
            (cfg, "v")


def test_k4_refuses_what_it_does_not_take(dev):
    """A periodic level, and a 64^3 first level, whose slab and halos do not
    fit a block's shared memory."""
    rng = np.random.default_rng(1)
    cfg = SolverConfig(a=0.0)
    tail = [_level(d, torch.float32, dev, rng) for d in (16,)]
    bottom = _bottom(8, torch.float32, dev, rng)
    e = torch.zeros(tail[0].shape, device=dev)
    periodic = SolverConfig(a=0.0, bc=BC.PERIODIC)
    for launch in (lambda: T.tail_v_cuda(tail, bottom, e, e, periodic, 6),
                   lambda: T.tail_down_cuda(tail, e, e, periodic, 6),
                   lambda: T.tail_up_cuda(tail, [e], [e], e[:8, :8, :8].contiguous(),
                                          periodic, 6)):
        with pytest.raises(NotImplementedError):
            launch()
    big = [_level(d, torch.float32, dev, rng) for d in (64, 32)]
    e64 = torch.zeros(big[0].shape, device=dev)
    assert T.tail_smem(64, 4) > T.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        T.tail_down_cuda(big, e64, e64, cfg, 6)
