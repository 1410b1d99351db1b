"""K2 on a card: the full fv4 red+black GSRB sweep in one ordinary launch
(hpgmg_tpu_torch/kernels/csrc/fv4_gsrb2.cu, ``stencils.fv4_gsrb2_cuda``)
on the same CUDA tensors as

* two K1 gsrb launches (``fv4_stencil_cuda``, parity 0 with kdinv[0], then
  parity 1 with kdinv[1]): equal bit for bit (the same fv4_combination and
  ghost formula);
* its plain version ``fv4_gsrb2_plain``: max|kernel - plain| / max|plain|
  <= 1e-5 (f32: another order of summation than the plain version) and
  1e-12 (f64);

with and without a*alpha*x, float32 and float64, at n in {4, 8, 12, 20,
36, 48, 64, 128, 256} (levels thinner than the column tile, sizes that are
not a multiple of it, levels shorter than one chunk of i-planes). Every
chunk of i-planes, down to the shortest the launcher takes (4), gives the
launcher's result bit for bit, also at odd n and at sizes whose last tile
would hold one cell (17, 33). K2 refuses periodic levels.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_gsrb2.py -q
"""

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils as S

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SIZES = [4, 8, 12, 20, 36, 48, 64, 128, 256]


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


def _fields(n, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    return lv, x, rhs


def _two_k1(lv, x, rhs, cfg):
    y = S.fv4_stencil_cuda(lv, x, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[0], parity=0)
    return S.fv4_stencil_cuda(lv, y, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[1], parity=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", SIZES)
def test_gsrb2_equals_two_k1_and_matches_plain(dev, n, dtype):
    lv, x, rhs = _fields(n, dtype, dev, 300 + n)
    before = S.fv4_gsrb2_cuda.launches
    for helmholtz in (False, True):
        cfg = SolverConfig(a=1.5 if helmholtz else 0.0, b=1.0, helmholtz=helmholtz,
                           dtype=dtype)
        out = S.fv4_gsrb2_cuda(lv, x, rhs, cfg)
        assert out.is_cuda
        assert torch.equal(out, _two_k1(lv, x, rhs, cfg)), helmholtz
        assert relerr(out, S.fv4_gsrb2_plain(lv, x, rhs, cfg)) <= TOL[dtype], helmholtz
    assert S.fv4_gsrb2_cuda.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [9, 17, 33, 64])
def test_gsrb2_chunks_and_odd_sizes(dev, n, dtype):
    lv, x, rhs = _fields(n, dtype, dev, 400 + n)
    cfg = SolverConfig(a=0.0, b=1.0, dtype=dtype)
    ref = S.fv4_gsrb2_cuda(lv, x, rhs, cfg)
    assert torch.equal(ref, _two_k1(lv, x, rhs, cfg))
    assert relerr(ref, S.fv4_gsrb2_plain(lv, x, rhs, cfg)) <= TOL[dtype]
    for chunk in (4, 5, 8, n - 1, n):
        assert torch.equal(S.fv4_gsrb2_cuda(lv, x, rhs, cfg, chunk=chunk), ref), chunk


def test_gsrb2_refuses_what_it_does_not_take(dev):
    lv, x, rhs = _fields(8, torch.float32, dev, 7)
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        S.fv4_gsrb2_cuda(lv, x, rhs, SolverConfig(a=0.0, b=1.0, bc=BC.PERIODIC))
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        S.fv4_gsrb2(lv, x, rhs, SolverConfig(a=0.0, b=1.0, bc=BC.PERIODIC))
    cpu, xc, rc = _fields(8, torch.float32, torch.device("cpu"), 7)
    with pytest.raises(ValueError, match="CUDA"):
        S.fv4_gsrb2_cuda(cpu, xc, rc, SolverConfig(a=0.0, b=1.0))
