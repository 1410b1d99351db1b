"""K1s on a card: the one-pass fv4 stencil for the small Dirichlet levels
(hpgmg_tpu_torch/kernels/csrc/fv4_subtile.cu, ``stencils.fv4_subtile_cuda``)
against its plain version ``stencils.fv4_subtile_plain`` on the same CUDA
tensors: apply, residual and gsrb for both parities, with and without
a*alpha*x, float32 and float64, at n in {4, 5, 8, 9, 16, 33, 64, 128}
(levels thinner than a tile, odd n, tiles ragged along j and k, tiles of
one cell along j or k whose ghosts come from device memory),
max|kernel - plain| / max|plain| <= K1S_TOL (the kernel's ghosts round in
another order than the plain version's separable fill). On each, K1s
equals K1 (``fv4_stencil_cuda``, the same arithmetic and ghost formula)
bit for bit; every forced tile length along i (1 to ``SUBTILE_MAX_TI``)
gives the launcher's result bit for bit; a gsrb half-sweep leaves the
other colour's cells equal to x bit for bit; a call is one launch.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_subtile.py -q
"""

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils as S

pytestmark = pytest.mark.cuda
K1S_TOL = {torch.float32: 2e-6, torch.float64: 1e-13}
SIZES = [4, 5, 8, 9, 16, 33, 64, 128]


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


def _cases(lv, rhs):
    """(mode, kwargs, parity) of every K1s mode, gsrb at both parities."""
    return ([("apply", {}, None), ("residual", {"rhs": rhs}, None)]
            + [("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}, p) for p in (0, 1)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", SIZES)
def test_k1s_matches_plain_k1_and_itself(dev, n, dtype):
    rng = np.random.default_rng(300 + n)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    before, calls = S.fv4_subtile_cuda.launches, 0
    for helmholtz in (False, True):
        cfg = SolverConfig(a=1.5 if helmholtz else 0.0, b=1.0, helmholtz=helmholtz,
                           dtype=dtype)
        for mode, kw, parity in _cases(lv, rhs):
            why = (mode, parity, helmholtz)
            out = S.fv4_subtile(lv, x, cfg, mode, parity=parity, **kw)
            calls += 1
            assert out.is_cuda
            ref = S.fv4_subtile_plain(lv, x, cfg, mode, parity=parity, **kw)
            assert relerr(out, ref) <= K1S_TOL[dtype], why
            assert torch.equal(out, S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity,
                                                       **kw)), why
            if mode == "gsrb":
                other = lv.kdinv[parity] == 0
                assert torch.equal(out[other], x[other]), why
            for ti in range(1, S.SUBTILE_MAX_TI + 1):
                forced = S.fv4_subtile_cuda(lv, x, cfg, mode, parity=parity, ti=ti, **kw)
                calls += 1
                assert torch.equal(forced, out), (*why, ti)
    assert S.fv4_subtile_cuda.launches == before + calls


def test_k1s_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(8)
    lv = _level(8, torch.float32, dev, rng)
    x = torch.zeros((8, 8, 8), device=dev)
    cfg = SolverConfig(a=0.0, b=1.0)
    with pytest.raises(ValueError, match="parity"):
        S.fv4_subtile_cuda(lv, x, cfg, "gsrb", rhs=x, kdinv=lv.kdinv[0])
    with pytest.raises(ValueError, match="tile length"):
        S.fv4_subtile_cuda(lv, x, cfg, "apply", ti=S.SUBTILE_MAX_TI + 1)
    cpu = _level(8, torch.float32, torch.device("cpu"), rng)
    with pytest.raises(ValueError, match="CUDA"):
        S.fv4_subtile_cuda(cpu, x.cpu(), cfg, "apply")
