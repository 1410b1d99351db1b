"""K1s's half-sweep parity on the CPU, at 8^3-16^3:

* the plain K1s gsrb with each parity equals K1's plain gsrb with the
  kdinv of that parity bit for bit, with and without a*alpha*x;
* the plain version and the entry refuse a gsrb without a parity, and the
  CUDA wrapper a tile length beyond ``SUBTILE_MAX_TI``;
* the fv4 suite hands the sweep's parity to K1s under ``SUBTILE``: its
  ``gsrb_sweep`` (parity & 1) and its half-sweep smoother (0, 1, 0, ...).

The CUDA kernel runs only on a card (tests/test_torch_cuda_subtile.py).
"""

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.ops import fv4 as FV4
from hpgmg_tpu_torch.ops.base import get_suite


def _level(n, rng):
    dt = torch.float64

    def t(a):
        return torch.tensor(a, dtype=dt)

    beta = [t(1.0 + 0.25 * rng.random(s)) for s in
            ((n + 1, n + 2, n + 2), (n + 2, n + 1, n + 2), (n + 2, n + 2, n + 1))]
    dinv = t((0.5 + rng.random((n, n, n))) / (8.0 * n * n))
    return Level(dim=n, h=1.0 / n, depth=0, beta_i=beta[0], beta_j=beta[1],
                 beta_k=beta[2], alpha=t(rng.random((n, n, n))), dinv=dinv,
                 kdinv=tuple(rb_mask(n, p, dt, torch.device("cpu")) * dinv
                             for p in (0, 1)))


def _fields(n, seed):
    rng = np.random.default_rng(seed)
    lv = _level(n, rng)
    x, rhs = (torch.tensor(a) for a in rng.standard_normal((2, n, n, n)))
    return lv, x, rhs


@pytest.mark.parametrize("helmholtz", [False, True])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("n", [8, 9, 16])
def test_plain_k1s_gsrb_equals_k1_plain(n, parity, helmholtz):
    lv, x, rhs = _fields(n, 500 + n)
    cfg = SolverConfig(a=1.5 if helmholtz else 0.0, b=1.0, helmholtz=helmholtz,
                       dtype=torch.float64)
    kw = {"rhs": rhs, "kdinv": lv.kdinv[parity]}
    out = S.fv4_subtile(lv, x, cfg, "gsrb", parity=parity, **kw)
    assert torch.equal(out, S.fv4_stencil_plain(lv, x, cfg, "gsrb", **kw))
    other = lv.kdinv[parity] == 0
    assert torch.equal(out[other], x[other])


def test_k1s_refuses_a_gsrb_without_parity():
    lv, x, rhs = _fields(8, 7)
    cfg = SolverConfig(a=0.0, b=1.0, dtype=torch.float64)
    kw = {"rhs": rhs, "kdinv": lv.kdinv[0]}
    for fn in (S.fv4_subtile, S.fv4_subtile_plain):
        for bad in (None, 2):
            with pytest.raises(ValueError, match="parity"):
                fn(lv, x, cfg, "gsrb", parity=bad, **kw)
    with pytest.raises(ValueError, match="tile length"):
        S.fv4_subtile_cuda(lv, x, cfg, "apply", ti=S.SUBTILE_MAX_TI + 1)


def test_fv4_suite_hands_the_parity_to_k1s(monkeypatch):
    lv, x, rhs = _fields(16, 11)
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64)
    op = get_suite("fv4")
    seen = []

    def spy(level, x, cfg, mode, rhs=None, kdinv=None, parity=None):
        seen.append((mode, parity, kdinv is level.kdinv[parity] if mode == "gsrb" else None))
        return S.fv4_subtile(level, x, cfg, mode, rhs, kdinv, parity)

    monkeypatch.setattr(FV4, "fv4_subtile", spy)
    monkeypatch.setattr(S, "SUBTILE", True)
    monkeypatch.setattr(S, "SUBTILE_MAX_DIM", 16)
    for p in range(4):
        op.gsrb_sweep(lv, x, rhs, cfg, p)
    assert seen == [("gsrb", p & 1, True) for p in range(4)]
    seen.clear()
    monkeypatch.setattr(S, "GSRB2_MAX_DIM", 0)  # half-sweeps, not K2c's full ones
    op.gsrb_smooth(lv, x, rhs, cfg, 6)
    assert seen == [("gsrb", p & 1, True) for p in range(6)]
    seen.clear()
    op.residual(lv, x, rhs, cfg)
    assert seen == [("residual", None, None)]
