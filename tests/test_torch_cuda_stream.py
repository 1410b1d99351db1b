"""K1 and K7a on a card: the fv4 stencil in one launch
(hpgmg_tpu_torch/kernels/csrc/fv4_stream.cu, ``stencils.fv4_stencil_cuda``)
against its plain version ``stencils.fv4_stencil_plain`` on the same CUDA
tensors: every mode (apply, residual, gsrb for both parities, fres), both
BCs (quartic Dirichlet ghosts, wrapped ones), with and without a*alpha*x,
float32 and float64, at n in {4, 8, 12, 20, 36, 48, 64, 128} (sizes that
are not a multiple of the 16 x 32 column tile, and levels shorter than one
i chunk), max|kernel - plain| / max|plain| <= 1e-5 (f32: another order of
summation than the plain version) and 1e-12 (f64). On Dirichlet levels
apply, residual and gsrb equal K1s (``fv4_subtile_cuda``, the same
arithmetic and ghost formula) bit for bit; a gsrb half-sweep leaves the
other colour's cells equal to x bit for bit; a call is one launch, counted
on its BC's counter; odd n and a chunk shorter than the level take the
same path.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_stream.py -q
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
SIZES = [4, 8, 12, 20, 36, 48, 64, 128]


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
    """(mode, kwargs, parity) of every mode, gsrb at both parities."""
    out = [("apply", {}, None), ("residual", {"rhs": rhs}, None)]
    out += [("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}, p) for p in (0, 1)]
    if lv.dim % 2 == 0:
        out.append(("fres", {"rhs": rhs}, None))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("n", SIZES)
def test_stream_modes_match_plain(dev, n, bc, dtype):
    rng = np.random.default_rng(n)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    counter = "periodic_launches" if bc == BC.PERIODIC else "launches"
    before = getattr(S.fv4_stencil_cuda, counter)
    calls = 0
    for helmholtz in (False, True):
        cfg = SolverConfig(a=1.5 if helmholtz else 0.0, b=1.0, helmholtz=helmholtz,
                           dtype=dtype, bc=bc)
        for mode, kw, parity in _cases(lv, rhs):
            out = S.fv4_stencil(lv, x, cfg, mode, parity=parity, **kw)
            calls += 1
            assert out.is_cuda
            ref = S.fv4_stencil_plain(lv, x, cfg, mode, **kw)
            assert relerr(out, ref) <= TOL[dtype], (mode, parity, helmholtz)
            if mode == "gsrb":
                other = lv.kdinv[parity] == 0
                assert torch.equal(out[other], x[other]), (parity, helmholtz)
    assert getattr(S.fv4_stencil_cuda, counter) == before + calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", SIZES)
def test_stream_equals_k1s_bit_for_bit(dev, n, dtype):
    rng = np.random.default_rng(100 + n)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    for helmholtz in (False, True):
        cfg = SolverConfig(a=1.5 if helmholtz else 0.0, b=1.0, helmholtz=helmholtz,
                           dtype=dtype)
        for mode, kw, parity in _cases(lv, rhs):
            if mode == "fres":  # K1s has no fres mode
                continue
            out = S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity, **kw)
            assert torch.equal(out, S.fv4_subtile_cuda(lv, x, cfg, mode, **kw)), \
                (mode, parity, helmholtz)


@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("n", [9, 33, 64])
def test_stream_chunks_and_odd_sizes(dev, n, bc):
    """Any chunk of i-planes gives the launcher's result bit for bit (fres
    rounds its chunk up to an even length); odd n (the 9^3 level of a 36^3
    ladder) takes every mode but fres."""
    rng = np.random.default_rng(200 + n)
    dtype = torch.float64
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    cfg = SolverConfig(a=0.0, b=1.0, dtype=dtype, bc=bc)
    for mode, kw, parity in _cases(lv, rhs):
        ref = S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity, **kw)
        assert relerr(ref, S.fv4_stencil_plain(lv, x, cfg, mode, **kw)) <= TOL[dtype]
        for chunk in (1, 3, 8, n):
            out = S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity, chunk=chunk, **kw)
            assert torch.equal(out, ref), (mode, chunk)


def test_stream_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(7)
    lv = _level(8, torch.float32, dev, rng)
    x = torch.zeros((8, 8, 8), device=dev)
    cfg = SolverConfig(a=0.0, b=1.0)
    with pytest.raises(ValueError, match="parity"):
        S.fv4_stencil_cuda(lv, x, cfg, "gsrb", rhs=x, kdinv=lv.kdinv[0])
    cpu = _level(8, torch.float32, torch.device("cpu"), rng)
    with pytest.raises(ValueError, match="CUDA"):
        S.fv4_stencil_cuda(cpu, x.cpu(), cfg, "apply")
    odd = _level(9, torch.float32, dev, rng)
    with pytest.raises(ValueError, match="fres"):
        S.fv4_stencil_cuda(odd, torch.zeros((9, 9, 9), device=dev), cfg, "fres",
                           rhs=torch.zeros((9, 9, 9), device=dev))
