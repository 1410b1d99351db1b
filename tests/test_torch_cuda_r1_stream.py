"""The 27pt body of K5 and K7b on a card: the streaming kernel
(hpgmg_tpu_torch/kernels/csrc/r1_stream.cu, ``stencils_r1.r1_stream_cuda``,
which ``r1_stencil`` launches for the 27pt body on CUDA tensors) against
its plain version ``stencils_r1.r1_stencil_plain`` on the same CUDA
tensors: every mode (apply, residual, gsrb for both parities, fres at even
n), the 27pt body with a = 0 and with its constant a*x (a = 1.5), both BCs
(2-tap Dirichlet ghosts, wrapped ones), float32 and float64, at n in {2, 3,
4, 8, 9, 33, 48, 64} (n = 2: every cell a boundary cell, the low and high
periodic ghosts the same cells; odd n; sizes that are not a multiple of the
16 x 32 column tile), each with the launcher's chunk of i-planes and with
short forced chunks (fres rounds its chunk up to an even length),
max|kernel - plain| / max|plain| <= 1e-5 (f32: another order of summation
than the plain version) and 1e-12 (f64). A gsrb half-sweep leaves the
other colour's cells equal to x bit for bit; a call is one launch, counted
on its BC's counter; the wrapper refuses a bad parity, an odd-n fres and a
wrong dtype or shape.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_r1_stream.py -q
"""

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils_r1 as K

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SIZES = [2, 3, 4, 8, 9, 33, 48, 64]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def relerr(out, ref) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _level(n, dtype, dev, rng):
    """A 27pt level: the body reads no face arrays; a parity-folded random
    diagonal of the operator's scale."""
    z = torch.zeros((n + 1, n, n), dtype=dtype, device=dev)
    dinv = torch.tensor((0.5 + rng.random((n, n, n))) / (8.0 * n * n), dtype=dtype,
                        device=dev)
    return Level(dim=n, h=1.0 / n, depth=0, beta_i=z,
                 beta_j=z.permute(1, 0, 2).contiguous(),
                 beta_k=z.permute(1, 2, 0).contiguous(), dinv=dinv,
                 kdinv=tuple(rb_mask(n, p, dtype, dev) * dinv for p in (0, 1)))


def _cases(lv, rhs):
    """(mode, kwargs, parity) of every mode, gsrb at both parities, fres
    where n is even."""
    out = [("apply", {}, None), ("residual", {"rhs": rhs}, None)]
    out += [("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}, p) for p in (0, 1)]
    if lv.dim % 2 == 0:
        out.append(("fres", {"rhs": rhs}, None))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("n", SIZES)
def test_r1_stream_modes_match_plain(dev, n, bc, dtype):
    rng = np.random.default_rng(300 + n)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    counter = "periodic_launches" if bc == BC.PERIODIC else "launches"
    before = getattr(K.r1_stream_cuda, counter), K.r1_stencil_cuda.launches
    calls = 0
    for a in (0.0, 1.5):
        cfg = SolverConfig(op="27pt", a=a, b=1.0, dtype=dtype, bc=bc)
        for mode, kw, parity in _cases(lv, rhs):
            ref = K.r1_stencil_plain(lv, x, cfg, mode, "27pt", False, parity=parity, **kw)
            out = K.r1_stencil(lv, x, cfg, mode, "27pt", False, parity=parity, **kw)
            calls += 1
            assert out.is_cuda and out.shape == ref.shape
            assert relerr(out, ref) <= TOL[dtype], (mode, parity, a)
            if mode == "gsrb":
                other = lv.kdinv[parity] == 0
                assert torch.equal(out[other], x[other]), (parity, a)
            for chunk in (1, 2, 3):
                short = K.r1_stream_cuda(lv, x, cfg, mode, "27pt", parity=parity,
                                         chunk=chunk, **kw)
                calls += 1
                assert relerr(short, ref) <= TOL[dtype], (mode, parity, a, chunk)
    assert (getattr(K.r1_stream_cuda, counter), K.r1_stencil_cuda.launches) == (
        before[0] + calls, before[1])


@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("n", [9, 33, 64])
def test_r1_stream_chunks_equal_bit_for_bit(dev, n, bc):
    """Any chunk of i-planes gives the launcher's result bit for bit (a
    cell's sum never depends on where its block's chunk starts)."""
    rng = np.random.default_rng(400 + n)
    dtype = torch.float32
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    cfg = SolverConfig(op="27pt", a=0.0, b=1.0, dtype=dtype, bc=bc)
    for mode, kw, parity in _cases(lv, rhs):
        ref = K.r1_stream_cuda(lv, x, cfg, mode, "27pt", parity=parity, **kw)
        for chunk in (1, 4, 7, n):
            out = K.r1_stream_cuda(lv, x, cfg, mode, "27pt", parity=parity, chunk=chunk,
                                   **kw)
            assert torch.equal(out, ref), (mode, chunk)


def test_r1_stream_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(9)
    lv = _level(8, torch.float32, dev, rng)
    x = torch.zeros((8, 8, 8), device=dev)
    cfg = SolverConfig(op="27pt", a=0.0, b=1.0)
    for bad in (None, 2):
        with pytest.raises(ValueError, match="parity"):
            K.r1_stream_cuda(lv, x, cfg, "gsrb", "27pt", rhs=x, kdinv=lv.kdinv[0],
                             parity=bad)
        with pytest.raises(ValueError, match="parity"):
            K.r1_stencil(lv, x, cfg, "gsrb", "27pt", False, rhs=x, kdinv=lv.kdinv[0],
                         parity=bad)
    odd = _level(9, torch.float32, dev, rng)
    y = torch.zeros((9, 9, 9), device=dev)
    with pytest.raises(ValueError, match="fres"):
        K.r1_stream_cuda(odd, y, cfg, "fres", "27pt", rhs=y)
    with pytest.raises(TypeError):
        K.r1_stream_cuda(lv, x.double(), cfg, "apply", "27pt")
    with pytest.raises(ValueError, match="shape"):
        K.r1_stream_cuda(lv, x[:, :, :-1].contiguous(), cfg, "apply", "27pt")
    with pytest.raises(ValueError, match="shape"):
        K.r1_stream_cuda(lv, x, cfg, "residual", "27pt", rhs=y)
    with pytest.raises(ValueError, match="chunk"):
        K.r1_stream_cuda(lv, x, cfg, "apply", "27pt", chunk=-1)
    cpu = _level(8, torch.float32, torch.device("cpu"), rng)
    with pytest.raises(ValueError, match="CUDA"):
        K.r1_stream_cuda(cpu, x.cpu(), cfg, "apply", "27pt")
