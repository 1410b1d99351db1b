"""The var7 body of K5 and K7b, and K8c, on a card: the streaming kernel
(hpgmg_tpu_torch/kernels/csrc/r1_var7_stream.cu; ``stencils_r1.
r1_stencil_cuda`` for the var7 body, ``r1_slab_cuda`` for K8c) against
its plain versions ``stencils_r1.r1_stencil_plain`` and ``r1_slab_plain``
on the same CUDA tensors:

* K5/K7b var7: every mode (apply, residual, gsrb for both parities, fres
  at even n), the fv7pt (p1) and fv2 (v2) ghost taps, with and without
  a*alpha*x, both BCs, float32 and float64, at n in {4, 6, 8, 9, 16, 24,
  33, 34, 48, 64, 128} (ragged 16 x 32 column tiles, odd n outside fres);
  a gsrb leaves the other colour's cells equal to x bit for bit; forced
  chunks of i-planes give the launcher's bits; a call is one launch on
  its BC's counter;
* K8c on 2x2 blocks with random slabs and coefficients, thin and ragged
  ones included, with the var7 (p1, v2, p1 with alpha) and the 27pt (a = 0
  and 1.5) bodies, every mode, both BCs and dtypes, the same gsrb and
  chunk checks; its launches count by block;
* K8c on one block that is the whole domain (``single_chip_slabs_r1``)
  equals K5/K7b on the level to the same tolerance (its i/j ghosts come
  from slabs rounded apart from K5's window).

max|kernel - plain| / max|plain| <= 1e-5 (f32: another order of summation
than the plain version) and 1e-12 (f64). The wrappers refuse a gsrb
without its parity, an odd fres and a negative chunk.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_r1_var7_stream.py -q
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
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SIZES = [4, 6, 8, 9, 16, 24, 33, 34, 48, 64, 128]
# (taps, var7, helmholtz): fv7pt, fv2, fv7pt with a*alpha*x; K8c also the
# 27pt body without and with its constant a*x
VAR7 = [("p1", True, False), ("v2", True, False), ("p1", True, True)]
BODIES = VAR7 + [("27pt", False, False), ("27pt", False, True)]
# 2x2 local blocks: thin (narrower than a column tile), ragged (no multiple
# of the 16 x 32 tile) and the 2x2 grid's own
BLOCKS = [(2, 2, 4), (4, 4, 8), (6, 10, 12), (8, 8, 16), (16, 48, 32), (24, 40, 48),
          (34, 18, 36), (64, 64, 128)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def relerr(out, ref) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _level(shape, dtype, dev, rng):
    """Random natural face arrays, alpha and a parity-folded diagonal of the
    operator's scale on an ni x nj x nk block (a level where it is a cube)."""
    ni, nj, nk = shape
    n = max(ni, nj, nk)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    dinv = t((0.5 + rng.random(shape)) / (8.0 * n * n))
    mask = rb_mask(max(shape), 0, dtype, dev)[:ni, :nj, :nk]
    beta = [t(1.0 + 0.25 * rng.random(s)) for s in
            ((ni + 1, nj, nk), (ni, nj + 1, nk), (ni, nj, nk + 1))]
    return Level(dim=n, h=1.0 / n, depth=0, beta_i=beta[0], beta_j=beta[1], beta_k=beta[2],
                 alpha=t(0.5 + rng.random(shape)), dinv=dinv,
                 kdinv=(mask * dinv, (1 - mask) * dinv))


def _cases(shape, lv, rhs):
    """(mode, kwargs) of every mode: gsrb at both parities, fres where every
    extent is even."""
    out = [("apply", {}), ("residual", {"rhs": rhs})]
    out += [("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p], "parity": p}) for p in (0, 1)]
    if all(m % 2 == 0 for m in shape):
        out.append(("fres", {"rhs": rhs}))
    return out


def _cfg(taps, helm, dtype, bc):
    a = 1.5 if helm else 0.0
    return SolverConfig(op="27pt" if taps == "27pt" else "fv7pt", a=a, b=1.0,
                        helmholtz=helm and taps != "27pt", dtype=dtype, bc=bc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bc", [BC.DIRICHLET, BC.PERIODIC])
@pytest.mark.parametrize("n", SIZES)
def test_var7_modes_match_plain(dev, n, bc, dtype):
    rng = np.random.default_rng(700 + n)
    lv = _level((n, n, n), dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    counter = "periodic_launches" if bc == BC.PERIODIC else "launches"
    before = getattr(K.r1_stencil_cuda, counter), K.r1_stream_cuda.launches
    calls = 0
    for taps, var7, helm in VAR7:
        cfg = _cfg(taps, helm, dtype, bc)
        for mode, kw in _cases((n, n, n), lv, rhs):
            ref = K.r1_stencil_plain(lv, x, cfg, mode, taps, var7, **kw)
            out = K.r1_stencil(lv, x, cfg, mode, taps, var7, **kw)
            calls += 1
            assert out.is_cuda and out.shape == ref.shape
            assert relerr(out, ref) <= TOL[dtype], (taps, helm, mode, kw.get("parity"))
            if mode == "gsrb":
                other = kw["kdinv"] == 0
                assert torch.equal(out[other], x[other]), (taps, helm, kw["parity"])
            for chunk in (1, 2, 3, n):
                short = K.r1_stencil_cuda(lv, x, cfg, mode, taps, var7, chunk=chunk, **kw)
                calls += 1
                assert torch.equal(short, out), (taps, helm, mode, chunk)
    assert (getattr(K.r1_stencil_cuda, counter), K.r1_stream_cuda.launches) == (
        before[0] + calls, before[1])


def _slabs(shape, dtype, dev, rng):
    ni, nj, nk = shape
    return tuple(torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                 for s in ((1, nj, nk), (1, nj, nk), (ni + 2, 1, nk), (ni + 2, 1, nk)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("block", BLOCKS)
def test_k8c_blocks_match_plain(dev, block, dtype):
    rng = np.random.default_rng(sum(block))
    lv = _level(block, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, *block)))
    slabs = _slabs(block, dtype, dev, rng)
    S.slab_launches_by_block.clear()
    launches, calls = K.r1_slab_cuda.launches, 0
    for taps, var7, helm in BODIES:
        for bc in (BC.DIRICHLET, BC.PERIODIC):
            cfg = _cfg(taps, helm, dtype, bc)
            for mode, kw in _cases(block, lv, rhs):
                par = {"parity": kw.pop("parity")} if "parity" in kw else {}
                ref = K.r1_slab_plain(lv, x, slabs, cfg, mode, taps, var7, **kw)
                out = K.r1_slab(lv, x, slabs, cfg, mode, taps, var7, **kw, **par)
                calls += 1
                assert out.shape == ref.shape
                assert relerr(out, ref) <= TOL[dtype], (taps, helm, bc, mode, par)
                if mode == "gsrb":
                    other = kw["kdinv"] == 0
                    assert torch.equal(out[other], x[other]), (taps, helm, bc, par)
                for chunk in (1, 3):
                    short = K.r1_slab_cuda(lv, x, slabs, cfg, mode, taps, var7, **kw,
                                           **par, chunk=chunk)
                    calls += 1
                    assert torch.equal(short, out), (taps, helm, bc, mode, chunk)
    assert K.r1_slab_cuda.launches == launches + calls
    assert sum(v for k, v in S.slab_launches_by_block.items()
               if k.startswith("K8c") and k.endswith(str(block))) == calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [6, 9, 34, 64])
def test_k8c_on_one_block_equals_k5(dev, n, dtype):
    rng = np.random.default_rng(800 + n)
    lv = _level((n, n, n), dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    for taps, var7, helm in BODIES:
        for bc in (BC.DIRICHLET, BC.PERIODIC):
            cfg = _cfg(taps, helm, dtype, bc)
            slabs = K.single_chip_slabs_r1(x, bc, taps)
            for mode, kw in _cases((n, n, n), lv, rhs):
                out = K.r1_slab(lv, x, slabs, cfg, mode, taps, var7, **kw)
                ref = K.r1_stencil(lv, x, cfg, mode, taps, var7, **kw)
                assert relerr(out, ref) <= TOL[dtype], (taps, helm, bc, mode)


def test_var7_and_k8c_refuse_what_they_do_not_take(dev):
    rng = np.random.default_rng(9)
    lv = _level((8, 8, 8), torch.float32, dev, rng)
    x = torch.zeros((8, 8, 8), device=dev)
    cfg = SolverConfig(op="fv7pt", a=0.0, b=1.0)
    slabs = K.single_chip_slabs_r1(x, BC.DIRICHLET, "p1")
    for bad in (None, 2):
        with pytest.raises(ValueError, match="parity"):
            K.r1_stencil_cuda(lv, x, cfg, "gsrb", "p1", True, rhs=x, kdinv=lv.kdinv[0],
                              parity=bad)
        with pytest.raises(ValueError, match="parity"):
            K.r1_slab_cuda(lv, x, slabs, cfg, "gsrb", "p1", True, rhs=x,
                           kdinv=lv.kdinv[0], parity=bad)
    with pytest.raises(ValueError, match="chunk"):
        K.r1_stencil_cuda(lv, x, cfg, "apply", "p1", True, chunk=-1)
    with pytest.raises(ValueError, match="chunk"):
        K.r1_slab_cuda(lv, x, slabs, cfg, "apply", "p1", True, chunk=-1)
    odd = _level((8, 6, 9), torch.float32, dev, rng)
    y = torch.zeros((8, 6, 9), device=dev)
    with pytest.raises(ValueError, match="fres"):
        K.r1_slab_cuda(odd, y, _slabs((8, 6, 9), torch.float32, dev, rng), cfg, "fres",
                       "p1", True, rhs=y)
    with pytest.raises(ValueError, match="CUDA"):
        K.r1_stencil_cuda(dataclasses.replace(lv, beta_i=lv.beta_i.cpu(),
                                              beta_j=lv.beta_j.cpu(),
                                              beta_k=lv.beta_k.cpu()),
                          x.cpu(), cfg, "apply", "p1", True)

