"""The bfloat16 kernels on a card against their plain versions on the same
CUDA tensors: K1 (every mode) and K1s (apply, residual, gsrb) each cell
within one bf16 unit in the last place of the plain version's (the same
float32 arithmetic on widened operands and one rounding; where the two
float32 sums differ in order the rounding may land one unit apart, and at
a cell that cancels far below max|out| the float32 tolerance 1e-5 of
max|out| holds instead), K1 == K1s bit for bit; K3 likewise; K2c (two
rounded half-sweeps) and K4a/K4b (six a level, then e, res and the
climb's interpolation, each rounded) within one unit of max|out| (a
one-unit difference at a cell moves its neighbours' later updates);
K1's BF16C gsrb (float32 x, bf16 face arrays and kdinv) against its plain
version to 1e-5 of max|out| (how far BF16C moves a half-sweep from the
float32 one depends on the data: chip_smoke.py and
tests/test_torch_bf16c.py measure it on the benchmark's levels). Every
entry refuses a level below 4^3.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest --noconftest tests/test_torch_cuda_bf16.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import restrict as R
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import tail as T

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16
CFGS = [SolverConfig(a=0.0, b=1.0, dtype=BF16),
        SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=BF16)]
SIZES = [4, 5, 8, 16, 33, 64, 128]


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


def _level(n, dtype, dev, rng):
    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    beta = [t(1.0 + 0.25 * rng.random(s)) for s in
            ((n + 1, n + 2, n + 2), (n + 2, n + 1, n + 2), (n + 2, n + 2, n + 1))]
    dinv = t((0.5 + rng.random((n, n, n))) / (8.0 * n * n))
    return Level(dim=n, h=1.0 / n, depth=0, beta_i=beta[0], beta_j=beta[1],
                 beta_k=beta[2], alpha=t(rng.random((n, n, n))), dinv=dinv,
                 kdinv=tuple(rb_mask(n, p, dtype, dev) * dinv for p in (0, 1)))


def _fields(rng, dev, dtype, *shape):
    return [torch.tensor(a, dtype=dtype, device=dev)
            for a in rng.standard_normal((2,) + shape)]


@pytest.mark.parametrize("n", SIZES)
def test_k1_and_k1s_bf16_match_plain(dev, n):
    rng = np.random.default_rng(n)
    lv = _level(n, BF16, dev, rng)
    x, rhs = _fields(rng, dev, BF16, n, n, n)
    for cfg in CFGS:
        cases = [("apply", {}, None), ("residual", {"rhs": rhs}, None)]
        cases += [("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}, p) for p in (0, 1)]
        if n % 2 == 0:
            cases.append(("fres", {"rhs": rhs}, None))
        for mode, kw, parity in cases:
            launches = S.fv4_stencil_cuda.bf16_launches
            out = S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity, **kw)
            assert out.dtype == BF16
            assert S.fv4_stencil_cuda.bf16_launches == launches + 1
            assert ulps(out, S.fv4_stencil_plain(lv, x, cfg, mode, **kw)) <= 1.0
            if mode == "gsrb":
                other = lv.kdinv[parity] == 0
                assert torch.equal(out[other], x[other])
            if mode != "fres":
                sub = S.fv4_subtile_cuda(lv, x, cfg, mode, parity=parity, **kw)
                assert torch.equal(sub, out)
                assert ulps(sub, S.fv4_subtile_plain(lv, x, cfg, mode, parity=parity,
                                                     **kw)) <= 1.0


@pytest.mark.parametrize("n", [4, 8, 16, 32, 48, 64])
def test_k2c_and_k3_bf16_match_plain(dev, n):
    rng = np.random.default_rng(100 + n)
    lv = _level(n, BF16, dev, rng)
    x, rhs = _fields(rng, dev, BF16, n, n, n)
    assert ulps(R.restrict_cell_cuda(x), R.restrict_cell_plain(x)) <= 1.0
    for cfg in CFGS:
        out = S.fv4_gsrb2_cluster_cuda(lv, x, rhs, cfg)
        assert out.dtype == BF16
        assert max_ulps(out, S.fv4_gsrb2_plain(lv, x, rhs, cfg)) <= 1.0


@pytest.mark.parametrize("dims", [(32, 16), (16,)])
def test_k4_bf16_matches_plain(dev, dims):
    rng = np.random.default_rng(sum(dims))
    for cfg in CFGS:
        tail = [_level(d, BF16, dev, rng) for d in dims]
        e, rhs = _fields(rng, dev, BF16, *tail[0].shape)
        es_k, rs_k = T.tail_down_cuda(tail, e, rhs, cfg, 6)
        es_p, rs_p = T.tail_down_plain(tail, e, rhs, cfg, 6)
        for a, b in zip(es_k + rs_k, es_p + rs_p):
            assert a.dtype == BF16 and max_ulps(a, b) <= 1.0
        d = dims[-1] // 2
        u_bot = torch.tensor(rng.standard_normal((d, d, d)), dtype=BF16, device=dev)
        rhss = [rhs] + rs_p[:-1]
        assert max_ulps(T.tail_up_cuda(tail, es_p, rhss, u_bot, cfg, 6),
                        T.tail_up_plain(tail, es_p, rhss, u_bot, cfg, 6)) <= 1.0


@pytest.mark.parametrize("n", [8, 33, 64, 128])
def test_k1_bf16c_gsrb_matches_plain(dev, n):
    rng = np.random.default_rng(200 + n)
    lv = _level(n, torch.float32, dev, rng)
    kb16 = S.kernel_views_bf16(lv, lv.kdinv)
    view = S.bf16c_view(dataclasses.replace(lv, kb16=kb16))
    x, rhs = _fields(rng, dev, torch.float32, n, n, n)
    for cfg in (SolverConfig(a=0.0, b=1.0), SolverConfig(a=1.5, b=1.0, helmholtz=True)):
        for p in (0, 1):
            launches = S.fv4_stencil_cuda.bf16c_launches
            out = S.fv4_stencil_cuda(view, x, cfg, "gsrb", rhs=rhs, kdinv=kb16[3 + p],
                                     parity=p)
            assert out.dtype == torch.float32
            assert S.fv4_stencil_cuda.bf16c_launches == launches + 1
            ref = S.fv4_stencil_plain(view, x, cfg, "gsrb", rhs=rhs, kdinv=kb16[3 + p])
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            assert err <= 1e-5, (n, p, err)


def test_entries_refuse_levels_below_4(dev):
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, BF16):
        lv = _level(2, dtype, dev, rng)
        x = torch.zeros((2, 2, 2), dtype=dtype, device=dev)
        cfg = SolverConfig(a=0.0, b=1.0, dtype=dtype)
        for launch in (lambda: S.fv4_stencil_cuda(lv, x, cfg, "apply"),
                       lambda: S.fv4_subtile_cuda(lv, x, cfg, "apply"),
                       lambda: S.fv4_gsrb2_cluster_cuda(lv, x, x, cfg)):
            with pytest.raises(ValueError, match="n >= 4"):
                launch()
