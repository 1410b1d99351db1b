"""K2 (the fused red+black GSRB sweep) of the PyTorch port: its plain
version, which CPU tensors take, against the JAX package on the CPU at 48^3
in float64 (3x3 tiles of the JAX kernel's tiling), rel <= 1e-12 (rel =
max|port - jax| / max|jax|): against fv4_gsrb2_pallas run by the Pallas
interpreter, and against two XLA half-sweeps. Also the suite's routing: a
smooth of an even number of half-sweeps is K2 launches, an odd one K1's.
The CUDA kernel runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

import hpgmg_tpu.kernels.stencils as JK
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.core.level import rb_mask as jrb_mask
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.problems.fv import init_problem_fv as jinit
from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.ops.base import get_suite

N = 48
TOL = 1e-12


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(op="fv4", a=0.0, b=1.0, dtype=jnp.float64)
    jprob = jinit(N, dtype=jnp.float64)
    jlv = jbuild(jprob.beta_i, jprob.beta_j, jprob.beta_k, jcfg,
                 alpha=jprob.alpha).levels[0]
    if jlv.k2 is None:  # the double-sweep ring operands
        jlv = dataclasses.replace(jlv, k2=JK.fv4_gsrb2_views(jlv.kdinv[0]))
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64)
    fields = {f: np.array(getattr(jlv, f)) for f in
              ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max")}
    lv = hierarchy_from_numpy([{"dim": N, "h": jlv.h, "depth": 0, **fields,
                                "kdinv": tuple(np.array(k) for k in jlv.kdinv)}],
                              cfg, "cpu").levels[0]
    rng = np.random.default_rng(482)
    x, rhs = rng.standard_normal((2, N, N, N))
    return jcfg, jlv, cfg, lv, x, rhs


def _two_half_sweeps_xla(jcfg, jlv, x, rhs):
    xcfg = dataclasses.replace(jcfg, kernels="xla")
    op = jsuite("fv4")
    for p in (0, 1):
        x = x + jrb_mask(N, p, x.dtype) * jlv.dinv * (rhs - op.apply_op(jlv, x, xcfg))
    return x


@pytest.mark.parametrize("ref", ["interpret", "xla"])
def test_gsrb2_plain_matches_jax(setup, monkeypatch, ref):
    jcfg, jlv, cfg, lv, x, rhs = setup
    jx, jrhs = jnp.asarray(x), jnp.asarray(rhs)
    if ref == "interpret":
        monkeypatch.setattr(JK, "INTERPRET", True)
        pcfg = dataclasses.replace(jcfg, kernels="pallas")
        want = JK.fv4_gsrb2_pallas(jlv, jx, JK.pad_rhs_gsrb2_fv4(jrhs), pcfg)
    else:
        want = _two_half_sweeps_xla(jcfg, jlv, jx, jrhs)
    calls = S.fv4_gsrb2_plain.calls
    out = S.fv4_gsrb2(lv, torch.tensor(x), torch.tensor(rhs), cfg)
    assert S.fv4_gsrb2_plain.calls == calls + 1
    assert tuple(out.shape) == want.shape
    assert rel(out, want) <= TOL


@pytest.mark.parametrize("nsweeps", [4, 3])
def test_smooth_routes_pairs_through_k2(setup, monkeypatch, nsweeps):
    """On a level up to GSRB2_MAX_DIM an even half-sweep count is K2 pairs
    (nsweeps/2 launches), an odd one K1 half-sweeps; above it (or with K2
    off) K1 half-sweeps; both schedules give the same iterate."""
    assert N <= S.GSRB2_MAX_DIM
    _, _, cfg, lv, x, rhs = setup
    op = get_suite("fv4")
    tx, trhs = torch.tensor(x), torch.tensor(rhs)
    k2, k1 = S.fv4_gsrb2_plain.calls, S.fv4_stencil_plain.calls
    fused = op.gsrb_smooth(lv, tx, trhs, cfg, nsweeps)
    assert S.fv4_gsrb2_plain.calls - k2 == (nsweeps // 2 if nsweeps % 2 == 0 else 0)
    assert S.fv4_stencil_plain.calls - k1 == nsweeps
    monkeypatch.setattr(S, "GSRB2_MAX_DIM", 0)
    k2 = S.fv4_gsrb2_plain.calls
    half = op.gsrb_smooth(lv, tx, trhs, cfg, nsweeps)
    assert S.fv4_gsrb2_plain.calls == k2
    assert torch.equal(fused, half)


def test_gsrb2_rejects_what_the_kernel_does_not_take(setup):
    _, _, cfg, lv, x, rhs = setup
    tx = torch.tensor(x)
    with pytest.raises(ValueError, match="needs rhs"):
        S.fv4_gsrb2(lv, tx, None, cfg)
    with pytest.raises(ValueError, match=r"kdinv\[0\]"):
        S.fv4_gsrb2(dataclasses.replace(lv, kdinv=None), tx, tx, cfg)
    with pytest.raises(TypeError):
        S.fv4_gsrb2(lv, tx.float(), torch.tensor(rhs).float(), cfg)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_smooth_takes_k2_on_exactly_the_levels_the_gate_admits(monkeypatch, dtype):
    """On each level of a 32^3 ladder the smoother's 6 half-sweeps are 3
    full sweeps (K2c on the card, counted here by their plain version) on
    exactly the Dirichlet levels with dim <= GSRB2_MAX_DIM; the other
    levels take K1 half-sweeps."""
    from hpgmg_tpu_torch.bench.driver import build

    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=dtype, min_coarse_dim=4)
    hier, f = build(32, cfg, torch.device("cpu"))[:2]
    op = get_suite("fv4")
    for top in (S.GSRB2_MAX_DIM, 0, 8, 16):
        monkeypatch.setattr(S, "GSRB2_MAX_DIM", top)
        for lv in hier.levels:
            x = torch.zeros(lv.shape, dtype=dtype)
            rhs = torch.ones(lv.shape, dtype=dtype)
            k2, k1 = S.fv4_gsrb2_plain.calls, S.fv4_stencil_plain.calls
            op.gsrb_smooth(lv, x, rhs, cfg, 6)
            assert S.fv4_gsrb2_plain.calls - k2 == (3 if lv.dim <= top else 0), (lv.dim, top)
            assert S.fv4_stencil_plain.calls - k1 == 6, lv.dim
