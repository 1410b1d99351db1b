"""K1 (the fv4 stencil) of the PyTorch port: its plain version, which CPU
tensors take, against the JAX package on the CPU at 48^3 (3x3 tiles of the
JAX kernel's 16-wide tiling, as tests/test_pallas_kernels.py uses) in
float64, rel <= 1e-12 (rel = max|port - jax| / max|jax|), for every mode:
apply, residual, gsrb for both parities, and fres. Two references: the
JAX XLA path (kernels="xla") and the JAX Pallas kernel run by the Pallas
interpreter (INTERPRET=True, kernels="pallas").

Both packages work on the same level: the JAX level carried across with
hpgmg_tpu_torch.interop. The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py and chip_smoke.py compare it with this plain
version there).
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
from hpgmg_tpu.ops.transfer import restrict_cell as jrestrict
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
    assert jlv.kbi is not None and jlv.kdinv is not None  # Pallas views
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64)
    fields = {f: np.array(getattr(jlv, f)) for f in
              ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max")}
    lv = hierarchy_from_numpy([{"dim": N, "h": jlv.h, "depth": 0, **fields,
                                "kdinv": tuple(np.array(k) for k in jlv.kdinv)}],
                              cfg, "cpu").levels[0]
    rng = np.random.default_rng(48)
    x, rhs = rng.standard_normal((2, N, N, N))
    return jcfg, jlv, cfg, lv, x, rhs


def _jax(ref: str, jcfg, jlv, mode, x, rhs):
    """The JAX result of ``mode`` through the XLA path or the interpreted
    Pallas kernel."""
    op = jsuite("fv4")
    x, rhs = jnp.asarray(x), jnp.asarray(rhs)
    if ref == "xla":
        xcfg = dataclasses.replace(jcfg, kernels="xla")
        ax = op.apply_op(jlv, x, xcfg)
        if mode == "apply":
            return ax
        if mode == "residual":
            return rhs - ax
        if mode == "fres":
            return jrestrict(rhs - ax)
        p = int(mode[-1])
        return x + jrb_mask(N, p, x.dtype) * jlv.dinv * (rhs - ax)
    pcfg = dataclasses.replace(jcfg, kernels="pallas")  # lift the 64^3 floor
    if mode == "apply":
        return JK.fv4_apply_pallas(jlv, x, pcfg)
    if mode == "residual":
        return JK.fv4_residual_pallas(jlv, x, rhs, pcfg)
    if mode == "fres":
        return JK.fv4_restrict_residual_pallas(jlv, x, rhs, pcfg)
    return JK.fv4_gsrb_sweep_pallas(jlv, x, rhs, pcfg, int(mode[-1]))


@pytest.mark.parametrize("ref", ["xla", "interpret"])
@pytest.mark.parametrize("mode", ["apply", "residual", "gsrb0", "gsrb1", "fres"])
def test_fv4_plain_matches_jax(setup, monkeypatch, mode, ref):
    jcfg, jlv, cfg, lv, x, rhs = setup
    monkeypatch.setattr(JK, "INTERPRET", ref == "interpret")
    want = _jax(ref, jcfg, jlv, mode, x, rhs)
    tx, trhs = torch.tensor(x), torch.tensor(rhs)
    if mode.startswith("gsrb"):
        out = S.fv4_stencil(lv, tx, cfg, "gsrb", rhs=trhs,
                            kdinv=lv.kdinv[int(mode[-1])])
    else:
        out = S.fv4_stencil(lv, tx, cfg, mode, rhs=None if mode == "apply" else trhs)
    assert tuple(out.shape) == want.shape
    assert rel(out, want) <= TOL


def test_suite_methods_route_through_k1(setup, monkeypatch):
    """FV4's apply/residual/gsrb_sweep/restrict_residual are K1's modes
    where the SUBTILE gate admits no level (K1s's routing:
    tests/test_torch_subtile.py), and a CPU tensor takes the plain
    version."""
    monkeypatch.setattr(S, "SUBTILE", False)
    _, _, cfg, lv, x, rhs = setup
    op = get_suite("fv4")
    tx, trhs = torch.tensor(x), torch.tensor(rhs)
    before = S.fv4_stencil_plain.calls
    ax = op.apply_op(lv, tx, cfg)
    assert torch.equal(op.residual(lv, tx, trhs, cfg), trhs - ax)
    for p in (0, 1):
        assert torch.equal(op.gsrb_sweep(lv, tx, trhs, cfg, p),
                           tx + lv.kdinv[p] * (trhs - ax))
    assert op.restrict_residual(lv, tx, trhs, cfg).shape == (N // 2,) * 3
    assert S.fv4_stencil_plain.calls == before + 5


def test_helmholtz_term_matches_jax():
    """The a*alpha*x term (K1's alpha operand) at 16^3 against the XLA path."""
    n = 16
    jcfg = JConfig(op="fv4", a=1.5, b=0.75, helmholtz=True, dtype=jnp.float64,
                   kernels="xla")
    rng = np.random.default_rng(16)
    alpha = 1.0 + rng.random((n, n, n))
    jprob = jinit(n, dtype=jnp.float64)
    jlv = jbuild(jprob.beta_i, jprob.beta_j, jprob.beta_k, jcfg,
                 alpha=jnp.asarray(alpha)).levels[0]
    cfg = SolverConfig(op="fv4", a=1.5, b=0.75, helmholtz=True, dtype=torch.float64)
    fields = {f: np.array(getattr(jlv, f)) for f in
              ("beta_i", "beta_j", "beta_k", "alpha", "dinv")}
    lv = hierarchy_from_numpy([{"dim": n, "h": jlv.h, "depth": 0, **fields}],
                              cfg, "cpu").levels[0]
    x = rng.standard_normal((n, n, n))
    want = jsuite("fv4").apply_op(jlv, jnp.asarray(x), jcfg)
    assert rel(S.fv4_stencil(lv, torch.tensor(x), cfg, "apply"), want) <= TOL


def test_wrapper_rejects_what_the_kernel_does_not_take(setup):
    _, _, cfg, lv, x, rhs = setup
    tx = torch.tensor(x)
    with pytest.raises(ValueError, match="needs rhs"):
        S.fv4_stencil(lv, tx, cfg, "residual")
    with pytest.raises(ValueError, match="needs kdinv"):
        S.fv4_stencil(lv, tx, cfg, "gsrb", rhs=tx)
    with pytest.raises(ValueError, match="mode"):
        S.fv4_stencil(lv, tx, cfg, "jacobi")
    with pytest.raises(TypeError):
        S.fv4_stencil(lv, tx.float(), cfg, "apply")
    with pytest.raises(ValueError, match="contiguous"):
        S.fv4_stencil(lv, tx.transpose(0, 2), cfg, "apply")
    with pytest.raises(ValueError, match="CUDA"):
        S.fv4_stencil_cuda(lv, tx, cfg, "apply")
