"""BF16C in the port: bfloat16 copies of the coefficient streams (the three
face arrays and the parity-folded kdinv pair) that K1's gsrb half-sweep
of a float32 solve reads, on the CPU.

The counterpart of tests/test_pallas_kernels.py:test_bf16c_gsrb_close_to_f32:
the port's BF16C half-sweep (its plain version: the bf16 coefficients
widened to float32, float32 arithmetic) against the JAX package's BF16C
kernel in the Pallas interpreter, on the JAX package's 64^3 level carried
across (so the bf16 copies are of the same float32 values), to 1e-5 of
max|out| (float32 summation order; measured 2.1e-7) at every cell but the
k = 0 and k = n-1 ones. Those read the k ghosts of beta_i and beta_j in
their mixed terms, which the JAX kernel's TPU layout drops from its views
and extrapolates in the kernel from the bf16 faces (quintic taps, whose
weights sum to 31 in magnitude, so the rounding grows), where the port
rounds the float32 extrapolation once; there the two are held to the JAX
test's 5e-3 (measured 1.86e-3). Both are held against the float32
half-sweep within 5e-3 of max|out| (bf16 coefficient rounding, the JAX
test's bound; measured 3.76e-3). Then the gate: kb16 is attached where ``stencils.bf16c_active``
says (flag on, float32, Dirichlet, dim >= BF16C_MIN_DIM, a level K1
smooths), slim_hierarchy drops the float32 kdinv pair it replaces, and a
hierarchy cut for a process grid drops kb16.
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
from hpgmg_tpu.problems.fv import init_problem_fv as jinit
from hpgmg_tpu_torch.core.config import BC, Smoother, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy, slim_hierarchy
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.kernels import counts
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.parallel import mesh as M
from hpgmg_tpu_torch.problems.fv import init_problem_fv

N = 64
FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max")
CFG = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float32)


@pytest.fixture
def bf16c(monkeypatch):
    """BF16C on from 64^3, K1 on every level (SUBTILE off), as the JAX
    test lowers BF16C_MIN_DIM for its 64^3 level."""
    monkeypatch.setattr(S, "BF16C", True)
    monkeypatch.setattr(S, "BF16C_MIN_DIM", N)
    monkeypatch.setattr(S, "SUBTILE", False)


@pytest.fixture(scope="module")
def jax_level():
    """The JAX package's 64^3 float32 level with its BF16C views, x and
    the rhs."""
    jcfg = JConfig(op="fv4", a=0.0, dtype=jnp.float32, kernels="pallas")
    prob = jinit(N, dtype=jnp.float32)
    # PREDIFF off: its BF16C views round the face arrays' tangential
    # differences to bf16, where K1 rounds the face arrays themselves
    old = JK.BF16C, JK.BF16C_MIN_DIM, JK.INTERPRET, JK.PREDIFF
    JK.BF16C, JK.BF16C_MIN_DIM, JK.INTERPRET, JK.PREDIFF = True, N, True, False
    try:
        jh = jbuild(prob.beta_i, prob.beta_j, prob.beta_k, jcfg)
    finally:
        JK.BF16C, JK.BF16C_MIN_DIM, JK.INTERPRET, JK.PREDIFF = old
    x = jnp.asarray(np.random.default_rng(5).standard_normal((N,) * 3).astype(np.float32))
    return jcfg, jh.levels[0], prob.f, x


def port_level(jl):
    """The JAX level's float32 fields as the port's level."""
    lv = {"dim": jl.dim, "h": jl.h, "depth": jl.depth,
          **{f: np.asarray(getattr(jl, f)) for f in FIELDS if getattr(jl, f) is not None},
          "kdinv": tuple(np.asarray(k) for k in jl.kdinv)}
    return hierarchy_from_numpy([lv], CFG, "cpu").levels[0]


@pytest.mark.parametrize("parity", [0, 1])
def test_bf16c_gsrb_matches_jax_interpret(jax_level, bf16c, monkeypatch, parity):
    jcfg, jl, f, x = jax_level
    assert jl.kb16 is not None and jl.kb16[0].dtype == jnp.bfloat16
    monkeypatch.setattr(JK, "INTERPRET", True)
    monkeypatch.setattr(JK, "PREDIFF", False)
    want = np.asarray(JK.fv4_gsrb_sweep_pallas(jl, x, f, jcfg, parity))
    ref32 = np.asarray(JK.fv4_gsrb_sweep_pallas(dataclasses.replace(jl, kb16=None),
                                                x, f, jcfg, parity))
    lv = port_level(jl)
    lv = dataclasses.replace(lv, kb16=S.kernel_views_bf16(lv, lv.kdinv))
    xp, fp = torch.tensor(np.asarray(x)), torch.tensor(np.asarray(f))
    counts.reset()
    got = get_suite("fv4").gsrb_sweep(lv, xp, fp, CFG, parity)
    assert counts.read()[1]["fv4_stencil_plain"] == 1
    assert got.dtype == torch.float32
    scale = np.max(np.abs(want))
    diff = np.abs(got.numpy() - want) / scale
    assert diff[:, :, 1:-1].max() <= 1e-5
    assert diff.max() <= 5e-3
    f32 = get_suite("fv4").gsrb_sweep(dataclasses.replace(lv, kb16=None), xp, fp, CFG,
                                      parity)
    assert np.max(np.abs(f32.numpy() - ref32)) / scale <= 1e-5
    err = np.max(np.abs(got.numpy() - f32.numpy())) / scale
    assert 0.0 < err <= 5e-3
    assert np.max(np.abs(want - ref32)) / scale <= 5e-3


def test_kb16_attached_where_the_gate_says(bf16c):
    prob = init_problem_fv(N, torch.float32, torch.device("cpu"))
    betas = (prob.beta_i, prob.beta_j, prob.beta_k)
    hier = build_hierarchy(*betas, CFG)
    assert [lv.dim for lv in hier.levels] == [64, 32, 16, 8, 4, 2]
    assert [lv.kb16 is not None for lv in hier.levels] == [True] + [False] * 5
    kb16 = hier.levels[0].kb16
    assert [t.dtype for t in kb16] == [torch.bfloat16] * 5
    assert torch.equal(kb16[3], hier.levels[0].kdinv[0].to(torch.bfloat16))
    assert S.bf16c_active(N, torch.float32)
    # off, float64, periodic, below the gate, or a level K1s smooths: none
    for ok in (S.bf16c_active(N, torch.float64), S.bf16c_active(N // 2, torch.float32),
               S.bf16c_active(N, torch.float32, BC.PERIODIC)):
        assert not ok
    S.SUBTILE = True
    assert not S.bf16c_active(N, torch.float32)
    S.SUBTILE = False
    # GSRB reads the bf16 kdinv: slim_hierarchy drops the float32 pair
    slim = slim_hierarchy(hier, CFG)
    assert slim.levels[0].kdinv is None and slim.levels[1].kdinv is not None
    cheb = dataclasses.replace(CFG, smoother=Smoother.CHEBYSHEV)
    assert slim_hierarchy(hier, cheb).levels[0].kdinv is not None
    S.BF16C = False
    assert all(lv.kb16 is None for lv in build_hierarchy(*betas, CFG).levels)


@pytest.mark.parametrize("rank", range(4))
def test_decomposed_levels_drop_kb16(bf16c, rank):
    """shard_hierarchy drops every level's BF16C views (one rank only, as
    hpgmg_tpu/parallel/mesh.py:214), so the cut levels' half-sweeps read
    the float32 kdinv; a slimmed BF16C hierarchy, which kept only the bf16
    kdinv, cannot be cut."""
    prob = init_problem_fv(N, torch.float32, torch.device("cpu"))
    hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, CFG)
    mesh = M.Mesh(shape=(2, 2, 1), rank=rank, backend="gloo", device=torch.device("cpu"))
    cut = M.shard_hierarchy(mesh, hier, CFG)
    assert cut.levels[0].part is not None and cut.levels[0].kdinv is not None
    assert all(lv.kb16 is None for lv in cut.levels)
    with pytest.raises(ValueError, match="BF16C"):
        M.shard_hierarchy(mesh, slim_hierarchy(hier, CFG), CFG)
