"""K1s (the one-pass sub-tiled fv4 stencil) of the PyTorch port on the CPU:

* its plain version, which CPU tensors take, against the JAX K1s
  (_fv4_kernel_subtile through _fv4_call_subtile, SUBTILE set) run by the
  Pallas interpreter at 48^3 with the tile forced to (24, 16) as
  tests/test_pallas_kernels.py does (2 i-tiles of 3 sub-tiles, 3 j-tiles),
  in float64, rel <= 1e-12 (max|port - jax| / max|jax|), in apply,
  residual and gsrb for both parities, with and without a*alpha*x;
* the fv4 suite's dispatch under ``stencils.SUBTILE``: applies, residuals
  and half-sweeps of the admitted levels go to K1s, the residual
  restriction runs unfused (K1s residual, then K3), K2's full sweeps and
  the K4 tail are unchanged, a periodic level never reaches K1s;
* a 32^3 float64 F-cycle with SUBTILE on (K1s on every level) equals the
  one with it off to 1e-12.

The CUDA kernel runs only on a card (tests/test_torch_cuda.py, chip_smoke.py).
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
from hpgmg_tpu_torch.bench.driver import build
from hpgmg_tpu_torch.core.config import BC, BottomSolver, SolverConfig
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.kernels import restrict as R
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import tail as T
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import fmg_solve, vcycle

N = 48
TOL = 1e-12


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def setup():
    """The JAX 48^3 fv4 level (random alpha) and the port's copy of it."""
    rng = np.random.default_rng(1048)
    alpha = 1.0 + rng.random((N, N, N))
    jcfg = JConfig(op="fv4", a=1.5, b=1.0, helmholtz=True, dtype=jnp.float64)
    jprob = jinit(N, dtype=jnp.float64)
    jlv = jbuild(jprob.beta_i, jprob.beta_j, jprob.beta_k, jcfg,
                 alpha=jnp.asarray(alpha)).levels[0]
    assert jlv.kbi is not None  # the kernel views K1s reads
    jlv = dataclasses.replace(jlv, kgd=None)  # no PREDIFF operands
    fields = {f: np.array(getattr(jlv, f)) for f in
              ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max")}
    cfg = SolverConfig(op="fv4", a=1.5, b=1.0, helmholtz=True, dtype=torch.float64)
    lv = hierarchy_from_numpy([{"dim": N, "h": jlv.h, "depth": 0, **fields}],
                              cfg, "cpu").levels[0]
    x, rhs = rng.standard_normal((2, N, N, N))
    return jcfg, jlv, cfg, lv, x, rhs


@pytest.mark.parametrize("helmholtz", [False, True])
@pytest.mark.parametrize("mode", ["apply", "residual", "gsrb0", "gsrb1"])
def test_k1s_plain_matches_interpreted_jax_k1s(setup, monkeypatch, mode, helmholtz):
    jcfg, jlv, cfg, lv, x, rhs = setup
    jcfg = dataclasses.replace(jcfg, helmholtz=helmholtz)
    cfg = dataclasses.replace(cfg, helmholtz=helmholtz)
    monkeypatch.setattr(JK, "INTERPRET", True)
    monkeypatch.setattr(JK, "SUBTILE", True)
    monkeypatch.setattr(JK, "tile_shape_subtile", lambda n, prediff=None, si=None: (24, 16))
    jx, jrhs = jnp.asarray(x), jnp.asarray(rhs)
    tx, trhs = torch.tensor(x), torch.tensor(rhs)
    calls = S.fv4_subtile_plain.calls
    if mode == "apply":
        want = JK.fv4_apply_pallas(jlv, jx, jcfg)
        out = S.fv4_subtile(lv, tx, cfg, "apply")
    elif mode == "residual":
        want = JK.fv4_residual_pallas(jlv, jx, jrhs, jcfg)
        out = S.fv4_subtile(lv, tx, cfg, "residual", rhs=trhs)
    else:
        p = int(mode[-1])
        want = JK.fv4_gsrb_sweep_pallas(jlv, jx, jrhs, jcfg, p)
        out = S.fv4_subtile(lv, tx, cfg, "gsrb", rhs=trhs, kdinv=lv.kdinv[p])
    assert S.fv4_subtile_plain.calls == calls + 1
    assert rel(out, want) <= TOL


def test_k1s_refuses_what_it_does_not_take(setup):
    _, _, cfg, lv, x, rhs = setup
    tx, trhs = torch.tensor(x), torch.tensor(rhs)
    with pytest.raises(ValueError, match="no mode 'fres'"):
        S.fv4_subtile(lv, tx, cfg, "fres", rhs=trhs)
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        S.fv4_subtile(lv, tx, dataclasses.replace(cfg, bc=BC.PERIODIC), "apply")
    with pytest.raises(ValueError, match="needs rhs"):
        S.fv4_subtile(lv, tx, cfg, "residual")
    with pytest.raises(ValueError, match="CUDA"):
        S.fv4_subtile_cuda(lv, tx, cfg, "apply")


def _calls():
    return {"k1s": S.fv4_subtile_plain.calls, "k1": S.fv4_stencil_plain.calls,
            "k2": S.fv4_gsrb2_plain.calls, "k3": R.restrict_cell_plain.calls,
            "tail": T.tail_down_plain.calls}  # K4a's, also inside K4c's


def _delta(before):
    return {k: v - before[k] for k, v in _calls().items()}


def test_dispatch_under_subtile(setup, monkeypatch):
    """The gate: admitted levels take K1s for apply, residual and
    half-sweeps, and restrict their residual as K1s + K3 (what K1's fres
    computes); above SUBTILE_MAX_DIM and with SUBTILE off, K1."""
    _, _, cfg, lv, x, rhs = setup
    op = get_suite("fv4")
    tx, trhs = torch.tensor(x), torch.tensor(rhs)
    fres = op.restrict_residual(lv, tx, trhs, cfg)  # SUBTILE off: K1's fres
    monkeypatch.setattr(S, "SUBTILE", True)
    monkeypatch.setattr(S, "SUBTILE_MAX_DIM", N)
    assert S.use_subtile(lv, cfg)
    before = _calls()
    op.apply_op(lv, tx, cfg)
    op.residual(lv, tx, trhs, cfg)
    op.gsrb_sweep(lv, tx, trhs, cfg, 1)
    unfused = op.restrict_residual(lv, tx, trhs, cfg)
    assert _delta(before) == {"k1s": 4, "k1": 0, "k2": 0, "k3": 1, "tail": 0}
    assert float((unfused - fres).abs().max() / fres.abs().max()) <= 1e-14
    monkeypatch.setattr(S, "SUBTILE_MAX_DIM", N - 1)  # above the gate: K1
    assert not S.use_subtile(lv, cfg)
    before = _calls()
    op.apply_op(lv, tx, cfg)
    op.restrict_residual(lv, tx, trhs, cfg)  # K1's fres (its plain version restricts)
    assert _delta(before) == {"k1s": 0, "k1": 2, "k2": 0, "k3": 1, "tail": 0}
    periodic = dataclasses.replace(cfg, bc=BC.PERIODIC)
    assert not S.use_subtile(lv, periodic)


def test_k2_and_tail_unchanged_under_subtile(monkeypatch):
    """A 32^3 fv4 V-cycle (GSRB, DIRECT bottom, ladder 32-16-8) with K1s
    admitted on every level: the tail (K4, its plain version here) takes the
    32-16 levels as before and K1s only the final residual; on a 16^3
    level K2's full sweeps still smooth."""
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    hier, f = build(32, cfg, torch.device("cpu"))
    op = get_suite("fv4")
    monkeypatch.setattr(S, "SUBTILE", True)
    monkeypatch.setattr(S, "SUBTILE_MAX_DIM", 32)
    before = _calls()
    u = vcycle(op, hier.levels, 0, torch.zeros_like(f), f, cfg)
    op.residual(hier.levels[0], u, f, cfg)
    d = _delta(before)
    assert d["tail"] == 1 and d["k1s"] == 1 and d["k2"] == 0  # K4's plain version runs K1's
    lv16 = hier.levels[1]
    before = _calls()
    op.gsrb_smooth(lv16, torch.zeros((16,) * 3, dtype=torch.float64),
                   torch.ones((16,) * 3, dtype=torch.float64), cfg, 6)
    # K2's plain version is two of K1's half-sweeps
    assert _delta(before) == {"k1s": 0, "k1": 6, "k2": 3, "k3": 0, "tail": 0}


def test_periodic_level_never_reaches_k1s(monkeypatch):
    """A periodic 16^3 fv4 F-cycle with SUBTILE on for every level: every stencil
    call is K7a's (K1's plain version here), none K1s's."""
    monkeypatch.setattr(S, "SUBTILE", True)
    monkeypatch.setattr(S, "SUBTILE_MAX_DIM", 32)
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, bc=BC.PERIODIC, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    hier, f = build(16, cfg, torch.device("cpu"))
    before = _calls()
    fmg_solve(get_suite("fv4"), hier, f, cfg)
    d = _delta(before)
    assert d["k1s"] == 0 and d["k1"] > 0


def test_subtile_fcycle_equals_k1_fcycle(monkeypatch):
    """32^3 f64 fv4 F-cycle (GSRB, DIRECT bottom, min_coarse_dim 8): K1s
    on every level (SUBTILE on) against K1 (off), u and rel_res to
    1e-12."""
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    op = get_suite("fv4")
    hier, f = build(32, cfg, torch.device("cpu"))
    u_off, nr_off, _ = fmg_solve(op, hier, f, cfg)
    monkeypatch.setattr(S, "SUBTILE", True)
    monkeypatch.setattr(S, "SUBTILE_MAX_DIM", 32)
    calls = S.fv4_subtile_plain.calls
    u_on, nr_on, _ = fmg_solve(op, hier, f, cfg)
    assert S.fv4_subtile_plain.calls > calls
    assert float((u_on - u_off).abs().max() / u_off.abs().max()) <= TOL
    assert abs(float(nr_on) - float(nr_off)) <= TOL * float(nr_off)


def test_profile_subtile_switch_restores_the_gate():
    from hpgmg_tpu_torch.bench import profile as bench_profile

    old = (S.SUBTILE, S.SUBTILE_MAX_DIM)
    with bench_profile.subtile(not old[0], 512):
        assert (S.SUBTILE, S.SUBTILE_MAX_DIM) == (not old[0], 512)
    assert (S.SUBTILE, S.SUBTILE_MAX_DIM) == old
