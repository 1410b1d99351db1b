"""K7a, K7b and K4c of the PyTorch port: their plain versions, which CPU
tensors take, against the JAX package on the CPU at 32^3 in float64, every
cell compared, rel <= 1e-12 (rel = max|port - jax| / max|jax|).

* K7a (the fv4 stencil on a periodic level): every mode (apply, residual,
  gsrb for both parities, fres) against the JAX XLA path and against the
  JAX Pallas kernel's ext mode (fv4_call_ext, reached through
  fv4_*_pallas with bc=PERIODIC) run by the Pallas interpreter; fres
  against the interpreter's residual followed by restrict_cell (the JAX
  package fuses no periodic residual restriction).
* K7b (the radius-1 stencil on a periodic level): every mode, each body and
  tap set, against the XLA path and r1_call_ext (through _r1_call with
  bc=PERIODIC) in the interpreter.
* K4c (the one-launch tail V-cycle): against tail_v_call in the interpreter
  on the 32-16 fv4 Dirichlet ladder over its 8^3 DIRECT bottom, and against
  the port's own K4a + matvec + K4b plain path.

Both packages read the same levels. The CUDA kernels run only on a card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

import hpgmg_tpu.kernels.stencils as JK
import hpgmg_tpu.kernels.stencils_r1 as JK1
import hpgmg_tpu.kernels.tail as JT
from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.core.level import Level as JLevel
from hpgmg_tpu.core.level import rb_mask as jrb_mask
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.ops.transfer import restrict_cell as jrestrict
from hpgmg_tpu.problems.fv import init_problem_fv as jinit
from hpgmg_tpu_torch.core.config import BC, BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import stencils_r1 as K
from hpgmg_tpu_torch.kernels import tail as T
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import vcycle

N = 32
TOL = 1e-12
MODES = ["apply", "residual", "gsrb0", "gsrb1", "fres"]
FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max",
          "bottom_ainv")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def _port_levels(jlevels, cfg):
    return hierarchy_from_numpy(
        [{"dim": lv.dim, "h": lv.h, "depth": lv.depth,
          **{f: np.array(getattr(lv, f)) for f in FIELDS
             if getattr(lv, f, None) is not None},
          "kdinv": (None if lv.kdinv is None
                    else tuple(np.array(k) for k in lv.kdinv))}
         for lv in jlevels], cfg, "cpu").levels


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JK, "INTERPRET", True)


# ---------------------------------------------------------------------------
# K7a
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fv4_periodic():
    """The finest level of the periodic fv problem at 32^3 (betas wrapped
    tangentially, the TPU kernel views attached) in both packages."""
    jcfg = JConfig(op="fv4", a=0.0, b=1.0, bc=JBC.PERIODIC, dtype=jnp.float64)
    jprob = jinit(N, dtype=jnp.float64, periodic=True)
    jlv = jbuild(jprob.beta_i, jprob.beta_j, jprob.beta_k, jcfg,
                 alpha=jprob.alpha).levels[0]
    assert jlv.kbi is not None and jlv.kdinv is not None  # Pallas views
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, bc=BC.PERIODIC, dtype=torch.float64)
    lv = _port_levels([jlv], cfg)[0]
    x, rhs = np.random.default_rng(33).standard_normal((2, N, N, N))
    return jcfg, jlv, cfg, lv, x, rhs


def _fv4_jax(ref, jcfg, jlv, mode, x, rhs):
    op = jsuite("fv4")
    x, rhs = jnp.asarray(x), jnp.asarray(rhs)
    if ref == "xla":
        ax = op.apply_op(jlv, x, dataclasses.replace(jcfg, kernels="xla"))
        if mode == "apply":
            return ax
        if mode == "residual":
            return rhs - ax
        if mode == "fres":
            return jrestrict(rhs - ax)
        return x + jrb_mask(N, int(mode[-1]), x.dtype) * jlv.dinv * (rhs - ax)
    pcfg = dataclasses.replace(jcfg, kernels="pallas")
    if mode == "apply":
        return JK.fv4_apply_pallas(jlv, x, pcfg)
    if mode == "residual":
        return JK.fv4_residual_pallas(jlv, x, rhs, pcfg)
    if mode == "fres":
        return jrestrict(JK.fv4_residual_pallas(jlv, x, rhs, pcfg))
    return JK.fv4_gsrb_sweep_pallas(jlv, x, rhs, pcfg, int(mode[-1]))


@pytest.mark.parametrize("ref", ["xla", "interpret"])
@pytest.mark.parametrize("mode", MODES)
def test_k7a_plain_matches_jax(fv4_periodic, monkeypatch, mode, ref):
    jcfg, jlv, cfg, lv, x, rhs = fv4_periodic
    monkeypatch.setattr(JK, "INTERPRET", ref == "interpret")
    want = _fv4_jax(ref, jcfg, jlv, mode, x, rhs)
    tx, trhs = torch.tensor(x), torch.tensor(rhs)
    if mode.startswith("gsrb"):
        out = S.fv4_stencil(lv, tx, cfg, "gsrb", rhs=trhs, kdinv=lv.kdinv[int(mode[-1])])
    else:
        out = S.fv4_stencil(lv, tx, cfg, mode, rhs=None if mode == "apply" else trhs)
    assert tuple(out.shape) == want.shape
    assert rel(out, want) <= TOL


def test_k7a_constants_are_its_null_space(fv4_periodic):
    """The periodic pure-Poisson operator maps a constant to zero: the
    constants are its null space."""
    _, _, cfg, lv, x, _ = fv4_periodic
    ones = torch.ones((N, N, N), dtype=torch.float64)
    ax = S.fv4_stencil(lv, 3.0 * ones, cfg, "apply")
    assert float(ax.abs().max()) <= 1e-9 * lv.h2inv


def test_fv4_smoother_takes_no_k2_on_periodic_levels(fv4_periodic, monkeypatch):
    """FV4.gsrb_smooth gives a periodic level K7a half-sweeps, never K2,
    whatever the K2 gate; the K2 wrappers refuse the level."""
    _, _, cfg, lv, x, rhs = fv4_periodic
    monkeypatch.setattr(S, "GSRB2_MAX_DIM", 1 << 20)
    tx, trhs = torch.tensor(x), torch.tensor(rhs)
    calls = (S.fv4_gsrb2_plain.calls, S.fv4_stencil_plain.calls)
    out = get_suite("fv4").gsrb_smooth(lv, tx, trhs, cfg, 6)
    assert (S.fv4_gsrb2_plain.calls, S.fv4_stencil_plain.calls) == (calls[0],
                                                                    calls[1] + 6)
    halves = tx
    for s in range(6):
        halves = S.fv4_stencil_plain(lv, halves, cfg, "gsrb", rhs=trhs,
                                     kdinv=lv.kdinv[s & 1])
    assert torch.equal(out, halves)
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        S.fv4_gsrb2(lv, tx, trhs, cfg)
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        S.fv4_gsrb2_cuda(lv, tx, trhs, cfg)


# ---------------------------------------------------------------------------
# K7b
# ---------------------------------------------------------------------------

# (suite, taps, var7, helmholtz): fv7pt, fv2, fv7pt with a*alpha*x, 27pt
# without and with its constant a*x
R1_BODIES = [("fv7pt", "p1", True, False), ("fv2", "v2", True, False),
             ("fv7pt", "p1", True, True), ("27pt", "27pt", False, False),
             ("27pt", "27pt", False, True)]


@pytest.fixture(scope="module")
def r1_data():
    rng = np.random.default_rng(31)
    b = [1.0 + 0.25 * rng.random(s) for s in
         ((N + 1, N, N), (N, N + 1, N), (N, N, N + 1))]
    alpha = 0.5 + rng.random((N, N, N))
    dinv = (0.5 + rng.random((N, N, N))) / (8.0 * N * N)
    x, rhs = rng.standard_normal((2, N, N, N))
    return b, alpha, dinv, x, rhs


def _r1_levels(data, var7, helmholtz):
    """The JAX level with its TPU kernel views and the port's level, from
    the same arrays."""
    b, alpha, dinv, _, _ = data
    jb = [jnp.asarray(a) for a in b]
    jalpha = jnp.asarray(alpha) if helmholtz else None
    jd = jnp.asarray(dinv)
    kw = dict(kernel_suite="var7" if var7 else "27pt",
              kdinv=tuple(jrb_mask(N, p, jnp.float64) * jd for p in (0, 1)))
    if var7:
        kw.update(zip(("kbi", "kbj", "kbk", "kbk_top"), JK1.r1_beta_views(*jb)))
    jlv = JLevel(dim=N, h=1.0 / N, depth=0, beta_i=jb[0], beta_j=jb[1], beta_k=jb[2],
                 alpha=jalpha, dinv=jd, **kw)
    d = torch.tensor(dinv)
    lv = Level(dim=N, h=1.0 / N, depth=0, beta_i=torch.tensor(b[0]),
               beta_j=torch.tensor(b[1]), beta_k=torch.tensor(b[2]),
               alpha=torch.tensor(alpha) if helmholtz else None, dinv=d,
               kdinv=tuple(rb_mask(N, p, torch.float64, torch.device("cpu")) * d
                           for p in (0, 1)))
    return jlv, lv


def _r1_jax(ref, op, jlv, jcfg, taps, mode, x, rhs):
    x, rhs = jnp.asarray(x), jnp.asarray(rhs)
    if ref == "xla":
        ax = jsuite(op).apply_op(jlv, x, dataclasses.replace(jcfg, kernels="xla"))
        if mode == "apply":
            return ax
        if mode == "residual":
            return rhs - ax
        if mode == "fres":
            return jrestrict(rhs - ax)
        return x + jlv.kdinv[int(mode[-1])] * (rhs - ax)
    if mode == "apply":
        return JK1.r1_apply_pallas(jlv, x, jcfg, taps)
    if mode == "residual":
        return JK1.r1_residual_pallas(jlv, x, rhs, jcfg, taps)
    if mode == "fres":
        return jrestrict(JK1.r1_residual_pallas(jlv, x, rhs, jcfg, taps))
    return JK1.r1_gsrb_sweep_pallas(jlv, x, rhs, jcfg, int(mode[-1]), taps)


@pytest.mark.parametrize("ref", ["xla", "interpret"])
@pytest.mark.parametrize("op,taps,var7,helmholtz", R1_BODIES)
def test_k7b_plain_matches_jax(r1_data, monkeypatch, ref, op, taps, var7, helmholtz):
    monkeypatch.setattr(JK, "INTERPRET", ref == "interpret")
    kw = dict(op=op, b=1.0, a=1.5 if helmholtz else 0.0, helmholtz=helmholtz)
    jcfg = JConfig(dtype=jnp.float64, kernels="pallas", bc=JBC.PERIODIC, **kw)
    cfg = SolverConfig(dtype=torch.float64, bc=BC.PERIODIC, **kw)
    jlv, lv = _r1_levels(r1_data, var7, helmholtz)
    x, rhs = r1_data[3:]
    tx, trhs = torch.tensor(x), torch.tensor(rhs)
    for mode in MODES:
        want = _r1_jax(ref, op, jlv, jcfg, taps, mode, x, rhs)
        if mode.startswith("gsrb"):
            out = K.r1_stencil(lv, tx, cfg, "gsrb", taps, var7, rhs=trhs,
                               kdinv=lv.kdinv[int(mode[-1])], parity=int(mode[-1]))
        else:
            out = K.r1_stencil(lv, tx, cfg, mode, taps, var7,
                               rhs=None if mode == "apply" else trhs)
        assert tuple(out.shape) == want.shape, mode
        assert rel(out, want) <= TOL, mode


@pytest.mark.parametrize("op", ["fv7pt", "fv2", "27pt"])
def test_r1_smoother_takes_no_k6_on_periodic_levels(r1_data, op):
    """RadiusOneSuite.gsrb_smooth gives a periodic level K7b half-sweeps,
    never K6 (use_gsrb2 is False under periodic BCs); K6 refuses it."""
    suite = get_suite(op)
    _, lv = _r1_levels(r1_data, suite.var7, False)
    tx, trhs = (torch.tensor(a) for a in r1_data[3:])
    cfg = SolverConfig(op=op, a=0.0, bc=BC.PERIODIC, dtype=torch.float64)
    assert K.use_gsrb2(N, suite.var7, BC.DIRICHLET) == suite.var7
    assert not K.use_gsrb2(N, suite.var7, BC.PERIODIC)
    calls = (K.r1_gsrb2_plain.calls, K.r1_stencil_plain.calls)
    suite.gsrb_smooth(lv, tx, trhs, cfg, 4)
    assert (K.r1_gsrb2_plain.calls, K.r1_stencil_plain.calls) == (calls[0], calls[1] + 4)
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        K.r1_gsrb2(lv, tx, trhs, cfg, suite.taps_key, suite.var7)


# ---------------------------------------------------------------------------
# K4c
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ladder():
    """The fv4 Dirichlet hierarchy 32-16-8 (DIRECT bottom) in both
    packages, a random starting iterate and the problem's rhs."""
    jcfg = JConfig(op="fv4", a=0.0, b=1.0, dtype=jnp.float64,
                   bottom=JBottom.DIRECT, min_coarse_dim=8)
    jprob = jinit(N, dtype=jnp.float64)
    jh = jbuild(jprob.beta_i, jprob.beta_j, jprob.beta_k, jcfg, alpha=jprob.alpha)
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    e0 = np.random.default_rng(34).standard_normal((N, N, N))
    return jcfg, jh, jprob.f, cfg, _port_levels(jh.levels, cfg), e0


def test_k4c_plain_matches_tail_v_call(ladder, interpret):
    jcfg, jh, jf, cfg, levels, e0 = ladder
    want = JT.tail_v_call(jh.levels[:2], jh.levels[2], jnp.asarray(e0), jf, jcfg)
    calls = T.tail_v_plain.calls
    got = T.tail_v(levels[:2], levels[2], torch.tensor(e0),
                   torch.tensor(np.array(jf)), cfg, 6)
    assert T.tail_v_plain.calls == calls + 1
    assert tuple(got.shape) == want.shape
    assert rel(got, want) <= TOL


def test_k4c_plain_equals_down_matvec_up(ladder):
    """K4c's plain version is K4a's plain descent, the DIRECT matvec on the
    bottom and K4b's plain climb, to the last bit."""
    _, _, jf, cfg, levels, e0 = ladder
    e, rhs = torch.tensor(e0), torch.tensor(np.array(jf))
    es, rhss = T.tail_down_plain(levels[:2], e, rhs, cfg, 6)
    u = (levels[2].bottom_ainv @ rhss[-1].reshape(-1)).reshape(levels[2].shape)
    three = T.tail_up_plain(levels[:2], es, [rhs] + rhss[:-1], u, cfg, 6)
    assert torch.equal(T.tail_v(levels[:2], levels[2], e, rhs, cfg, 6), three)


@pytest.mark.parametrize("root", [0, 1])
def test_vcycle_one_launch_matches_jax(ladder, interpret, monkeypatch, root):
    """With TAIL_ONE_LAUNCH the port's V-cycle from a tail root (32^3: span
    32-16; 16^3: span 16) is one K4c call, against the JAX package's
    tail_vcycle with its TAIL_ONE_LAUNCH; and it equals the three-part
    V-cycle of the default off setting."""
    jcfg, jh, jf, cfg, levels, e0 = ladder
    monkeypatch.setattr(JT, "TAIL_FUSE", True)
    monkeypatch.setattr(JT, "TAIL_ONE_LAUNCH", True)
    rng = np.random.default_rng(35 + root)
    e = rng.standard_normal(levels[root].shape)
    rhs = rng.standard_normal(levels[root].shape)
    want = JT.tail_vcycle(jsuite("fv4"), jh.levels, root, jnp.asarray(e),
                          jnp.asarray(rhs), jcfg)
    args = (get_suite("fv4"), levels, root, torch.tensor(e), torch.tensor(rhs), cfg)
    monkeypatch.setattr(T, "TAIL_ONE_LAUNCH", True)
    calls = T.tail_v_plain.calls
    one = vcycle(*args)
    assert T.tail_v_plain.calls == calls + 1
    assert rel(one, want) <= TOL
    monkeypatch.setattr(T, "TAIL_ONE_LAUNCH", False)
    assert rel(one, vcycle(*args).numpy()) <= 1e-13


def test_k4c_wrappers_refuse(ladder):
    _, _, jf, cfg, levels, e0 = ladder
    e, rhs = torch.tensor(e0), torch.tensor(np.array(jf))
    with pytest.raises(ValueError, match="bottom_ainv"):
        T.tail_v(levels[:2], dataclasses.replace(levels[2], bottom_ainv=None), e, rhs,
                 cfg, 6)
    with pytest.raises(ValueError, match="bottom"):
        T.tail_v(levels[:1], levels[2], e, rhs, cfg, 6)  # 8^3 is not below 32^3
    with pytest.raises(ValueError, match="CUDA"):
        T.tail_v_cuda(levels[:2], levels[2], e, rhs, cfg, 6)
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        T.tail_v(levels[:2], levels[2], e, rhs,
                 dataclasses.replace(cfg, bc=BC.PERIODIC), 6)
