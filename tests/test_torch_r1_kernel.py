"""K5 and K6 (the radius-1 stencil and the fused red+black sweep) of the
PyTorch port: their plain versions, which CPU tensors take, against the JAX
package's Pallas kernels run by the Pallas interpreter
(stencils.INTERPRET=True) at 32^3, the smallest level the JAX kernels take,
in float64, every cell compared (boundary cells included), rel <= 1e-12
(rel = max|port - jax| / max|jax|).

K5: every mode (apply, residual, gsrb for both parities, fres) for the var7
body with the fv7pt (p1) and fv2 (v2) ghost taps, with and without the
a*alpha*x term, and for the 27pt body with and without its constant a*x.
K6: one full sweep for the same bodies against r1_gsrb2_pallas, and
against two K5 half-sweeps; at n = 9, which r1_gsrb2_pallas does not take
(its tile_shape_gsrb2 finds no tiling of an odd n or of n < 32), against
the JAX XLA red-then-black pair that kernel fuses. Both packages read the
same random level. The
CUDA kernels run only on a card (tests/test_torch_cuda.py,
tests/test_torch_cuda_r1_stream.py, chip_smoke.py). Also: a half-sweep
takes the sweep's parity (the plain version checks it, the suite passes
it, the entry refuses a gsrb without it).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

import hpgmg_tpu.kernels.stencils as JK
import hpgmg_tpu.kernels.stencils_r1 as JK1
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.level import Level as JLevel
from hpgmg_tpu.core.level import rb_mask as jrb_mask
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils_r1 as K
from hpgmg_tpu_torch.ops.base import get_suite

N = 32
TOL = 1e-12
# (taps, var7, helmholtz): fv7pt, fv2, fv7pt with a*alpha*x, 27pt without
# and with its constant a*x
BODIES = [("p1", True, False), ("v2", True, False), ("p1", True, True),
          ("27pt", False, False), ("27pt", False, True)]
MODES = ["apply", "residual", "gsrb0", "gsrb1", "fres"]


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def data():
    """One random level (positive face arrays, alpha, a parity-folded
    diagonal of the operator's scale) and random x, rhs, as numpy."""
    rng = np.random.default_rng(32)
    b = [1.0 + 0.25 * rng.random(s) for s in
         ((N + 1, N, N), (N, N + 1, N), (N, N, N + 1))]
    alpha = 0.5 + rng.random((N, N, N))
    dinv = (0.5 + rng.random((N, N, N))) / (8.0 * N * N)
    x, rhs = rng.standard_normal((2, N, N, N))
    return b, alpha, dinv, x, rhs


def _cfgs(taps, helmholtz):
    kw = dict(op="27pt" if taps == "27pt" else "fv7pt", b=1.0,
              a=1.5 if helmholtz else 0.0, helmholtz=helmholtz)
    return (JConfig(dtype=jnp.float64, kernels="pallas", **kw),
            SolverConfig(dtype=torch.float64, **kw))


def _jax_level(data, var7, helmholtz):
    """The JAX level with its TPU kernel views (kbi.., k2) built from the
    same arrays."""
    b, alpha, dinv, _, _ = data
    jb = [jnp.asarray(a) for a in b]
    jalpha = jnp.asarray(alpha) if helmholtz else None
    jd = jnp.asarray(dinv)
    kdinv = tuple(jrb_mask(N, p, jnp.float64) * jd for p in (0, 1))
    kw = dict(kernel_suite="var7" if var7 else "27pt", kdinv=kdinv,
              k2=JK1.r1_gsrb2_views(jb[0] if var7 else None, jb[1], jb[2],
                                    kdinv[0], jalpha if var7 else None))
    if var7:
        kw.update(zip(("kbi", "kbj", "kbk", "kbk_top"), JK1.r1_beta_views(*jb)))
    return JLevel(dim=N, h=1.0 / N, depth=0, beta_i=jb[0], beta_j=jb[1],
                  beta_k=jb[2], alpha=jalpha, dinv=jd, **kw)


def _port_level(data, helmholtz):
    b, alpha, dinv, _, _ = data
    d = torch.tensor(dinv)
    return Level(dim=N, h=1.0 / N, depth=0, beta_i=torch.tensor(b[0]),
                 beta_j=torch.tensor(b[1]), beta_k=torch.tensor(b[2]),
                 alpha=torch.tensor(alpha) if helmholtz else None, dinv=d,
                 kdinv=tuple(rb_mask(N, p, torch.float64, torch.device("cpu")) * d
                             for p in (0, 1)))


@pytest.fixture
def interpret():
    JK.INTERPRET = True
    yield
    JK.INTERPRET = False


@pytest.mark.parametrize("taps,var7,helmholtz", BODIES)
def test_k5_plain_matches_pallas(data, interpret, taps, var7, helmholtz):
    jcfg, cfg = _cfgs(taps, helmholtz)
    jlv, lv = _jax_level(data, var7, helmholtz), _port_level(data, helmholtz)
    x, rhs = (torch.tensor(a) for a in data[3:])
    jx, jrhs = (jnp.asarray(a) for a in data[3:])
    for mode in MODES:
        if mode == "apply":
            ref = JK1.r1_apply_pallas(jlv, jx, jcfg, taps)
            out = K.r1_stencil(lv, x, cfg, "apply", taps, var7)
        elif mode == "residual":
            ref = JK1.r1_residual_pallas(jlv, jx, jrhs, jcfg, taps)
            out = K.r1_stencil(lv, x, cfg, "residual", taps, var7, rhs=rhs)
        elif mode == "fres":
            ref = JK1.r1_restrict_residual_pallas(jlv, jx, jrhs, jcfg, taps)
            out = K.r1_stencil(lv, x, cfg, "fres", taps, var7, rhs=rhs)
        else:
            p = int(mode[-1])
            ref = JK1.r1_gsrb_sweep_pallas(jlv, jx, jrhs, jcfg, p, taps)
            out = K.r1_stencil(lv, x, cfg, "gsrb", taps, var7, rhs=rhs,
                               kdinv=lv.kdinv[p], parity=p)
        assert out.shape == ref.shape, mode
        assert rel(out, ref) <= TOL, mode


@pytest.mark.parametrize("taps,var7,helmholtz", BODIES)
def test_k6_plain_matches_pallas_and_two_half_sweeps(data, interpret, taps, var7,
                                                     helmholtz):
    jcfg, cfg = _cfgs(taps, helmholtz)
    jlv, lv = _jax_level(data, var7, helmholtz), _port_level(data, helmholtz)
    x, rhs = (torch.tensor(a) for a in data[3:])
    jx, jrhs = (jnp.asarray(a) for a in data[3:])
    calls = K.r1_gsrb2_plain.calls
    out = K.r1_gsrb2(lv, x, rhs, cfg, taps, var7)
    assert K.r1_gsrb2_plain.calls == calls + 1
    ref = JK1.r1_gsrb2_pallas(jlv, jx, JK1.pad_rhs_gsrb2(jrhs), jcfg, taps)
    assert rel(out, ref) <= TOL
    halves = x
    for p in (0, 1):
        halves = K.r1_stencil_plain(lv, halves, cfg, "gsrb", taps, var7, rhs=rhs,
                                    kdinv=lv.kdinv[p], parity=p)
    assert torch.equal(out, halves)


@pytest.mark.parametrize("taps,var7,helmholtz", BODIES)
def test_k6_plain_at_odd_n_matches_xla_pair(taps, var7, helmholtz):
    """n = 9: the last cell pair along each axis straddles the face."""
    n = 9
    rng = np.random.default_rng(9)
    b = [1.0 + 0.25 * rng.random(s) for s in ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1))]
    alpha = 0.5 + rng.random((n, n, n))
    dinv = (0.5 + rng.random((n, n, n))) / (8.0 * n * n)
    x, rhs = rng.standard_normal((2, n, n, n))
    op = {"p1": "fv7pt", "v2": "fv2", "27pt": "27pt"}[taps]
    kw = dict(op=op, b=1.0, a=1.5 if helmholtz else 0.0, helmholtz=helmholtz)
    jcfg = JConfig(dtype=jnp.float64, kernels="xla", **kw)
    jd = jnp.asarray(dinv)
    jlv = JLevel(dim=n, h=1.0 / n, depth=0, beta_i=jnp.asarray(b[0]),
                 beta_j=jnp.asarray(b[1]), beta_k=jnp.asarray(b[2]),
                 alpha=jnp.asarray(alpha) if helmholtz else None, dinv=jd,
                 kdinv=tuple(jrb_mask(n, p, jnp.float64) * jd for p in (0, 1)))
    ref = jnp.asarray(x)
    for p in (0, 1):
        ref = ref + jlv.kdinv[p] * (jnp.asarray(rhs) - jsuite(op).apply_op(jlv, ref, jcfg))
    d = torch.tensor(dinv)
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=torch.tensor(b[0]),
               beta_j=torch.tensor(b[1]), beta_k=torch.tensor(b[2]),
               alpha=torch.tensor(alpha) if helmholtz else None, dinv=d,
               kdinv=tuple(rb_mask(n, p, torch.float64, torch.device("cpu")) * d
                           for p in (0, 1)))
    out = K.r1_gsrb2(lv, torch.tensor(x), torch.tensor(rhs),
                     SolverConfig(dtype=torch.float64, **kw), taps, var7)
    assert rel(out, ref) <= TOL


def test_dispatch_and_checks(data):
    """CPU tensors take the plain versions; the CUDA wrappers refuse CPU
    tensors; what the kernels do not take raises."""
    lv = _port_level(data, False)
    x = torch.tensor(data[3])
    cfg = SolverConfig(op="fv7pt", a=0.0, dtype=torch.float64)
    calls = K.r1_stencil_plain.calls
    K.r1_stencil(lv, x, cfg, "apply", "p1", True)
    assert K.r1_stencil_plain.calls == calls + 1
    with pytest.raises(ValueError, match="CUDA"):
        K.r1_stencil_cuda(lv, x, cfg, "apply", "p1", True)
    with pytest.raises(ValueError, match="CUDA"):
        K.r1_gsrb2_cuda(lv, x, x, cfg, "p1", True)
    with pytest.raises(ValueError, match="chunk"):  # checked before the build
        K._sweep_entry("hpgmg_r1_gsrb2", x, -1)
    with pytest.raises(ValueError, match="no kernel"):
        K.r1_stencil(lv, x.to("meta"), cfg, "apply", "p1", True)
    with pytest.raises(NotImplementedError):  # K6 fuses no periodic sweep
        K.r1_gsrb2(lv, x, x, dataclasses.replace(cfg, bc=BC.PERIODIC), "p1", True)
    with pytest.raises(ValueError, match="needs rhs"):
        K.r1_stencil(lv, x, cfg, "residual", "p1", True)
    with pytest.raises(ValueError, match="shape"):
        K.r1_stencil(lv, x[:-1], cfg, "apply", "p1", True)
    with pytest.raises(ValueError, match="taps"):
        K.r1_stencil(lv, x, cfg, "apply", "p3", True)
    # the 27pt body reads no face arrays
    K.r1_stencil(dataclasses.replace(lv, beta_i=lv.beta_i[:1]), x, cfg, "apply",
                 "27pt", False)


@pytest.mark.parametrize("op", ["fv7pt", "fv2", "27pt"])
def test_suite_smoother_takes_k6_where_gated(data, op, monkeypatch):
    """gsrb_smooth: full sweeps through K6 on the levels the gate admits
    (var7 bodies only, GSRB2_VAR7_ONLY), K5 half-sweeps elsewhere; the two
    schedules agree."""
    suite = get_suite(op)
    lv = _port_level(data, False)
    x, rhs = (torch.tensor(a) for a in data[3:])
    cfg = SolverConfig(op=op, a=0.0, dtype=torch.float64)
    calls = K.r1_gsrb2_plain.calls
    fused = suite.gsrb_smooth(lv, x, rhs, cfg, 4)
    assert K.r1_gsrb2_plain.calls == calls + (2 if op != "27pt" else 0)
    monkeypatch.setattr(K, "GSRB2_MAX_DIM", 0)
    halves = suite.gsrb_smooth(lv, x, rhs, cfg, 4)
    assert K.r1_gsrb2_plain.calls == calls + (2 if op != "27pt" else 0)
    assert torch.equal(fused, halves)


def test_27pt_body_float32_rounding():
    """The 27pt body sums weighted differences (neighbour - centre), the
    same operator as the JAX package's C0*x + C1*faces + C2*edges +
    C3*corners. On a smooth field that form's terms cancel to ~h^2 of their
    size; at 64^3 in float32 its A x is ~4x further from the float64 result
    than the port's (at 512^3 the F-cycle's Richardson order went negative).
    """
    from hpgmg_tpu.ops.base import get_suite as jsuite
    from hpgmg_tpu_torch.problems.p6 import init_problem_p6

    n = 64
    u = init_problem_p6(n, torch.float64, torch.device("cpu")).u_true

    def level(dt):  # the 27pt body reads no face arrays
        z = torch.zeros((n + 1, n, n), dtype=dt)
        return Level(dim=n, h=1.0 / n, depth=0, beta_i=z,
                     beta_j=z.permute(1, 0, 2).contiguous(),
                     beta_k=z.permute(1, 2, 0).contiguous())

    ref = K.r1_stencil_plain(level(torch.float64), u, SolverConfig(
        op="27pt", a=0.0, dtype=torch.float64), "apply", "27pt", False)
    out = K.r1_stencil_plain(level(torch.float32), u.float(), SolverConfig(
        op="27pt", a=0.0, dtype=torch.float32), "apply", "27pt", False)
    zj = jnp.zeros((n + 1, n, n), jnp.float32)
    jlv = JLevel(dim=n, h=1.0 / n, depth=0, beta_i=zj,
                 beta_j=jnp.transpose(zj, (1, 0, 2)), beta_k=jnp.transpose(zj, (1, 2, 0)))
    jout = jsuite("27pt").apply_op(jlv, jnp.asarray(u.float().numpy()),
                                   JConfig(op="27pt", a=0.0, dtype=jnp.float32,
                                           kernels="xla"))
    err = rel(out.double(), ref.numpy())
    jerr = rel(torch.tensor(np.asarray(jout, dtype=np.float64)), ref.numpy())
    assert err <= 3e-5 and err < 0.5 * jerr, (err, jerr)


@pytest.mark.parametrize("taps,var7", [("p1", True), ("27pt", False)])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_gsrb_with_parity_is_the_kdinv_form(data, taps, var7, parity):
    """The plain half-sweep with its parity is x + kdinv * (rhs - A x), and
    x bit for bit at the other colour's cells (what the streaming kernel
    copies there); it refuses a parity that is not 0 or 1."""
    lv = _port_level(data, False)
    x, rhs = (torch.tensor(a) for a in data[3:])
    cfg = SolverConfig(op="27pt" if taps == "27pt" else "fv7pt", a=0.0,
                       dtype=torch.float64)
    kd = lv.kdinv[parity]
    out = K.r1_stencil_plain(lv, x, cfg, "gsrb", taps, var7, rhs=rhs, kdinv=kd,
                             parity=parity)
    ax = K.r1_stencil_plain(lv, x, cfg, "apply", taps, var7)
    assert torch.equal(out, x + kd * (rhs - ax))
    other = rb_mask(N, 1 - parity, torch.float64, torch.device("cpu")) > 0
    assert torch.equal(out[other], x[other])
    for bad in (None, 2, -1):
        with pytest.raises(ValueError, match="parity"):
            K.r1_stencil_plain(lv, x, cfg, "gsrb", taps, var7, rhs=rhs, kdinv=kd,
                               parity=bad)


def test_entry_refuses_a_gsrb_without_its_parity(data):
    """r1_stencil (the entry the suites call) and both CUDA wrappers refuse
    a half-sweep without the sweep's parity before they launch anything;
    the other modes need none."""
    lv = _port_level(data, False)
    x, rhs = (torch.tensor(a) for a in data[3:])
    cfg = SolverConfig(op="27pt", a=0.0, dtype=torch.float64)
    for taps, var7 in (("27pt", False), ("p1", True)):
        with pytest.raises(ValueError, match="parity"):
            K.r1_stencil(lv, x, cfg, "gsrb", taps, var7, rhs=rhs, kdinv=lv.kdinv[0])
        with pytest.raises(ValueError, match="parity"):
            K.r1_stencil_cuda(lv, x, cfg, "gsrb", taps, var7, rhs=rhs,
                              kdinv=lv.kdinv[0])
        K.r1_stencil(lv, x, cfg, "residual", taps, var7, rhs=rhs)
    with pytest.raises(ValueError, match="parity"):
        K.r1_stream_cuda(lv, x, cfg, "gsrb", "27pt", rhs=rhs, kdinv=lv.kdinv[0])
    with pytest.raises(ValueError, match="CUDA"):  # checked, then refused
        K.r1_stream_cuda(lv, x, cfg, "gsrb", "27pt", rhs=rhs, kdinv=lv.kdinv[0],
                         parity=0)


@pytest.mark.parametrize("op", ["fv7pt", "27pt"])
def test_suite_half_sweep_passes_its_parity(data, op, monkeypatch):
    """RadiusOneSuite.gsrb_sweep hands the entry the sweep's parity (its
    low bit) with the matching kdinv, and gsrb_smooth's half-sweeps
    alternate 0, 1, 0, ... (the 27pt suite smooths only by half-sweeps)."""
    suite = get_suite(op)
    lv = _port_level(data, False)
    x, rhs = (torch.tensor(a) for a in data[3:])
    cfg = SolverConfig(op=op, a=0.0, dtype=torch.float64)
    seen = []
    entry = K.r1_stencil

    def record(level, x, cfg, mode, taps, var7, rhs=None, kdinv=None, parity=None):
        seen.append((mode, parity, kdinv is level.kdinv[parity] if kdinv is not None
                     else None))
        return entry(level, x, cfg, mode, taps, var7, rhs, kdinv, parity)

    monkeypatch.setattr(K, "r1_stencil", record)
    suite.gsrb_sweep(lv, x, rhs, cfg, 3)
    assert seen == [("gsrb", 1, True)]
    seen.clear()
    monkeypatch.setattr(K, "GSRB2_MAX_DIM", 0)  # half-sweeps for every suite
    suite.gsrb_smooth(lv, x, rhs, cfg, 4)
    assert seen == [("gsrb", p, True) for p in (0, 1, 0, 1)]
