"""The slab kernels of the port's decomposed path (K8a, K8b, K8c, K8d):
their plain versions, which CPU tensors take, driven on one block that is
the whole domain (single_chip_slabs*, every edge flag set), against the
JAX package in float64, every cell compared, rel <= 1e-12 (rel =
max|port - jax| / max|jax|):

* K8a against the JAX fv4 XLA path (kernels="xla": apply, and the GSRB
  half-sweep x + mask * dinv * (f - A x)) at 24^3 and 48^3, Dirichlet and
  periodic, on the JAX package's own hierarchy; at 48^3 also against
  stencils.fv4_call_slab in the Pallas interpreter, on the same slabs;
* K8b (interior pass, then edge pass) equal to K8a bit for bit;
* K8c (var7 with the fv7pt and fv2 taps, 27pt) against the JAX radius-1
  XLA apply and residual, Dirichlet and periodic, and its restricted
  residual against restrict_cell of it;
* K8d with all edge flags against the XLA red-then-black pair;
* the port's slabs equal the live rows of the JAX single_chip_slabs(_r1).

The CUDA kernels run only on a card (tests/test_torch_cuda_slab.py,
chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

import hpgmg_tpu.kernels.stencils as JK
import hpgmg_tpu.kernels.stencils_r1 as JK1
from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.core.level import Level as JLevel
from hpgmg_tpu.core.level import rb_mask as jrb_mask
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.ops.transfer import restrict_cell as jrestrict
from hpgmg_tpu.problems.fv import init_problem_fv as jinit
from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import stencils_r1 as K

TOL = 1e-12
CPU = torch.device("cpu")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def fv4_levels():
    """The JAX fv4 level 0 at 24^3 and 48^3, Dirichlet and periodic (its
    own hierarchy build, TPU kernel views included), the port's Level of
    the same arrays, and random x as numpy."""
    out = {}
    for n in (24, 48):
        for bc in ("dirichlet", "periodic"):
            jcfg = JConfig(op="fv4", a=0.0, b=1.0, dtype=jnp.float64, kernels="pallas",
                           bc=JBC(bc), min_coarse_dim=n, bottom=JBottom.BICGSTAB)
            prob = jinit(n, dtype=jnp.float64, periodic=bc == "periodic")
            jlv = jbuild(prob.beta_i, prob.beta_j, prob.beta_k, jcfg).levels[0]
            d = t(jlv.dinv)
            lv = Level(dim=n, h=jlv.h, depth=0, beta_i=t(jlv.beta_i),
                       beta_j=t(jlv.beta_j), beta_k=t(jlv.beta_k), dinv=d,
                       kdinv=tuple(rb_mask(n, p, torch.float64, CPU) * d
                                   for p in (0, 1)))
            x = np.random.default_rng(n).standard_normal((n, n, n))
            out[(n, bc)] = (jcfg, jlv, lv, x, np.asarray(prob.f))
    return out


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("n", [24, 48])
def test_k8a_plain_matches_xla(fv4_levels, n, bc):
    jcfg, jlv, lv, x, f = fv4_levels[(n, bc)]
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64, bc=BC(bc))
    jx = jnp.asarray(x)
    jxla = dataclasses.replace(jcfg, kernels="xla")
    ax = jsuite("fv4").apply_op(jlv, jx, jxla)
    slabs = S.single_chip_slabs(t(x), BC(bc))
    calls = S.fv4_slab_plain.calls
    assert rel(S.fv4_slab(lv, t(x), slabs, cfg, "apply"), ax) <= TOL
    assert rel(S.fv4_slab(lv, t(x), slabs, cfg, "residual", rhs=t(f)), jnp.asarray(f) - ax) <= TOL
    for p in (0, 1):
        ref = jx + jrb_mask(n, p, jnp.float64) * jlv.dinv * (jnp.asarray(f) - ax)
        out = S.fv4_slab(lv, t(x), slabs, cfg, "gsrb", rhs=t(f), kdinv=lv.kdinv[p])
        assert rel(out, ref) <= TOL, p
    assert S.fv4_slab_plain.calls == calls + 4


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_k8a_plain_matches_pallas_slab_kernel(fv4_levels, bc, monkeypatch):
    """At 48^3 the JAX slab kernel itself (interpreted) on the JAX slabs:
    the port's slabs are their live rows, and K8a's plain version equals
    the kernel's apply and gsrb."""
    monkeypatch.setattr(JK, "INTERPRET", True)
    jcfg, jlv, lv, x, f = fv4_levels[(48, bc)]
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64, bc=BC(bc))
    jx = jnp.asarray(x)
    jslabs = JK.single_chip_slabs(jx, JBC(bc))
    slabs = S.single_chip_slabs(t(x), BC(bc))
    live = (jslabs[0], jslabs[1], jslabs[2][:, :2], jslabs[3][:, :2])
    for port, ref in zip(slabs, live):
        assert tuple(port.shape) == ref.shape
        assert rel(port, ref) <= TOL
    kper = bc == "periodic"
    views = (jlv.kbi, jlv.kbj, jlv.kbk, jlv.kbk_top)
    ref = JK.fv4_call_slab(jx, *jslabs, *views, None, None, "apply", jlv.h2inv,
                           kperiodic=kper, ipad=2)
    assert rel(S.fv4_slab(lv, t(x), slabs, cfg, "apply"), ref) <= TOL
    ref = JK.fv4_call_slab(jx, *jslabs, *views, jnp.asarray(f), jlv.kdinv[1], "gsrb",
                           jlv.h2inv, kperiodic=kper, ipad=2)
    out = S.fv4_slab(lv, t(x), slabs, cfg, "gsrb", rhs=t(f), kdinv=lv.kdinv[1])
    assert rel(out, ref) <= TOL


@pytest.mark.parametrize("helmholtz", [False, True])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_k8b_plain_equals_k8a(fv4_levels, bc, helmholtz):
    """K8b's interior pass reads the block alone, its edge pass the slabs;
    together they equal K8a bit for bit, in every mode."""
    _, _, lv, x, f = fv4_levels[(48, bc)]
    kw = dict(a=1.5, helmholtz=True) if helmholtz else dict(a=0.0)
    cfg = SolverConfig(op="fv4", b=1.0, dtype=torch.float64, bc=BC(bc), **kw)
    if helmholtz:
        lv = dataclasses.replace(lv, alpha=t(np.random.default_rng(3).random((48,) * 3)))
    assert S.overlap_grid_shape(48, 48) == (48, 3)
    assert S.overlap_grid_shape(48, 32) is None
    x = t(x)
    slabs = S.single_chip_slabs(x, BC(bc))
    for mode, mkw in (("apply", {}), ("residual", {"rhs": t(f)}),
                      ("gsrb", {"rhs": t(f), "kdinv": lv.kdinv[0]})):
        interior = S.fv4_overlap_interior(lv, x, cfg, mode, **mkw)
        # planes 0, 1 and the first column tile are left to pass 2
        assert interior[:2].abs().max() == 0.0 and interior[:, :16].abs().max() == 0.0
        out = S.fv4_overlap_edge(lv, x, slabs, cfg, mode, interior, **mkw)
        assert torch.equal(out, S.fv4_slab(lv, x, slabs, cfg, mode, **mkw)), mode


N1 = 32
# (taps, var7, op): fv7pt, fv2, 27pt
R1_BODIES = [("p1", True, "fv7pt"), ("v2", True, "fv2"), ("27pt", False, "27pt")]


@pytest.fixture(scope="module")
def r1_data():
    rng = np.random.default_rng(N1)
    b = [1.0 + 0.25 * rng.random(s) for s in
         ((N1 + 1, N1, N1), (N1, N1 + 1, N1), (N1, N1, N1 + 1))]
    dinv = (0.5 + rng.random((N1,) * 3)) / (8.0 * N1 * N1)
    x, rhs = rng.standard_normal((2, N1, N1, N1))
    return b, dinv, x, rhs


def _r1_levels(r1_data):
    b, dinv, _, _ = r1_data
    jb = [jnp.asarray(a) for a in b]
    jd = jnp.asarray(dinv)
    jlv = JLevel(dim=N1, h=1.0 / N1, depth=0, beta_i=jb[0], beta_j=jb[1], beta_k=jb[2],
                 dinv=jd, kdinv=tuple(jrb_mask(N1, p, jnp.float64) * jd for p in (0, 1)))
    d = t(dinv)
    lv = Level(dim=N1, h=1.0 / N1, depth=0, beta_i=t(b[0]), beta_j=t(b[1]),
               beta_k=t(b[2]), dinv=d,
               kdinv=tuple(rb_mask(N1, p, torch.float64, CPU) * d for p in (0, 1)))
    return jlv, lv


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("taps,var7,op", R1_BODIES)
def test_k8c_plain_matches_xla(r1_data, taps, var7, op, bc):
    jlv, lv = _r1_levels(r1_data)
    x, rhs = (t(a) for a in r1_data[2:])
    jx, jrhs = (jnp.asarray(a) for a in r1_data[2:])
    a = 1.5 if op == "27pt" else 0.0
    jcfg = JConfig(op=op, a=a, b=1.0, dtype=jnp.float64, kernels="xla", bc=JBC(bc))
    cfg = SolverConfig(op=op, a=a, b=1.0, dtype=torch.float64, bc=BC(bc))
    ax = jsuite(op).apply_op(jlv, jx, jcfg)
    slabs = K.single_chip_slabs_r1(x, BC(bc), taps)
    assert rel(K.r1_slab(lv, x, slabs, cfg, "apply", taps, var7), ax) <= TOL
    res = K.r1_slab(lv, x, slabs, cfg, "residual", taps, var7, rhs=rhs)
    assert rel(res, jrhs - ax) <= TOL
    fres = K.r1_slab(lv, x, slabs, cfg, "fres", taps, var7, rhs=rhs)
    assert rel(fres, jrestrict(jrhs - ax)) <= TOL
    ref = jx + jlv.kdinv[1] * (jrhs - ax)
    out = K.r1_slab(lv, x, slabs, cfg, "gsrb", taps, var7, rhs=rhs, kdinv=lv.kdinv[1])
    assert rel(out, ref) <= TOL


@pytest.mark.parametrize("taps,var7,op", R1_BODIES)
def test_k8d_plain_matches_xla_red_black_pair(r1_data, taps, var7, op):
    """K8d on one block with every edge flag set: one red+black sweep, the
    JAX XLA half-sweeps (each from a fresh ghost fill) in sequence; also
    equal to the port's K6 plain version."""
    jlv, lv = _r1_levels(r1_data)
    x, rhs = (t(a) for a in r1_data[2:])
    jx, jrhs = (jnp.asarray(a) for a in r1_data[2:])
    a = 1.5 if op == "27pt" else 0.0
    jcfg = JConfig(op=op, a=a, b=1.0, dtype=jnp.float64, kernels="xla")
    cfg = SolverConfig(op=op, a=a, b=1.0, dtype=torch.float64)
    ref = jx
    for p in (0, 1):
        ref = ref + jlv.kdinv[p] * (jrhs - jsuite(op).apply_op(jlv, ref, jcfg))
    calls = K.r1_gsrb2_slab_plain.calls
    out = K.r1_gsrb2_one_block(lv, x, rhs, cfg, taps, var7)
    assert K.r1_gsrb2_slab_plain.calls == calls + 1
    assert rel(out, ref) <= TOL
    assert rel(out, K.r1_gsrb2_plain(lv, x, rhs, cfg, taps, var7).numpy()) <= TOL


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("taps", ["p1", "v2", "27pt"])
def test_r1_slabs_equal_jax_single_chip_slabs(r1_data, taps, bc):
    x = r1_data[2]
    jslabs = JK1.single_chip_slabs_r1(jnp.asarray(x), JBC(bc), taps)
    slabs = K.single_chip_slabs_r1(t(x), BC(bc), taps)
    live = (jslabs[0], jslabs[1], jslabs[2][:, :1], jslabs[3][:, :1])
    for port, ref in zip(slabs, live):
        assert tuple(port.shape) == ref.shape
        assert rel(port, ref) <= TOL


def test_slab_wrappers_refuse_what_the_kernels_do_not_take(fv4_levels, r1_data):
    _, _, lv, x, f = fv4_levels[(24, "dirichlet")]
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64)
    x = t(x)
    slabs = S.single_chip_slabs(x, BC.DIRICHLET)
    with pytest.raises(ValueError, match="mode"):
        S.fv4_slab(lv, x, slabs, cfg, "fres", rhs=t(f))
    with pytest.raises(ValueError, match="jlo"):
        S.fv4_slab(lv, x, slabs[:2] + (slabs[2][:, :1].contiguous(), slabs[3]), cfg, "apply")
    with pytest.raises(ValueError, match="column tiles"):
        S.fv4_overlap_interior(lv, x[:16, :16].contiguous(), cfg, "apply")
    with pytest.raises(ValueError, match="CUDA"):
        S.fv4_slab_cuda(lv, x, slabs, cfg, "apply")
    _, rlv = _r1_levels(r1_data)
    rcfg = SolverConfig(op="fv7pt", a=0.0, b=1.0, dtype=torch.float64,
                        bc=BC.PERIODIC)
    rx = t(r1_data[2])
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        K.r1_gsrb2_one_block(rlv, rx, t(r1_data[3]), rcfg, "p1", True)
    with pytest.raises(ValueError, match="CUDA"):
        K.r1_slab_cuda(rlv, rx, K.single_chip_slabs_r1(rx, BC.PERIODIC, "p1"), rcfg,
                       "apply", "p1", True)
