"""Per-module parity of the PyTorch port (hpgmg_tpu_torch) with the JAX
package on the CPU.

The same numpy inputs (seeded) go through the JAX function and its port;
results agree to rel <= 1e-12 in float64 and 1e-5 in float32, where rel is
max|port - jax| / max|jax|. The port runs on its plain versions here
(CPU tensors).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.level import Level as JLevel
from hpgmg_tpu.ops import bc_fv as jbc
from hpgmg_tpu.ops import transfer as jtr
from hpgmg_tpu.ops import transfer_fv as jtrfv
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.ops.rebuild import rebuild_blackbox as jrebuild
from hpgmg_tpu.problems.fv import init_problem_fv as jinit
from hpgmg_tpu_torch.core import blas
from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.ops import bc_fv, transfer, transfer_fv
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.ops.rebuild import rebuild_blackbox
from hpgmg_tpu_torch.problems.fv import init_problem_fv

CPU = torch.device("cpu")
DTYPES = {"f64": (torch.float64, jnp.float64, 1e-12),
          "f32": (torch.float32, jnp.float32, 1e-5)}


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    return float(np.max(np.abs(port - ref)) / np.max(np.abs(ref)))


def field(rng, shape, tdt):
    a = rng.standard_normal(shape)
    return torch.tensor(a, dtype=tdt), jnp.asarray(a, dtype=tdt_to_j(tdt))


def tdt_to_j(tdt):
    return jnp.float64 if tdt == torch.float64 else jnp.float32


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n", [16, 32])
def test_ghost_fill_fv(n, dt):
    tdt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(n)
    x, jx = field(rng, (n, n, n), tdt)
    for order, radius in ((2, 1), (4, 2)):
        out = bc_fv.ghost_fill_fv(x, BC.DIRICHLET, order, radius)
        ref = jbc.ghost_fill_fv(jx, JBC.DIRICHLET, order, radius)
        assert out.shape == ref.shape
        assert rel(out, ref) <= tol


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n", [16, 32])
def test_extend_beta_tangential(n, dt):
    tdt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(n + 1)
    for axis in range(3):
        shape = [n, n, n]
        shape[axis] += 1
        b, jb = field(rng, tuple(shape), tdt)
        out = bc_fv.extend_beta_tangential(b, axis, BC.DIRICHLET)
        ref = jbc.extend_beta_tangential(jb, axis, JBC.DIRICHLET)
        assert out.shape == ref.shape
        assert rel(out, ref) <= tol


def test_periodic_not_ported():
    x = torch.zeros((8, 8, 8), dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        bc_fv.ghost_fill_fv(x, BC.PERIODIC, 4, 2)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n", [16, 32])
def test_restrict_cell_and_faces(n, dt):
    tdt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(n + 2)
    x, jx = field(rng, (n, n, n), tdt)
    assert rel(transfer.restrict_cell(x), jtr.restrict_cell(jx)) <= tol
    for axis, fn, jfn in ((0, transfer.restrict_face_i, jtr.restrict_face_i),
                          (1, transfer.restrict_face_j, jtr.restrict_face_j),
                          (2, transfer.restrict_face_k, jtr.restrict_face_k)):
        shape = [n, n, n]
        shape[axis] += 1
        b, jb = field(rng, tuple(shape), tdt)
        out = fn(b)
        assert out.is_contiguous() and out.shape == jfn(jb).shape
        assert rel(out, jfn(jb)) <= tol


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n", [16, 32])
def test_interp_v2_v4(n, dt):
    tdt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(n + 3)
    m = n // 2
    xc, jxc = field(rng, (m, m, m), tdt)
    xf, jxf = field(rng, (n, n, n), tdt)
    for port, ref in ((transfer_fv.interp_v2, jtrfv.interp_v2),
                      (transfer_fv.interp_v4, jtrfv.interp_v4)):
        for prescale in (0.0, 1.0):
            out = port(xc, prescale, xf, BC.DIRICHLET)
            assert out.is_contiguous()
            assert rel(out, ref(jxc, prescale, jxf, JBC.DIRICHLET)) <= tol
    assert transfer.get_interpolation("v4") is transfer_fv.interp_v4
    with pytest.raises(ValueError):
        transfer.get_interpolation("p3")


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n", [16, 32])
def test_init_problem_fv(n, dt):
    tdt, jdt, tol = DTYPES[dt]
    prob = init_problem_fv(n, tdt, CPU)
    jprob = jinit(n, dtype=jdt)
    for name in ("beta_i", "beta_j", "beta_k", "alpha", "f"):
        out, ref = getattr(prob, name), getattr(jprob, name)
        assert out.dtype == tdt and out.is_contiguous()
        assert tuple(out.shape) == ref.shape
        assert rel(out, ref) <= tol, name


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n", [16, 32])
def test_rebuild_blackbox(n, dt):
    """dinv / l1inv / lambda_max from the 64 colour probes of the fv4
    operator on the benchmark problem's tangentially-extended betas."""
    tdt, jdt, tol = DTYPES[dt]
    jprob = jinit(n, dtype=jdt)
    jcfg = JConfig(op="fv4", a=0.0, b=1.0, dtype=jdt, kernels="xla")
    jb = [jbc.extend_beta_tangential(b, a, JBC.DIRICHLET)
          for a, b in enumerate((jprob.beta_i, jprob.beta_j, jprob.beta_k))]
    jlv = jrebuild(jsuite("fv4"), JLevel(dim=n, h=1.0 / n, depth=0, beta_i=jb[0],
                                         beta_j=jb[1], beta_k=jb[2]), jcfg, 4)
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=tdt)
    b = [torch.tensor(np.asarray(a)) for a in jb]
    lv = rebuild_blackbox(get_suite("fv4"), Level(dim=n, h=1.0 / n, depth=0,
                                                  beta_i=b[0], beta_j=b[1],
                                                  beta_k=b[2]), cfg, 4)
    for name in ("dinv", "l1inv", "lambda_max"):
        assert rel(getattr(lv, name), getattr(jlv, name)) <= tol, name


def test_blas_and_rb_mask():
    rng = np.random.default_rng(7)
    u, v = rng.standard_normal((2, 8, 8, 8))
    tu, tv = torch.tensor(u), torch.tensor(v)
    assert abs(float(blas.dot(tu, tv)) - float(np.sum(u * v))) <= 1e-12 * np.sum(np.abs(u * v))
    assert float(blas.norm(tu)) == float(np.max(np.abs(u)))
    assert abs(float(blas.mean(tu)) - float(np.mean(u))) <= 1e-15
    from hpgmg_tpu.core.level import rb_mask as jrb_mask
    for p in (0, 1):
        assert np.array_equal(rb_mask(6, p, torch.float64, CPU).numpy(),
                              np.asarray(jrb_mask(6, p, jnp.float64)))


def test_config_rejects_other_dtypes():
    with pytest.raises(ValueError):
        SolverConfig(dtype=torch.float16)
    assert SolverConfig().resolved_num_smooths(get_suite("fv4")) == 3


def test_port_imports_no_jax():
    """The port package never imports jax or the JAX package."""
    pkg = pathlib.Path(__file__).resolve().parents[1] / "hpgmg_tpu_torch"
    pat = re.compile(r"(import|from) (jax|hpgmg_tpu)\b")
    hits = [f"{p}:{i + 1}" for p in sorted(pkg.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines()) if pat.search(line)]
    assert sorted(pkg.rglob("*.py")) and not hits, hits
