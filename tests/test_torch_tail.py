"""K4 (the coarse-ladder tail) of the PyTorch port: its plain versions,
which CPU tensors take, against the JAX package's tail kernels run by the
Pallas interpreter (tail_down_call, tail_up_call, tail_vcycle;
hpgmg_tpu/kernels/tail.py), at 32^3 in float64 on the JAX hierarchy carried
across with hpgmg_tpu_torch.interop (tail levels 32 and 16 over the 8^3
DIRECT bottom), rel <= 1e-12 (rel = max|port - jax| / max|jax|); and the
port's V-cycle with and without the tail, rel <= 1e-11. The CUDA kernels
run only on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpgmg_tpu.kernels.stencils as JK
import hpgmg_tpu.kernels.tail as JT
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.problems.fv import init_problem_fv as jinit
from hpgmg_tpu_torch.core.config import BottomSolver, SolverConfig
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import tail as T
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import vcycle

N = 32
TOL = 1e-12
FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "lambda_max",
          "bottom_ainv")


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(op="fv4", a=0.0, b=1.0, dtype=jnp.float64,
                   bottom=JBottom.DIRECT, min_coarse_dim=8)
    jprob = jinit(N, dtype=jnp.float64)
    jh = jbuild(jprob.beta_i, jprob.beta_j, jprob.beta_k, jcfg, alpha=jprob.alpha)
    assert [lv.dim for lv in jh.levels] == [32, 16, 8]
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    levels = [{"dim": lv.dim, "h": lv.h, "depth": lv.depth,
               **{f: np.array(getattr(lv, f)) for f in FIELDS
                  if getattr(lv, f) is not None},
               "kdinv": (None if lv.kdinv is None
                         else tuple(np.array(k) for k in lv.kdinv))}
              for lv in jh.levels]
    hier = hierarchy_from_numpy(levels, cfg, "cpu")
    rng = np.random.default_rng(32)
    e0 = rng.standard_normal((N, N, N))
    u_bot = rng.standard_normal((8, 8, 8))
    return jcfg, jh, jprob.f, cfg, hier, e0, u_bot


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JK, "INTERPRET", True)
    monkeypatch.setattr(JT, "TAIL_FUSE", True)


def test_gating(setup):
    _, _, _, cfg, hier, _, _ = setup
    op = get_suite("fv4")
    assert T.tail_span(hier.levels, 0) == 2 and T.tail_span(hier.levels, 1) == 1
    assert T.use_tail(op, cfg, hier.levels, 0)
    assert not T.use_tail(op, cfg, hier.levels, 2)  # the bottom level


def test_tail_down_matches_jax(setup, interpret):
    jcfg, jh, jf, cfg, hier, e0, _ = setup
    jes, jrhss = JT.tail_down_call(jh.levels[:2], jnp.asarray(e0), jf, jcfg)
    es, rhss = T.tail_down(hier.levels[:2], torch.tensor(e0),
                           torch.tensor(np.array(jf)), cfg, 6)
    for got, want in zip(es + rhss, list(jes) + list(jrhss)):
        assert tuple(got.shape) == want.shape
        assert rel(got, want) <= TOL


def test_tail_up_matches_jax(setup, interpret):
    jcfg, jh, jf, cfg, hier, e0, u_bot = setup
    rng = np.random.default_rng(16)
    es = [e0, rng.standard_normal((16, 16, 16))]
    rhss = [np.array(jf), rng.standard_normal((16, 16, 16))]
    want = JT.tail_up_call(jh.levels[:2], [jnp.asarray(a) for a in es],
                           [jnp.asarray(a) for a in rhss], jnp.asarray(u_bot), jcfg)
    got = T.tail_up(hier.levels[:2], [torch.tensor(a) for a in es],
                    [torch.tensor(a) for a in rhss], torch.tensor(u_bot), cfg, 6)
    assert rel(got, want) <= TOL


def test_vcycle_through_tail_matches_jax(setup, interpret):
    """The port's V-cycle from 32^3 (K4 down, DIRECT bottom, K4 up) against
    the JAX package's fused tail V-cycle."""
    jcfg, jh, jf, cfg, hier, e0, _ = setup
    want = JT.tail_vcycle(jsuite("fv4"), jh.levels, 0, jnp.asarray(e0), jf, jcfg)
    calls = (T.tail_down_plain.calls, T.tail_up_plain.calls)
    got = vcycle(get_suite("fv4"), hier.levels, 0, torch.tensor(e0),
                 torch.tensor(np.array(jf)), cfg)
    assert (T.tail_down_plain.calls, T.tail_up_plain.calls) == (calls[0] + 1,
                                                                calls[1] + 1)
    assert rel(got, want) <= TOL


def test_vcycle_with_and_without_tail(setup, monkeypatch):
    _, _, jf, cfg, hier, e0, _ = setup
    op = get_suite("fv4")
    args = (op, hier.levels, 0, torch.tensor(e0), torch.tensor(np.array(jf)), cfg)
    fused = vcycle(*args)
    monkeypatch.setattr(T, "TAIL_FUSE", False)
    calls = T.tail_down_plain.calls
    plain = vcycle(*args)
    assert T.tail_down_plain.calls == calls
    assert rel(fused, plain.numpy()) <= 1e-11


def test_helmholtz_tail_matches_unfused(setup, monkeypatch):
    """The a*alpha*x term rides K4 too: tail vs level-by-level V-cycle."""
    _, _, jf, cfg, hier, e0, _ = setup
    rng = np.random.default_rng(5)
    hcfg = dataclasses.replace(cfg, a=1.0, helmholtz=True)
    alpha = 1.0 + torch.tensor(rng.random((N, N, N)))
    levels = [dataclasses.replace(lv, alpha=alpha[:lv.dim, :lv.dim, :lv.dim].contiguous())
              for lv in hier.levels]
    args = (get_suite("fv4"), levels, 0, torch.tensor(e0),
            torch.tensor(np.array(jf)), hcfg)
    fused = vcycle(*args)
    monkeypatch.setattr(T, "TAIL_FUSE", False)
    assert rel(fused, vcycle(*args).numpy()) <= 1e-11


def test_wrappers_reject_what_the_kernels_do_not_take(setup):
    _, _, jf, cfg, hier, e0, u_bot = setup
    e, rhs = torch.tensor(e0), torch.tensor(np.array(jf))
    with pytest.raises(ValueError, match="even nsweeps"):
        T.tail_down(hier.levels[:2], e, rhs, cfg, 3)
    with pytest.raises(ValueError, match="halve"):
        T.tail_down([hier.levels[0], hier.levels[2]], e, rhs, cfg, 6)
    with pytest.raises(ValueError, match="u_bot"):
        T.tail_up(hier.levels[:2], [e, rhs[:16, :16, :16].contiguous()],
                  [rhs, rhs[:16, :16, :16].contiguous()], e, cfg, 6)
    with pytest.raises(ValueError, match="CUDA"):
        T.tail_down_cuda(hier.levels[:2], e, rhs, cfg, 6)
    with pytest.raises(ValueError, match="CUDA"):
        S.fv4_gsrb2_cuda(hier.levels[0], e, rhs, cfg)
