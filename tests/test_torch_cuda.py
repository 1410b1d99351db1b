"""The port's CUDA kernels on a card: each K1 mode, K1s
(each mode, also against K1), K2, K3, K4's two halves and K4c, each K5
mode and K6 (both bodies, all three tap sets), K7a and K7b (the periodic K1
and K5) against their plain versions on the same CUDA tensors, and small
F-cycles (fv4, fv7pt, fv2, 27pt; Dirichlet and periodic; fv4 with SUBTILE
on, with each smoother and each bottom solver) through the kernels against
the same F-cycles on the CPU. max|kernel - plain| / max|plain| <= 1e-12 in
float64, 1e-5 in float32 (the kernel sums the stencil in another order
than the plain version); K1s: 1e-13 and 2e-6.

Marked ``cuda``: without a CUDA device (and nvcc) every test skips. On a
card: python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.bench.driver import build
from hpgmg_tpu_torch.core.config import BC, BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import restrict as R
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import stencils_r1 as K
from hpgmg_tpu_torch.kernels import tail as T
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.problems.fv import init_problem_fv
from hpgmg_tpu_torch.core.hierarchy import build_hierarchy
from hpgmg_tpu_torch.solve.mg import fmg_solve

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def relerr(out, ref) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _level(n, dtype, dev, rng):
    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    beta = [t(1.0 + 0.25 * rng.random(s)) for s in
            ((n + 1, n + 2, n + 2), (n + 2, n + 1, n + 2), (n + 2, n + 2, n + 1))]
    dinv = t((0.5 + rng.random((n, n, n))) / (8.0 * n * n))  # ~ h^2/8
    return Level(dim=n, h=1.0 / n, depth=0, beta_i=beta[0], beta_j=beta[1],
                 beta_k=beta[2], alpha=t(rng.random((n, n, n))), dinv=dinv,
                 kdinv=tuple(rb_mask(n, p, dtype, dev) * dinv for p in (0, 1)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [8, 48])
def test_k1_modes_match_plain(dev, n, dtype):
    rng = np.random.default_rng(n)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    poisson = SolverConfig(a=0.0, dtype=dtype)
    helm = SolverConfig(a=1.5, helmholtz=True, dtype=dtype)
    cases = [("apply", poisson, {}, None), ("residual", poisson, {"rhs": rhs}, None),
             ("gsrb", poisson, {"rhs": rhs, "kdinv": lv.kdinv[0]}, 0),
             ("gsrb", poisson, {"rhs": rhs, "kdinv": lv.kdinv[1]}, 1),
             ("fres", poisson, {"rhs": rhs}, None), ("apply", helm, {}, None)]
    launches = S.fv4_stencil_cuda.launches
    for mode, cfg, kw, parity in cases:
        out = S.fv4_stencil(lv, x, cfg, mode, parity=parity, **kw)
        assert out.is_cuda
        assert relerr(out, S.fv4_stencil_plain(lv, x, cfg, mode, **kw)) <= TOL[dtype]
    assert S.fv4_stencil_cuda.launches == launches + len(cases)  # one launch a call


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [8, 48, 256])
def test_k2_matches_plain(dev, n, dtype):
    rng = np.random.default_rng(n + 1)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    for cfg in (SolverConfig(a=0.0, dtype=dtype),
                SolverConfig(a=1.5, helmholtz=True, dtype=dtype)):
        plain = S.fv4_gsrb2_plain(lv, x, rhs, cfg)
        assert relerr(S.fv4_gsrb2_cuda(lv, x, rhs, cfg), plain) <= TOL[dtype]
        if n > S.GSRB2_CLUSTER_MAX_N:  # beyond K2c: the entry raises
            with pytest.raises(ValueError, match="K2c takes n"):
                S.fv4_gsrb2(lv, x, rhs, cfg)
            continue
        launches = S.fv4_gsrb2_cluster_cuda.launches
        out = S.fv4_gsrb2(lv, x, rhs, cfg)  # the entry launches K2c
        assert S.fv4_gsrb2_cluster_cuda.launches == launches + 1
        assert relerr(out, plain) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [(32, 16), (16,)])
def test_k4_matches_plain(dev, dims, dtype):
    rng = np.random.default_rng(dims[0])
    tail = [_level(d, dtype, dev, rng) for d in dims]
    cfg = SolverConfig(a=0.0, dtype=dtype)
    e, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2,) + tail[0].shape))
    es, rhss = T.tail_down(tail, e, rhs, cfg, 6)
    es_p, rhss_p = T.tail_down_plain(tail, e, rhs, cfg, 6)
    for got, want in zip(es + rhss, es_p + rhss_p):
        assert relerr(got, want) <= TOL[dtype]
    d = dims[-1] // 2
    u_bot = torch.tensor(rng.standard_normal((d, d, d)), dtype=dtype, device=dev)
    up = T.tail_up(tail, es_p, [rhs] + rhss_p[:-1], u_bot, cfg, 6)
    want = T.tail_up_plain(tail, es_p, [rhs] + rhss_p[:-1], u_bot, cfg, 6)
    assert relerr(up, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 16, 64])
def test_k3_matches_plain(dev, n, dtype):
    x = torch.tensor(np.random.default_rng(n).standard_normal((n, n, n)),
                     dtype=dtype, device=dev)
    launches = R.restrict_cell_cuda.launches
    out = R.restrict_cell(x)
    assert R.restrict_cell_cuda.launches == launches + 1
    assert relerr(out, R.restrict_cell_plain(x)) <= TOL[dtype]


def test_fcycle_through_kernels_matches_cpu(dev):
    """64^3: K2 smooths and K1 restricts the 64^3 level, K4 runs the
    32-16 tail, the DIRECT bottom is 8^3."""
    cfg = SolverConfig(op="fv4", a=0.0, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    sols = []
    for device in (dev, torch.device("cpu")):
        prob = init_problem_fv(64, torch.float64, device)
        hier = build_hierarchy(prob.beta_i, prob.beta_j, prob.beta_k, cfg)
        u, nr, nf = fmg_solve(get_suite("fv4"), hier, prob.f, cfg)
        sols.append((u.cpu(), float(nr) / float(nf)))
    (ug, rg), (uc, rc) = sols
    assert relerr(ug, uc) <= 1e-10
    assert abs(rg - rc) <= 1e-6 * rc


def _level_r1(n, dtype, dev, rng):
    """A radius-1 level: natural face arrays, alpha, parity-folded dinv."""
    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    beta = [t(1.0 + 0.25 * rng.random(s)) for s in
            ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1))]
    dinv = t((0.5 + rng.random((n, n, n))) / (8.0 * n * n))
    return Level(dim=n, h=1.0 / n, depth=0, beta_i=beta[0], beta_j=beta[1],
                 beta_k=beta[2], alpha=t(rng.random((n, n, n))), dinv=dinv,
                 kdinv=tuple(rb_mask(n, p, dtype, dev) * dinv for p in (0, 1)))


# (taps, var7, helmholtz): fv7pt, fv2, fv7pt with a*alpha*x, 27pt, 27pt
# with its constant a*x
R1_BODIES = [("p1", True, False), ("v2", True, False), ("p1", True, True),
             ("27pt", False, False), ("27pt", False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 8, 48])
def test_k5_k6_match_plain(dev, n, dtype):
    """Every K5 mode and K6's full sweep, each body and tap set, against
    the plain versions (n = 2: every cell a boundary cell; 48: partial
    K6 tiles along k)."""
    rng = np.random.default_rng(n + 5)
    lv = _level_r1(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    for taps, var7, helm in R1_BODIES:
        cfg = SolverConfig(a=1.5 if helm else 0.0, helmholtz=helm, dtype=dtype)
        cases = [("apply", {}), ("residual", {"rhs": rhs}),
                 ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0], "parity": 0}),
                 ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[1], "parity": 1}),
                 ("fres", {"rhs": rhs})]
        # var7 on its streaming kernel, 27pt on r1_stream.cu
        wrapper = K.r1_stencil_cuda if var7 else K.r1_stream_cuda
        launches = wrapper.launches
        for mode, kw in cases:
            out = K.r1_stencil(lv, x, cfg, mode, taps, var7, **kw)
            assert out.is_cuda
            assert relerr(out, K.r1_stencil_plain(lv, x, cfg, mode, taps, var7,
                                                  **kw)) <= TOL[dtype]
        assert wrapper.launches == launches + len(cases)
        launches = K.r1_gsrb2_cuda.launches
        out = K.r1_gsrb2(lv, x, rhs, cfg, taps, var7)
        assert K.r1_gsrb2_cuda.launches == launches + 1
        assert relerr(out, K.r1_gsrb2_plain(lv, x, rhs, cfg, taps, var7)) <= TOL[dtype]


@pytest.mark.parametrize("op", ["fv7pt", "fv2", "27pt"])
def test_r1_fcycle_through_kernels_matches_cpu(dev, op):
    """64^3 f64: K6 or K5 smooths, K5 restricts the residuals and probes
    the DIRECT bottom (8^3), against the same F-cycle on the CPU."""
    cfg = SolverConfig(op=op, a=0.0, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    sols = []
    for device in (dev, torch.device("cpu")):
        hier, f = build(64, cfg, device)
        u, nr, nf = fmg_solve(get_suite(op), hier, f, cfg)
        sols.append((u.cpu(), float(nr) / float(nf)))
    (ug, rg), (uc, rc) = sols
    assert relerr(ug, uc) <= 1e-10
    assert abs(rg - rc) <= 1e-6 * rc


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [4, 8, 48, 64])
def test_k7a_matches_plain(dev, n, dtype):
    """K7a: K1's kernel with wrapped ghosts, one launch in every mode,
    counted apart from K1's launches."""
    rng = np.random.default_rng(n + 7)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    poisson = SolverConfig(a=0.0, bc=BC.PERIODIC, dtype=dtype)
    helm = SolverConfig(a=1.5, helmholtz=True, bc=BC.PERIODIC, dtype=dtype)
    cases = [("apply", poisson, {}, None), ("residual", poisson, {"rhs": rhs}, None),
             ("gsrb", poisson, {"rhs": rhs, "kdinv": lv.kdinv[0]}, 0),
             ("gsrb", poisson, {"rhs": rhs, "kdinv": lv.kdinv[1]}, 1),
             ("fres", poisson, {"rhs": rhs}, None), ("apply", helm, {}, None)]
    before = (S.fv4_stencil_cuda.launches, S.fv4_stencil_cuda.periodic_launches)
    for mode, cfg, kw, parity in cases:
        out = S.fv4_stencil(lv, x, cfg, mode, parity=parity, **kw)
        assert relerr(out, S.fv4_stencil_plain(lv, x, cfg, mode, **kw)) <= TOL[dtype]
    assert (S.fv4_stencil_cuda.launches, S.fv4_stencil_cuda.periodic_launches) == (
        before[0], before[1] + len(cases))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 4, 8, 48, 64])
def test_k7b_matches_plain(dev, n, dtype):
    """K7b: every K5 mode with wrapped ghosts, each body and tap set (n = 2:
    the low and the high ghost of an axis are the same two cells); K6
    refuses the periodic level."""
    rng = np.random.default_rng(n + 17)
    lv = _level_r1(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    for taps, var7, helm in R1_BODIES:
        cfg = SolverConfig(a=1.5 if helm else 0.0, helmholtz=helm, bc=BC.PERIODIC,
                           dtype=dtype)
        cases = [("apply", {}), ("residual", {"rhs": rhs}),
                 ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0], "parity": 0}),
                 ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[1], "parity": 1}),
                 ("fres", {"rhs": rhs})]
        wrapper = K.r1_stencil_cuda if var7 else K.r1_stream_cuda
        before = (wrapper.launches, wrapper.periodic_launches)
        for mode, kw in cases:
            out = K.r1_stencil(lv, x, cfg, mode, taps, var7, **kw)
            assert relerr(out, K.r1_stencil_plain(lv, x, cfg, mode, taps, var7,
                                                  **kw)) <= TOL[dtype]
        assert (wrapper.launches, wrapper.periodic_launches) == (
            before[0], before[1] + len(cases))
        with pytest.raises(NotImplementedError):
            K.r1_gsrb2(lv, x, rhs, cfg, taps, var7)


def _bottom(d, dtype, dev, rng):
    m = d ** 3
    ainv = (np.eye(m) + 0.1 * rng.standard_normal((m, m)) / np.sqrt(m)) / (8.0 * d * d)
    return Level(dim=d, h=1.0 / d, depth=0, beta_i=torch.zeros((d + 1, d, d), dtype=dtype,
                                                              device=dev),
                 beta_j=torch.zeros((d, d + 1, d), dtype=dtype, device=dev),
                 beta_k=torch.zeros((d, d, d + 1), dtype=dtype, device=dev),
                 bottom_ainv=torch.tensor(ainv, dtype=dtype, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [(32, 16), (16,)])
def test_k4c_matches_plain(dev, dims, dtype):
    """K4c: descent, DIRECT bottom matvec and climb in one launch, against
    its plain version and against K4a + the matvec + K4b on the card; the
    tail kernels refuse a periodic level."""
    rng = np.random.default_rng(dims[0] + 3)
    tail = [_level(d, dtype, dev, rng) for d in dims]
    bottom = _bottom(dims[-1] // 2, dtype, dev, rng)
    cfg = SolverConfig(a=0.0, dtype=dtype)
    e, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2,) + tail[0].shape))
    launches = T.tail_v_cuda.launches
    out = T.tail_v(tail, bottom, e, rhs, cfg, 6)
    assert T.tail_v_cuda.launches == launches + 1
    assert relerr(out, T.tail_v_plain(tail, bottom, e, rhs, cfg, 6)) <= TOL[dtype]
    es, rhss = T.tail_down(tail, e, rhs, cfg, 6)
    u_bot = (bottom.bottom_ainv @ rhss[-1].reshape(-1)).reshape(bottom.shape)
    three = T.tail_up(tail, es, [rhs] + rhss[:-1], u_bot, cfg, 6)
    assert relerr(out, three) <= TOL[dtype]
    periodic = SolverConfig(a=0.0, bc=BC.PERIODIC, dtype=dtype)
    for launch in (lambda: T.tail_v(tail, bottom, e, rhs, periodic, 6),
                   lambda: T.tail_down(tail, e, rhs, periodic, 6),
                   lambda: S.fv4_gsrb2(tail[0], e, rhs, periodic)):
        with pytest.raises(NotImplementedError):
            launch()


# K1s against its plain version: ghosts rounded in another order than the
# plain version's separable fill (f32), the stencil summed in another order
K1S_TOL = {torch.float32: 2e-6, torch.float64: 1e-13}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [4, 8, 48, 64])
def test_k1s_matches_plain_and_k1(dev, n, dtype):
    """K1s in each mode, with and without a*alpha*x, against its plain
    version and against K1 on the same tensors (n = 4: every cell reads
    ghosts; 48: ragged tiles along k); one launch per call; it refuses a
    periodic level and K1's fres mode."""
    rng = np.random.default_rng(n + 11)
    lv = _level(n, dtype, dev, rng)
    x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
              for a in rng.standard_normal((2, n, n, n)))
    for cfg in (SolverConfig(a=0.0, dtype=dtype),
                SolverConfig(a=1.5, helmholtz=True, dtype=dtype)):
        cases = [("apply", {}, None), ("residual", {"rhs": rhs}, None),
                 ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}, 0),
                 ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[1]}, 1)]
        before = (S.fv4_subtile_cuda.launches, S.fv4_stencil_cuda.launches)
        for mode, kw, parity in cases:
            out = S.fv4_subtile(lv, x, cfg, mode, parity=parity, **kw)
            assert out.is_cuda
            assert relerr(out, S.fv4_subtile_plain(lv, x, cfg, mode, parity=parity,
                                                   **kw)) <= K1S_TOL[dtype]
            assert relerr(out, S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity,
                                                  **kw)) <= K1S_TOL[dtype]
        assert S.fv4_subtile_cuda.launches == before[0] + len(cases)
        assert S.fv4_stencil_cuda.launches == before[1] + len(cases)  # K1's only
    with pytest.raises(NotImplementedError):
        S.fv4_subtile(lv, x, SolverConfig(a=0.0, bc=BC.PERIODIC, dtype=dtype), "apply")
    with pytest.raises(ValueError, match="mode"):
        S.fv4_subtile(lv, x, SolverConfig(a=0.0, dtype=dtype), "fres", rhs=rhs)


@pytest.mark.parametrize("smoother", ["gsrb", "symgs"])
def test_subtile_fcycle_matches_cpu(dev, monkeypatch, smoother):
    """32^3 f64 fv4 with SUBTILE on for every level: K1s takes every
    apply, residual (the unfused residual restriction) and half-sweep that
    K2 and the tail do not, against the same F-cycle on the CPU."""
    from hpgmg_tpu_torch.core.config import Smoother

    monkeypatch.setattr(S, "SUBTILE", True)
    monkeypatch.setattr(S, "SUBTILE_MAX_DIM", 32)
    cfg = SolverConfig(op="fv4", a=0.0, dtype=torch.float64, smoother=Smoother(smoother),
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    launches = S.fv4_subtile_cuda.launches
    sols = []
    for device in (dev, torch.device("cpu")):
        hier, f = build(32, cfg, device)
        u, nr, nf = fmg_solve(get_suite("fv4"), hier, f, cfg)
        sols.append((u.cpu(), float(nr) / float(nf)))
    assert S.fv4_subtile_cuda.launches > launches
    (ug, rg), (uc, rc) = sols
    assert relerr(ug, uc) <= 1e-10
    assert abs(rg - rc) <= 1e-6 * rc


@pytest.mark.parametrize("smoother,bottom", [
    ("chebyshev", "direct"), ("jacobi", "direct"), ("l1jacobi", "direct"),
    ("symgs", "direct"), ("gsrb", "cg"), ("gsrb", "cabicgstab"), ("gsrb", "cacg"),
    ("gsrb", "smooth")])
def test_solver_options_match_cpu(dev, smoother, bottom):
    """32^3 f64 fv4 F-cycle with each smoother and bottom solver of the
    CLI through the kernels, against the same F-cycle on the CPU."""
    from hpgmg_tpu_torch.core.config import Smoother

    cfg = SolverConfig(op="fv4", a=0.0, dtype=torch.float64, smoother=Smoother(smoother),
                       bottom=BottomSolver(bottom), min_coarse_dim=8)
    sols = []
    for device in (dev, torch.device("cpu")):
        hier, f = build(32, cfg, device)
        u, nr, nf = fmg_solve(get_suite("fv4"), hier, f, cfg)
        sols.append((u.cpu(), float(nr) / float(nf)))
    (ug, rg), (uc, rc) = sols
    assert relerr(ug, uc) <= 1e-10
    assert abs(rg - rc) <= 1e-6 * rc


@pytest.mark.parametrize("op", ["fv4", "fv7pt", "fv2", "27pt"])
def test_periodic_fcycle_through_kernels_matches_cpu(dev, op):
    """32^3 f64 periodic: K7a or K7b in every apply, half-sweep, residual
    restriction and DIRECT-bottom probe (pseudo-inverted), against the same
    F-cycle on the CPU; u is mean-free on both."""
    cfg = SolverConfig(op=op, a=0.0, bc=BC.PERIODIC, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    sols = []
    for device in (dev, torch.device("cpu")):
        hier, f = build(32, cfg, device)
        u, nr, nf = fmg_solve(get_suite(op), hier, f, cfg)
        sols.append((u.cpu(), float(nr) / float(nf)))
    (ug, rg), (uc, rc) = sols
    assert relerr(ug, uc) <= 1e-10
    assert abs(rg - rc) <= 1e-6 * rc
    assert abs(float(ug.mean())) <= 1e-12 * float(ug.abs().max())


def test_fcycle_other_tail_setting_matches_cpu(dev, monkeypatch):
    """64^3 f64 fv4 with tail.TAIL_ONE_LAUNCH flipped from its default: the
    V-cycles from 32^3 and 16^3 run K4c (or K4a + matvec + K4b) over the
    built hierarchy's DIRECT bottom, against the same F-cycle on the CPU."""
    monkeypatch.setattr(T, "TAIL_ONE_LAUNCH", not T.TAIL_ONE_LAUNCH)
    cfg = SolverConfig(op="fv4", a=0.0, dtype=torch.float64,
                       bottom=BottomSolver.DIRECT, min_coarse_dim=8)
    launches = T.tail_v_cuda.launches
    sols = []
    for device in (dev, torch.device("cpu")):
        hier, f = build(64, cfg, device)
        u, nr, nf = fmg_solve(get_suite("fv4"), hier, f, cfg)
        sols.append((u.cpu(), float(nr) / float(nf)))
    assert (T.tail_v_cuda.launches > launches) == T.TAIL_ONE_LAUNCH
    (ug, rg), (uc, rc) = sols
    assert relerr(ug, uc) <= 1e-10
    assert abs(rg - rc) <= 1e-6 * rc
