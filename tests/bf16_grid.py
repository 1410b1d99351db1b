"""The JAX side and the measures of the port's bfloat16 tests on process
grids (tests/test_torch_bf16_mesh.py: the 2x2 grid; tests/
test_torch_bf16_mesh3d.py: the (2,2,2) grid).

Both packages compute on the same bf16 fields: the JAX package builds each
bf16 hierarchy (its XLA path, kernels="xla"), and its levels are carried
into the port (``levels_of``: float32 copies, exact) for the ranks
(tests/torch_ranks.py:bf16_grid_body) and for the port's one-rank runs
here. The references, computed here while the ranks run:

* whole-level operators on the suite's finest level: the port's bf16
  plain versions (the rounding the slab kernels follow), the JAX
  package's bf16 operators, and the JAX package's operators in float32 on
  the same bf16 inputs, rounded to bf16 once (what a float32 computation
  of the bf16 inputs gives);
* F-cycles: the port's one-rank bf16 F-cycle on the carried hierarchy,
  the JAX package's serial bf16 F-cycle (its sharded run equals it, see
  PERF.md), and for 27pt the float32 witness of
  tests/test_torch_bf16_r1.py (JAX's bf16 27pt operator rounds far from
  both packages' float32 sums).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hpgmg_tpu.bench.driver import _build_problem as jproblem
from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.hierarchy import build_hierarchy as jbuild
from hpgmg_tpu.core.level import rb_mask as jrb_mask
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.ops.transfer import restrict_cell as jrestrict
from hpgmg_tpu.solve.mg import fmg_solve as jfmg
from hpgmg_tpu_torch.core.config import BC, BottomSolver, SolverConfig
from hpgmg_tpu_torch.interop import hierarchy_from_numpy
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import stencils_r1 as K
from hpgmg_tpu_torch.kernels import tail
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import fmg_solve

import torch_ranks

BF = jnp.bfloat16
FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "l1inv", "lambda_max")
SEED = 2020


def jcfg(op: str, bc: str, mcd: int, dtype=BF) -> JConfig:
    return JConfig(op=op, a=0.0, b=1.0, dtype=dtype, kernels="xla", bc=JBC(bc),
                   bottom=JBottom.BICGSTAB, min_coarse_dim=mcd)


def pcfg(op: str, bc: str, mcd: int) -> SolverConfig:
    return SolverConfig(op=op, a=0.0, b=1.0, dtype=torch.bfloat16, bc=BC(bc),
                        bottom=BottomSolver.BICGSTAB, min_coarse_dim=mcd)


def as_f32(a) -> np.ndarray:
    """A JAX bf16 array as float32 numpy (exact)."""
    return np.asarray(a).astype(np.float32)


def levels_of(jh) -> list:
    """The JAX hierarchy's levels as the picklable dicts
    ``interop.hierarchy_from_numpy`` takes (float32 arrays holding the bf16
    values)."""
    return [{"dim": lv.dim, "h": lv.h, "depth": lv.depth,
             **{f: as_f32(getattr(lv, f)) for f in FIELDS if getattr(lv, f) is not None},
             "kdinv": (None if lv.kdinv is None else tuple(as_f32(k) for k in lv.kdinv))}
            for lv in jh.levels]


@functools.lru_cache(maxsize=None)
def build(op: str, bc: str, n: int, mcd: int):
    """The suite's bf16 benchmark problem at n^3 and the JAX package's
    hierarchy of it down to ``mcd``: (problem, hierarchy, carried levels)."""
    jc = jcfg(op, bc, mcd)
    prob = jproblem(n, jc)
    jh = jbuild(prob.beta_i, prob.beta_j, prob.beta_k, jc, alpha=prob.alpha)
    return prob, jh, levels_of(jh)


def fcycle_job(case):
    """(case, carried levels, rhs) of ``bf16_grid_body``'s F-cycle."""
    prob, _, levels = build(*case)
    return case, levels, as_f32(prob.f)


def slab_job(label: str, op: str, bc: str, n: int):
    """(label, op, bc, carried levels, seed) of ``bf16_grid_body``'s slab
    set: the suite's finest bf16 level at n^3, alone."""
    return label, op, bc, build(op, bc, n, n)[2], SEED


def port_level(op: str, bc: str, n: int):
    return hierarchy_from_numpy(build(op, bc, n, n)[2], pcfg(op, bc, n), "cpu").levels[0]


@functools.lru_cache(maxsize=None)
def whole_level_refs(op: str, bc: str, n: int) -> dict:
    """The references of each slab output on the whole level, by (kernel,
    mode, parity): (the port's bf16 plain version, JAX's bf16 operator,
    JAX's float32 operator on the bf16 inputs rounded to bf16), each an
    n^3 (fres (n/2)^3) float32 array; x and rhs ``bf16_field``'s."""
    _, jh, _ = build(op, bc, n, n)
    jl, pl, cfg = jh.levels[0], port_level(op, bc, n), pcfg(op, bc, n)
    x, rhs = (torch_ranks.bf16_field(n, SEED + d) for d in (0, 1))
    jx, jr = (jnp.asarray(t.float().numpy(), BF) for t in (x, rhs))
    j32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if hasattr(a, "dtype") and a.dtype == BF else a, jl)

    suite = get_suite(op)
    sweep = bc == "dirichlet" and op != "fv4" and suite.var7
    want = [("apply", None), ("residual", None), ("gsrb", 0), ("gsrb", 1)]
    want += [] if op == "fv4" else [("fres", None)] + [("sweep", None)] * sweep

    def jax_ops(level, xx, rr, jc):
        J = jsuite(op)

        def half(v, p):
            # the JAX XLA path's half-sweep (hpgmg_tpu/solve/smoothers.py:gsrb)
            return v + jrb_mask(n, p, xx.dtype) * level.dinv * (rr - J.apply_op(level, v, jc))
        ops = {"apply": lambda p: J.apply_op(level, xx, jc),
               "residual": lambda p: J.residual(level, xx, rr, jc),
               "fres": lambda p: jrestrict(J.residual(level, xx, rr, jc)),
               "gsrb": lambda p: half(xx, p),
               "sweep": lambda p: half(half(xx, 0).astype(BF).astype(xx.dtype), 1)}
        return {(m, p): as_f32(ops[m](p).astype(BF)) for m, p in want}

    jbf = jax_ops(jl, jx, jr, jcfg(op, bc, n))
    jf32 = jax_ops(j32, jx.astype(jnp.float32), jr.astype(jnp.float32),
                   jcfg(op, bc, n, jnp.float32))
    out = {}
    if op == "fv4":
        for mode, p in (("apply", None), ("residual", None), ("gsrb", 0), ("gsrb", 1)):
            kw = {} if mode == "apply" else {"rhs": rhs}
            if mode == "gsrb":
                kw["kdinv"] = pl.kdinv[p]
            want = S.fv4_stencil_plain(pl, x, cfg, mode, **kw).float().numpy()
            for kern in ("K8a", "K8b"):
                out[(kern, mode, p)] = (want, jbf[(mode, p)], jf32[(mode, p)])
        return out
    for mode, p in (("apply", None), ("residual", None), ("gsrb", 0), ("gsrb", 1),
                    ("fres", None)):
        kw = {} if mode == "apply" else {"rhs": rhs}
        if mode == "gsrb":
            kw.update(kdinv=pl.kdinv[p], parity=p)
        want = K.r1_stencil_plain(pl, x, cfg, mode, suite.taps_key, suite.var7, **kw)
        out[("K8c", mode, p)] = (want.float().numpy(), jbf[(mode, p)], jf32[(mode, p)])
    if sweep:
        want = K.r1_gsrb2_plain(pl, x, rhs, cfg, suite.taps_key, suite.var7)
        out[("K8d", "sweep", None)] = (want.float().numpy(), jbf[("sweep", None)],
                                       jf32[("sweep", None)])
    return out


@functools.lru_cache(maxsize=None)
def one_rank_fcycle(case):
    """The port's one-rank bf16 F-cycle on the carried hierarchy through
    the operations a process grid runs (the K4 tail fusion off, as
    kernels/tail.py:use_tail has it under a mesh): (u as float32 numpy,
    rel_residual)."""
    op, bc, n, mcd = case
    prob, _, levels = build(*case)
    cfg = pcfg(op, bc, mcd)
    hier = hierarchy_from_numpy(levels, cfg, "cpu")
    f = torch.tensor(as_f32(prob.f)).to(torch.bfloat16)
    fuse, tail.TAIL_FUSE = tail.TAIL_FUSE, False
    try:
        u, nr, nf = fmg_solve(get_suite(op), hier, f, cfg)
    finally:
        tail.TAIL_FUSE = fuse
    return u.float().numpy(), float(nr) / float(nf)


@functools.lru_cache(maxsize=None)
def jax_fcycle(case, witness: bool = False):
    """The JAX package's serial F-cycle on its bf16 hierarchy: (u as float32
    numpy, rel_residual); ``witness``: its F-cycle in float32 on the same
    bf16 arrays widened, u rounded to bf16 (tests/test_torch_bf16_r1.py:
    witness_fcycles), rel_residual that of the rounded u through the port's
    bf16 residual."""
    op, bc, n, mcd = case
    prob, jh, _ = build(*case)
    if not witness:
        jc = jcfg(op, bc, mcd)
        u, nr, nf = jax.jit(lambda h, f: jfmg(jsuite(op), h, f, jc))(jh, prob.f)
        return as_f32(u), float(nr) / float(nf)
    j32 = dataclasses.replace(jcfg(op, bc, mcd), dtype=jnp.float32)
    bi, bj, bk, alpha, f32 = (a.astype(jnp.float32) for a in
                              (prob.beta_i, prob.beta_j, prob.beta_k, prob.alpha, prob.f))
    u = jax.jit(lambda h, f: jfmg(jsuite(op), h, f, j32))(
        jbuild(bi, bj, bk, j32, alpha=alpha), f32)[0].astype(BF)
    cfg = pcfg(op, bc, mcd)
    hier = hierarchy_from_numpy(build(*case)[2], cfg, "cpu")
    ub = torch.tensor(as_f32(u)).to(torch.bfloat16)
    fb = torch.tensor(as_f32(prob.f)).to(torch.bfloat16)
    suite = get_suite(op)
    nr = float(suite.residual(hier.levels[0], ub, fb, cfg).abs().max())
    return as_f32(u), nr / float(fb.abs().max())


def units(got, ref) -> float:
    """max|got - ref| in units of 2^-8 max|ref|: the bf16 spacing at the
    largest value."""
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - ref))
                 / (2.0 ** -8 * np.max(np.abs(ref))))


def cell_ulps(got, ref) -> np.ndarray:
    """|got - ref| at each cell in bf16 units in the last place of ref, a
    unit at least 1e-5 max|ref| (tests/test_torch_cuda_bf16.py:ulps)."""
    ref = np.asarray(ref, np.float32)
    unit = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    unit = np.maximum(unit, 1e-5 * np.max(np.abs(ref)))
    return np.abs(np.asarray(got, np.float32) - ref) / unit


# The bounds the whole-level bf16 plain versions are held to against the
# JAX package's bf16 operators (tests/test_torch_bf16.py TOL for fv4 on
# Dirichlet levels, tests/test_torch_bf16_r1.py TOL for the radius-1
# suites, tests/test_torch_bf16_periodic.py TOL on periodic levels), in
# units of 2^-8 max|JAX|; "sweep" is K6's (K8d's) full sweep
JAX_OP_TOL = {
    ("fv4", "dirichlet"): {"apply": 8.0, "residual": 8.0, "gsrb": 8.0},
    ("fv4", "periodic"): {"apply": 4.0, "residual": 4.0, "gsrb": 5.0},
    ("fv7pt", "dirichlet"): {"apply": 4.0, "residual": 4.0, "gsrb": 4.0, "fres": 5.0,
                             "sweep": 12.0},
    ("fv2", "dirichlet"): {"apply": 4.0, "residual": 4.0, "gsrb": 5.0, "fres": 6.0,
                           "sweep": 12.0},
    ("27pt", "dirichlet"): {"apply": 7.0, "residual": 7.0, "gsrb": 7.0, "fres": 6.0},
    ("fv7pt", "periodic"): {"apply": 4.5, "residual": 4.5, "gsrb": 5.5, "fres": 4.5},
}
# The bounds the one-rank bf16 F-cycle is held to against the JAX
# package's at 16^3 (the same three files: U_TOL and RES_BAND; 27pt
# against the float32 witness, WITNESS_TOL): (u units of 2^-8 max|JAX|,
# rel_residual factor)
JAX_FCYCLE_TOL = {
    ("fv4", "dirichlet"): (6.0, 2.0),
    ("fv7pt", "dirichlet"): (3.0, 2.0),
    ("fv2", "dirichlet"): (3.5, 2.0),
    ("fv4", "periodic"): (3.5, 2.0),
    ("fv7pt", "periodic"): (5.0, 2.0),
    ("27pt", "dirichlet"): (3.5, 2.0),
    ("27pt", "periodic"): (2.0, 2.5),
}
def hold_slab_set(ranks, label: str, op: str, bc: str, n: int):
    """Every rank's slab outputs of ``label`` (``bf16_slab_outputs``)
    against ``whole_level_refs`` cut to its block: bf16 and bit for bit the
    port's whole-level bf16 plain version at every cell (a bf16 block's
    slabs are float32: the neighbours' cells exact, a Dirichlet domain
    face's ghosts unrounded, as the whole level makes them); within
    JAX_OP_TOL of the JAX package's bf16 operator and within one bf16 unit
    in the last place of each cell of JAX's float32 operator on the same
    inputs rounded to bf16; K8b equal to K8a bit for bit. Returns the worst
    measures by output."""
    refs = whole_level_refs(op, bc, n)
    worst = {}
    for res in ranks:
        s = res[("slabs", label)]
        assert s["dtype"] == torch.bfloat16
        for key, (port, jbf, jf32) in refs.items():
            if key not in s:
                continue
            out = s[key]
            assert out.dtype == torch.bfloat16, key
            out = out.float().numpy()
            off = tuple(o // 2 for o in s["offsets"]) if key[1] == "fres" else s["offsets"]
            box = tuple(slice(o, o + e) for o, e in zip(off, out.shape))
            assert np.array_equal(out, port[box]), (label, key)
            w = worst.setdefault(key, [0.0, 0.0])
            w[0] = max(w[0], units(out, jbf[box]))
            w[1] = max(w[1], float(cell_ulps(out, jf32[box]).max()))
            if key[0] == "K8b":
                assert np.array_equal(out, s[("K8a",) + key[1:]].float().numpy()), key
    assert worst, label
    for key, (jax_units, f32_ulps) in worst.items():
        assert jax_units <= JAX_OP_TOL[op, bc][key[1]], (label, key, jax_units)
        assert f32_ulps <= 1.0, (label, key, f32_ulps)
    return worst


def hold_fcycle(res, case, one_rank_units: float):
    """The decomposed bf16 F-cycle (rank 0's ``bf16_grid_body`` result)
    against the port's one-rank F-cycle on the same carried hierarchy
    (u within ``one_rank_units`` units of 2^-8 max|u_one|, rel_residual
    within 5%) and against the JAX package's serial F-cycle (27pt: its
    float32 witness) within JAX_FCYCLE_TOL; returns (units vs one rank,
    units vs JAX)."""
    op, bc = case[:2]
    u = res["u"]
    assert u.dtype == torch.bfloat16 and bool(torch.isfinite(u).all())
    u = u.float().numpy()
    u1, rel1 = one_rank_fcycle(case)
    ju, jrel = jax_fcycle(case, witness=op == "27pt")
    g1, gj = units(u, u1), units(u, ju)
    u_tol, res_band = JAX_FCYCLE_TOL[op, bc]
    assert g1 <= one_rank_units, (case, g1)
    assert abs(res["rel"] - rel1) <= 0.05 * rel1, (case, res["rel"], rel1)
    assert gj <= u_tol, (case, gj)
    assert jrel / res_band <= res["rel"] <= jrel * res_band, (case, res["rel"], jrel)
    return g1, gj


def hold_launches(res, case):
    """The decomposed levels ran the slab kernels' plain versions (K8d's
    too on the var7 body's Dirichlet levels) and no whole-level stencil:
    every whole-level plain version ran on replicated levels only."""
    op, bc = case[:2]
    calls, dims = res["plain_calls"], res["whole_level_dims"]
    decomposed = {case[2] >> d for d, s in enumerate(res["split"]) if s is not None}
    assert decomposed, case
    want = ["fv4_slab_plain"] if op == "fv4" else ["r1_slab_plain"]
    if op in ("fv7pt", "fv2") and bc == "dirichlet":
        want.append("r1_gsrb2_slab_plain")
    for name in want:
        assert calls.get(name, 0) > 0, (case, calls)
    for name, on in dims.items():
        assert not set(on) & decomposed, (case, name, on, decomposed)
