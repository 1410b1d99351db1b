#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hpgmg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result and raising on failure (exit code != 0):

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
   no CUDA device is a failure;
2. nvcc builds the kernels from hpgmg_tpu_torch/kernels/csrc;
3. each kernel against its plain PyTorch version on random inputs from
   numpy.random.default_rng, float32 and float64, max|kernel - plain| /
   max|plain| <= 1e-12 (f64) or 1e-5 (f32: the kernels and the plain
   versions sum in different orders): K1 (the ghost pass, and the stencil
   in apply, residual, gsrb for both parities, fres, apply with the
   a*alpha*x term), K2 (full red+black sweep) and K3 (cell restriction) at
   n in {8, 16, 32, 48, 64, 128, 256}; K4 (tail descent and climb) on the
   tail ladders 32-16 and 16 over an 8^3 bottom; then kernel vs plain
   times, with the same error check, at 64^3, 128^3 and 512^3 (K4 at
   32-16); the kernels line reports each kernel at a size the main path
   runs it at (K2 smooths the levels up to 64^3, the others run at 512^3);
   K5 (the radius-1 stencil: var7 body with the fv7pt and fv2 ghost taps,
   every mode, with and without a*alpha*x; 27pt body, every mode, with and
   without its constant a*x) and K6 (full red+black sweep, both bodies,
   all three tap sets) at n in {8, 16, 32, 48, 64, 128, 256}, then their
   times at 64^3, 128^3, 256^3 and 512^3 on the fv7pt and 27pt problems'
   own levels;
4. the headline solve through the port's own entry point: run_benchmark at
   512^3, fv4, GSRB, DIRECT bottom, min_coarse_dim 8, float32,
   dynamic_range 3, with every kernel's launch count reset before it and
   read after it: rel_residual <= 1e-3, Richardson order >= 3.0, every
   kernel (K1's two passes, K2, K3, K4's two halves) launched, no plain
   version called; then the BiCGStab-bottom companion;
5. the radius-1 suites through the same entry point at 512^3 float32, the
   counts reset before each and read after it: fv7pt (this slice's
   headline), then fv2 and 27pt on shorter timed chains: rel_residual
   <= 1e-2, Richardson order in (1.5, 2.6), K5 and K3 launched (and K6 for
   fv7pt and fv2, whose var7 body it smooths), no plain version called;
6. float64 verification through the kernels: fv4 at 256^3 with Richardson
   order >= 3.8; fv7pt at 256^3, fv2 and 27pt at 128^3 with order in
   (1.8, 2.3).

The line before the last lists the kernels as JSON: for each, its launches
on its path, its time, its plain version's time, its bound on the card
(the larger of its bytes over 3.35 TB/s and its flops over 67 TFLOP/s f32,
the H100 SXM's published peaks) and, where one PyTorch call computes the
same function, that call's time. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs one card and imports nothing of JAX.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
F64_TOL, F32_TOL = 1e-12, 1e-5
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12  # H100 SXM, published

# flops per cell, counted from the stencils' expressions: fv4 (main 35,
# mixed 72, scale 3), its modes' extra work, the radius-1 bodies (var7:
# 6 differences, 6 products, 5 adds, the scale; 27pt: 26 adds, 4 products,
# 3 adds, a*x and the scale) and a gsrb update (sub, mul, add)
FV4_AX, VAR7_AX, P27_AX, GSRB = 110, 18, 36, 3


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def relerr(out: torch.Tensor, ref: torch.Tensor):
    diff = (out - ref).abs().max().item()
    return diff / ref.abs().max().item(), diff


def time_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_level(n: int, dtype, device, rng):
    """A level of random positive face coefficients (stored tangentially
    extended, as rebuild_operator leaves them), random alpha and a
    parity-folded random diagonal of the operator's scale (~h^2/8)."""
    from hpgmg_tpu_torch.core.level import Level, rb_mask

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    beta = [t(1.0 + 0.25 * rng.random(s)) for s in
            ((n + 1, n + 2, n + 2), (n + 2, n + 1, n + 2), (n + 2, n + 2, n + 1))]
    dinv = t((0.5 + rng.random((n, n, n))) / (8.0 * n * n))
    kdinv = tuple(rb_mask(n, p, dtype, device) * dinv for p in (0, 1))
    return Level(dim=n, h=1.0 / n, depth=0, beta_i=beta[0], beta_j=beta[1],
                 beta_k=beta[2], alpha=t(rng.random((n, n, n))), dinv=dinv,
                 kdinv=kdinv)


def check(label: str, out, ref, tol: float, worst: dict, name: str):
    """Raise unless max|out - ref| / max|ref| <= tol; keep the worst."""
    rel, _ = relerr(out, ref)
    print(f"  {label}: rel err {rel:.3e}")
    if not rel <= tol:
        raise AssertionError(f"{label}: {rel} > {tol}")
    worst[name] = max(worst.get(name, 0.0), rel)


def check_kernels(worst: dict, sizes=(8, 16, 32, 48, 64, 128, 256)):
    """Phase 3a: every kernel mode against its plain version, at the sizes
    the main path gives it (the fused-restriction and smoother levels run
    from 512 down; 256 and up span several blocks along k)."""
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.kernels import restrict as R
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.ops.bc_fv import ghost_fill_fv

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        dn = str(dtype)[6:]
        for n in sizes:
            lv = random_level(n, dtype, dev, rng)
            x = torch.tensor(rng.standard_normal((n, n, n)), dtype=dtype, device=dev)
            rhs = torch.tensor(rng.standard_normal((n, n, n)), dtype=dtype, device=dev)
            poisson = SolverConfig(a=0.0, b=1.0, dtype=dtype)
            helm = SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype)
            check(f"K1 ghost pass  n={n:3d} {dn}", S.fv4_ghost_fill_cuda(x),
                  ghost_fill_fv(x, BC.DIRICHLET, order=4, radius=2), tol, worst,
                  "fv4_ghost_fill")
            cases = [("apply", "apply", poisson, {}),
                     ("residual", "residual", poisson, {"rhs": rhs}),
                     ("gsrb0", "gsrb", poisson, {"rhs": rhs, "kdinv": lv.kdinv[0]}),
                     ("gsrb1", "gsrb", poisson, {"rhs": rhs, "kdinv": lv.kdinv[1]}),
                     ("fres", "fres", poisson, {"rhs": rhs}),
                     ("apply+alpha", "apply", helm, {})]
            for label, mode, cfg, kw in cases:
                check(f"K1 {label:11s} n={n:3d} {dn}",
                      S.fv4_stencil_cuda(lv, x, cfg, mode, **kw),
                      S.fv4_stencil_plain(lv, x, cfg, mode, **kw), tol, worst,
                      "fv4_stencil")
            for label, cfg in (("", poisson), ("+alpha", helm)):
                check(f"K2 gsrb2{label:6s}  n={n:3d} {dn}",
                      S.fv4_gsrb2_cuda(lv, x, rhs, cfg),
                      S.fv4_gsrb2_plain(lv, x, rhs, cfg), tol, worst, "fv4_gsrb2")
            check(f"K3 restrict    n={n:3d} {dn}", R.restrict_cell_cuda(x),
                  R.restrict_cell_plain(x), tol, worst, "restrict_cell")
            del lv, x, rhs
    check_tail(worst)


def check_tail(worst: dict, ladders=((32, 16), (16,))):
    """Phase 3a, K4: the descent and the climb over a tail ladder of random
    levels against their plain versions (6 half-sweeps per level, the
    fv4 GSRB count)."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.kernels import tail as T

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        dn = str(dtype)[6:]
        for dims in ladders:
            for label, cfg in (("", SolverConfig(a=0.0, b=1.0, dtype=dtype)),
                               ("+alpha", SolverConfig(a=1.5, b=1.0, helmholtz=True,
                                                       dtype=dtype))):
                tail = [random_level(d, dtype, dev, rng) for d in dims]
                e, rhs = (torch.tensor(a, dtype=dtype, device=dev)
                          for a in rng.standard_normal((2,) + tail[0].shape))
                tag = f"{'-'.join(map(str, dims))} {dn}{label}"
                es_k, rs_k = T.tail_down_cuda(tail, e, rhs, cfg, 6)
                es_p, rs_p = T.tail_down_plain(tail, e, rhs, cfg, 6)
                for i in range(len(dims)):
                    check(f"K4 down e[{i}]    {tag}", es_k[i], es_p[i], tol, worst,
                          "tail_down")
                    check(f"K4 down rhs[{i}]  {tag}", rs_k[i], rs_p[i], tol, worst,
                          "tail_down")
                d = dims[-1] // 2
                u_bot = torch.tensor(rng.standard_normal((d, d, d)), dtype=dtype,
                                     device=dev)
                rhss = [rhs] + rs_p[:-1]
                check(f"K4 up           {tag}",
                      T.tail_up_cuda(tail, es_p, rhss, u_bot, cfg, 6),
                      T.tail_up_plain(tail, es_p, rhss, u_bot, cfg, 6), tol, worst,
                      "tail_up")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes_`` and do ``flops`` f32 operations."""
    t_b, t_f = nbytes_ / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def time_pair(label: str, kernel, plain, reps: int, row: dict, key: str,
              work=(0, 0), library=None):
    """Time ``kernel`` and ``plain`` (and ``library``, one PyTorch call
    computing the same function, where there is one) with CUDA events, check
    them against each other at the float32 tolerance, and record the times,
    the max abs error and the bound of ``work`` = (bytes, flops)."""
    k_ms = time_ms(kernel, reps)
    p_ms = time_ms(plain, reps)
    lib_ms = time_ms(library, reps) if library is not None else None
    out, ref = kernel(), plain()
    if isinstance(out, (tuple, list)):
        out, ref = torch.cat([t.flatten() for t in out[0] + out[1]]), \
            torch.cat([t.flatten() for t in ref[0] + ref[1]])
    rel, err = relerr(out, ref)
    if library is not None:
        lib_rel, _ = relerr(library(), ref)
        if not lib_rel <= F32_TOL:
            raise AssertionError(f"{label}: library call rel err {lib_rel}")
    b_ms, b_by = bound(*work)
    print(f"  {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          + (f"library {lib_ms:.4f} ms, " if lib_ms is not None else "")
          + f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3e}, rel err {rel:.3e}")
    if not rel <= F32_TOL:
        raise AssertionError(f"{label}: rel err {rel} > {F32_TOL}")
    row[key] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def time_kernels(sizes=(64, 128, 512)):
    """Phase 3b: kernel vs plain time on the benchmark's own coefficients
    (float32), each pair checked against F32_TOL. Returns per size (and
    "tail" for K4 on the 32-16 ladder) {key: (ms, plain ms, max abs err)}."""
    from hpgmg_tpu_torch.bench.driver import build as build_bench
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.core.level import Level
    from hpgmg_tpu_torch.kernels import restrict as R
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import tail as T
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.ops.bc_fv import ghost_fill_fv
    from hpgmg_tpu_torch.problems.fv import init_problem_fv

    dev = torch.device("cuda")
    cfg = SolverConfig(a=0.0, b=1.0, dtype=torch.float32)
    res = {}
    for n in sizes:
        prob = init_problem_fv(n, torch.float32, dev)
        lv = get_suite("fv4").rebuild_operator(
            Level(dim=n, h=1.0 / n, depth=0, beta_i=prob.beta_i,
                  beta_j=prob.beta_j, beta_k=prob.beta_k), cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn((n, n, n), generator=gen, device=dev)
        rhs = prob.f
        reps = 20 if n <= 128 else 5
        row = {}
        cells, betas = n ** 3, nbytes(lv.beta_i, lv.beta_j, lv.beta_k)
        time_pair(f"K1 ghost pass {n}^3 f32", lambda: S.fv4_ghost_fill_cuda(x),
                  lambda: ghost_fill_fv(x, BC.DIRICHLET, order=4, radius=2),
                  reps, row, "ghost", work=(4 * (cells + (n + 4) ** 3), 0))
        for mode, kw in (("apply", {}), ("residual", {"rhs": rhs}),
                         ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}),
                         ("fres", {"rhs": rhs})):
            out_cells = cells // 8 if mode == "fres" else cells
            work = (nbytes(x, *kw.values()) + betas + 4 * out_cells,
                    (FV4_AX + (GSRB if mode == "gsrb" else 2)) * cells)
            time_pair(f"K1 {mode:8s} {n}^3 f32",
                      lambda: S.fv4_stencil_cuda(lv, x, cfg, mode, **kw),
                      lambda: S.fv4_stencil_plain(lv, x, cfg, mode, **kw),
                      reps, row, mode, work=work)
        time_pair(f"K2 gsrb2 {n}^3 f32", lambda: S.fv4_gsrb2_cuda(lv, x, rhs, cfg),
                  lambda: S.fv4_gsrb2_plain(lv, x, rhs, cfg), reps, row, "gsrb2",
                  work=(nbytes(x, rhs, *lv.kdinv, x) + betas,
                        2 * (FV4_AX + GSRB) * cells))
        time_pair(f"K3 restrict {n}^3 f32", lambda: R.restrict_cell_cuda(x),
                  lambda: R.restrict_cell_plain(x), reps * 4, row, "restrict",
                  work=(4 * (cells + cells // 8), cells),
                  library=lambda: torch.nn.functional.avg_pool3d(x[None, None], 2)[0, 0])
        res[n] = row
        del prob, lv, x, rhs
        torch.cuda.empty_cache()
    # K4 on the headline's own tail (32-16 above the 8^3 bottom)
    hier, _ = build_bench(64, dataclasses.replace(cfg, min_coarse_dim=8), dev)
    tail = hier.levels[1:3]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    e, rhs = (torch.randn(tail[0].shape, generator=gen, device=dev) for _ in range(2))
    row = {}
    coefs = sum(nbytes(lv.beta_i, lv.beta_j, lv.beta_k, *lv.kdinv) for lv in tail)
    sweeps = sum(6 * (FV4_AX + GSRB) * lv.ncells for lv in tail)
    es, rs = T.tail_down_plain(tail, e, rhs, cfg, 6)
    time_pair("K4 down 32-16 f32", lambda: T.tail_down_cuda(tail, e, rhs, cfg, 6),
              lambda: T.tail_down_plain(tail, e, rhs, cfg, 6), 50, row, "tail_down",
              work=(coefs + nbytes(e, rhs, *es, *rs),
                    sweeps + sum((FV4_AX + 2) * lv.ncells for lv in tail)))
    u_bot = torch.randn((8, 8, 8), generator=gen, device=dev)
    time_pair("K4 up 32-16 f32",
              lambda: T.tail_up_cuda(tail, es, [rhs, rs[0]], u_bot, cfg, 6),
              lambda: T.tail_up_plain(tail, es, [rhs, rs[0]], u_bot, cfg, 6),
              50, row, "tail_up",
              work=(coefs + nbytes(*es, rhs, rs[0], u_bot, e),
                    sweeps + sum(16 * lv.ncells for lv in tail)))
    res["tail"] = row
    return res


def random_level_r1(n: int, dtype, device, rng):
    """A radius-1 level: random positive natural face arrays, random alpha
    and a parity-folded random diagonal of the operator's scale."""
    from hpgmg_tpu_torch.core.level import Level, rb_mask

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    beta = [t(1.0 + 0.25 * rng.random(s)) for s in
            ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1))]
    dinv = t((0.5 + rng.random((n, n, n))) / (8.0 * n * n))
    kdinv = tuple(rb_mask(n, p, dtype, device) * dinv for p in (0, 1))
    return Level(dim=n, h=1.0 / n, depth=0, beta_i=beta[0], beta_j=beta[1],
                 beta_k=beta[2], alpha=t(rng.random((n, n, n))), dinv=dinv,
                 kdinv=kdinv)


# (label, taps, var7, helmholtz): the bodies and tap sets of the three
# suites; a*alpha*x for var7 under helmholtz, the constant a*x for 27pt
R1_BODIES = (("var7 p1", "p1", True, False), ("var7 v2", "v2", True, False),
             ("var7 p1+alpha", "p1", True, True), ("27pt", "27pt", False, False),
             ("27pt a=1.5", "27pt", False, True))


def check_r1_kernels(worst: dict, sizes=(8, 16, 32, 48, 64, 128, 256)):
    """Phase 3a, K5 and K6: every mode of K5 and K6's full sweep, for each
    body and tap set of R1_BODIES, against their plain versions."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        dn = str(dtype)[6:]
        for n in sizes:
            lv = random_level_r1(n, dtype, dev, rng)
            x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
                      for a in rng.standard_normal((2, n, n, n)))
            k5 = k6 = 0.0
            for label, taps, var7, helm in R1_BODIES:
                cfg = SolverConfig(a=1.5 if helm else 0.0, b=1.0, helmholtz=helm,
                                   dtype=dtype)
                for mode, kw in (("apply", {}), ("residual", {"rhs": rhs}),
                                 ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}),
                                 ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[1]}),
                                 ("fres", {"rhs": rhs})):
                    rel, _ = relerr(K.r1_stencil_cuda(lv, x, cfg, mode, taps, var7, **kw),
                                    K.r1_stencil_plain(lv, x, cfg, mode, taps, var7, **kw))
                    if not rel <= tol:
                        raise AssertionError(f"K5 {label} {mode} n={n} {dn}: {rel} > {tol}")
                    k5 = max(k5, rel)
                rel, _ = relerr(K.r1_gsrb2_cuda(lv, x, rhs, cfg, taps, var7),
                                K.r1_gsrb2_plain(lv, x, rhs, cfg, taps, var7))
                if not rel <= tol:
                    raise AssertionError(f"K6 {label} n={n} {dn}: {rel} > {tol}")
                k6 = max(k6, rel)
            print(f"  K5 (5 modes x {len(R1_BODIES)} bodies) n={n:3d} {dn}: worst rel err "
                  f"{k5:.3e}; K6 ({len(R1_BODIES)} bodies): {k6:.3e}")
            worst["r1_stencil"] = max(worst.get("r1_stencil", 0.0), k5)
            worst["r1_gsrb2"] = max(worst.get("r1_gsrb2", 0.0), k6)
            del lv, x, rhs


def time_r1_kernels(sizes=(64, 128, 256, 512)):
    """Phase 3b, K5 and K6: kernel vs plain time (float32) on the finest
    level of the fv7pt problem (p6 coefficients, var7 body, p1 taps) and of
    the 27pt problem, each pair checked against F32_TOL; the 27pt apply
    also against conv3d of the ghost-extended x, its library yardstick.
    Returns per size {key: timing}."""
    from hpgmg_tpu_torch.bench.driver import build_problem
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.core.level import Level
    from hpgmg_tpu_torch.kernels import stencils_r1 as K
    from hpgmg_tpu_torch.ops.base import get_suite

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    res = {}
    for n in sizes:
        cells, row = n ** 3, {}
        reps = 20 if n <= 128 else 5
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn((n, n, n), generator=gen, device=dev)
        for op, taps, var7 in (("fv7pt", "p1", True), ("27pt", "27pt", False)):
            cfg = SolverConfig(op=op, a=0.0, b=1.0, dtype=torch.float32)
            prob = build_problem(n, cfg, dev)
            lv = get_suite(op).rebuild_operator(
                Level(dim=n, h=1.0 / n, depth=0, beta_i=prob.beta_i,
                      beta_j=prob.beta_j, beta_k=prob.beta_k), cfg)
            rhs = prob.f
            betas = nbytes(lv.beta_i, lv.beta_j, lv.beta_k) if var7 else 0
            ax = VAR7_AX if var7 else P27_AX
            body = "var7" if var7 else "27pt"
            for mode, kw in (("apply", {}), ("residual", {"rhs": rhs}),
                             ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}),
                             ("fres", {"rhs": rhs})):
                out_cells = cells // 8 if mode == "fres" else cells
                work = (nbytes(x, *kw.values()) + betas + 4 * out_cells,
                        (ax + (GSRB if mode == "gsrb" else 1)) * cells)
                library = None
                if not var7 and mode == "apply":
                    d = torch.arange(3, device=dev).sub(1).abs()
                    m = d[:, None, None] + d[None, :, None] + d[None, None, :]
                    w = torch.tensor([K.C0, K.C1, K.C2, K.C3], device=dev)[m]
                    w = (-cfg.b * lv.h2inv * w)[None, None]
                    xg = K.ghost_fill_taps(x, "27pt", cfg.bc)[None, None]
                    library = lambda xg=xg, w=w: torch.nn.functional.conv3d(xg, w)[0, 0]  # noqa: E731
                time_pair(f"K5 {body} {mode:8s} {n}^3 f32",
                          lambda: K.r1_stencil_cuda(lv, x, cfg, mode, taps, var7, **kw),
                          lambda: K.r1_stencil_plain(lv, x, cfg, mode, taps, var7, **kw),
                          reps, row, f"{body} {mode}", work=work, library=library)
            time_pair(f"K6 {body} gsrb2 {n}^3 f32",
                      lambda: K.r1_gsrb2_cuda(lv, x, rhs, cfg, taps, var7),
                      lambda: K.r1_gsrb2_plain(lv, x, rhs, cfg, taps, var7),
                      reps, row, f"{body} gsrb2",
                      work=(nbytes(x, rhs, *lv.kdinv, x) + betas, 2 * (ax + GSRB) * cells))
            del prob, lv, rhs
        res[n] = row
        del x
        torch.cuda.empty_cache()
    return res


def _counters():
    """(name, wrapper) of every kernel's launch count and every plain
    version's call count."""
    from hpgmg_tpu_torch.kernels import restrict as R
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K
    from hpgmg_tpu_torch.kernels import tail as T

    kernels = [("fv4_ghost_fill", S.fv4_ghost_fill_cuda),
               ("fv4_stencil", S.fv4_stencil_cuda), ("fv4_gsrb2", S.fv4_gsrb2_cuda),
               ("tail_down", T.tail_down_cuda), ("tail_up", T.tail_up_cuda),
               ("restrict_cell", R.restrict_cell_cuda),
               ("r1_stencil", K.r1_stencil_cuda), ("r1_gsrb2", K.r1_gsrb2_cuda)]
    plains = [("fv4_stencil_plain", S.fv4_stencil_plain),
              ("fv4_gsrb2_plain", S.fv4_gsrb2_plain),
              ("tail_down_plain", T.tail_down_plain), ("tail_up_plain", T.tail_up_plain),
              ("restrict_cell_plain", R.restrict_cell_plain),
              ("r1_stencil_plain", K.r1_stencil_plain),
              ("r1_gsrb2_plain", K.r1_gsrb2_plain)]
    return kernels, plains


def reset_counts():
    kernels, plains = _counters()
    for _, fn in kernels:
        fn.launches = 0
    for _, fn in plains:
        fn.calls = 0


def read_counts():
    kernels, plains = _counters()
    return ({name: fn.launches for name, fn in kernels},
            {name: fn.calls for name, fn in plains})


def solve_cfg(bottom: str, dtype, op: str = "fv4"):
    from hpgmg_tpu_torch.core.config import BottomSolver, Smoother, SolverConfig

    return SolverConfig(op=op, a=0.0, b=1.0, smoother=Smoother.GSRB,
                        bottom=BottomSolver(bottom), min_coarse_dim=8, dtype=dtype)


# the kernels each suite's F-cycle must launch
PATH_KERNELS = {
    "fv4": ("fv4_ghost_fill", "fv4_stencil", "fv4_gsrb2", "tail_down", "tail_up",
            "restrict_cell"),
    "fv7pt": ("r1_stencil", "r1_gsrb2", "restrict_cell"),
    "fv2": ("r1_stencil", "r1_gsrb2", "restrict_cell"),
    "27pt": ("r1_stencil", "restrict_cell"),
}


def headline(op="fv4", n=512, min_solve_seconds=1.0, rel_limit=1e-3,
             order_range=(3.0, float("inf"))):
    """Phases 4 and 5: one suite's F-cycle through the port's entry point,
    with the launch counts reset before it and read after it."""
    from hpgmg_tpu_torch.bench.driver import run_benchmark

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = run_benchmark(n, solve_cfg("direct", torch.float32, op), "cuda",
                        min_solve_seconds=min_solve_seconds, dynamic_range=3)
    counts, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {op}: DOF/s {res.dof_per_second:.6e}, s/solve {res.seconds_per_solve:.6f}, "
          f"rel_residual {res.rel_residual:.6e}, order {res.richardson_order:.6f}, "
          f"peak memory {peak:.3f} GiB")
    print(f"  launches during the {op} run: {counts}; plain calls: {plain_calls}")
    if not res.rel_residual <= rel_limit:
        raise AssertionError(f"{op} rel_residual {res.rel_residual} > {rel_limit}")
    if not order_range[0] < res.richardson_order < order_range[1]:
        raise AssertionError(f"{op} Richardson order {res.richardson_order} outside "
                             f"{order_range}")
    missing = [k for k in PATH_KERNELS[op] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{op}: kernels of the path never launched: {missing}")
    if any(plain_calls.values()):
        raise AssertionError(f"{op}: a plain version ran on the path: {plain_calls}")
    return res, counts


def companion(n=512):
    from hpgmg_tpu_torch.bench.driver import run_benchmark

    res = run_benchmark(n, solve_cfg("bicgstab", torch.float32), "cuda",
                        min_solve_seconds=1.0)
    if not res.rel_residual <= 1e-3:
        raise AssertionError(f"BiCGStab companion rel_residual {res.rel_residual}")
    return res


def f64_order(op="fv4", n=256, order_range=(3.8, float("inf")),
              min_solve_seconds=0.5):
    from hpgmg_tpu_torch.bench.driver import run_benchmark

    res = run_benchmark(n, solve_cfg("direct", torch.float64, op), "cuda",
                        min_solve_seconds=min_solve_seconds, dynamic_range=3)
    print(f"  {op} f64 {n}^3: rel_residual {res.rel_residual:.6e}, "
          f"order {res.richardson_order:.6f}")
    if not order_range[0] < res.richardson_order < order_range[1]:
        raise AssertionError(f"{op} f64 {n}^3 Richardson order "
                             f"{res.richardson_order} outside {order_range}")
    return res


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels cannot run", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")

    from hpgmg_tpu_torch.kernels import build
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    phase("2 build")
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"  built {lib_path.name} in {time.perf_counter() - t0:.3f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    phase("3 kernels vs plain")
    worst = {}
    check_kernels(worst)
    check_r1_kernels(worst)
    times = time_kernels()
    r1_times = time_r1_kernels()
    torch.cuda.empty_cache()

    phase("4 headline fv4 F-cycle 512^3 f32, DIRECT bottom")
    res, counts = headline()
    torch.cuda.empty_cache()
    phase("4b BiCGStab-bottom companion 512^3 f32")
    res_b = companion()
    torch.cuda.empty_cache()

    phase("5 radius-1 F-cycles 512^3 f32, DIRECT bottom: fv7pt, fv2, 27pt")
    r1 = {}
    for op, secs in (("fv7pt", 1.0), ("fv2", 0.25), ("27pt", 0.25)):
        r1[op] = headline(op, min_solve_seconds=secs, rel_limit=1e-2,
                          order_range=(1.5, 2.6))
        torch.cuda.empty_cache()

    phase("6 f64 F-cycles through the kernels")
    res64 = f64_order()
    r1_64 = {op: f64_order(op, n, (1.8, 2.3), 0.25)
             for op, n in (("fv7pt", 256), ("fv2", 128), ("27pt", 128))}

    big = times[512]
    # K6 at the largest level it smooths on the path
    gsrb2_n = max((m for m in r1_times if m <= K.GSRB2_MAX_DIM), default=min(r1_times))
    rows = [
        # name, source, replaces, timed pair, launches
        ("fv4_ghost_fill", "fv4_stencil.cu", "hpgmg_tpu/kernels/stencils.py:594",
         big["ghost"], counts["fv4_ghost_fill"]),
        ("fv4_stencil", "fv4_stencil.cu", "hpgmg_tpu/kernels/stencils.py:594",
         big["fres"], counts["fv4_stencil"]),
        ("fv4_gsrb2", "fv4_gsrb2.cu", "hpgmg_tpu/kernels/stencils.py:1726",
         times[64]["gsrb2"], counts["fv4_gsrb2"]),
        ("tail_down", "tail.cu", "hpgmg_tpu/kernels/tail.py:273",
         times["tail"]["tail_down"], counts["tail_down"]),
        ("tail_up", "tail.cu", "hpgmg_tpu/kernels/tail.py:298",
         times["tail"]["tail_up"], counts["tail_up"]),
        ("restrict_cell", "restrict.cu", "hpgmg_tpu/kernels/restrict.py:77",
         big["restrict"], counts["restrict_cell"]),
        ("r1_stencil_var7", "r1_stencil.cu", "hpgmg_tpu/kernels/stencils_r1.py:364",
         r1_times[512]["var7 gsrb"], r1["fv7pt"][1]["r1_stencil"]),
        ("r1_stencil_27pt", "r1_stencil.cu", "hpgmg_tpu/kernels/stencils_r1.py:364",
         r1_times[512]["27pt apply"], r1["27pt"][1]["r1_stencil"]),
        ("r1_gsrb2", "r1_gsrb2.cu", "hpgmg_tpu/kernels/stencils_r1.py:783",
         r1_times[gsrb2_n]["var7 gsrb2"], r1["fv7pt"][1]["r1_gsrb2"]),
    ]
    kernels = [{"name": name, "route": "cuda",
                "source": f"hpgmg_tpu_torch/kernels/csrc/{src}", "replaces": rep,
                "launches": launches, **t}
               for name, src, rep, t, launches in rows]
    print(f"  worst relative errors over the checks: {worst}")
    print(json.dumps({"headline": {
        "dof_per_s": res.dof_per_second, "rel_residual": res.rel_residual,
        "richardson_order": res.richardson_order,
        "bicgstab_dof_per_s": res_b.dof_per_second,
        "f64_256_order": res64.richardson_order,
        "f64_256_dof_per_s": res64.dof_per_second,
        **{f"{op}_{key}": getattr(r[0], attr) for op, r in r1.items()
           for key, attr in (("dof_per_s", "dof_per_second"),
                             ("rel_residual", "rel_residual"),
                             ("richardson_order", "richardson_order"))},
        **{f"{op}_f64_{r.n}_order": r.richardson_order for op, r in r1_64.items()}}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
