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
4. the headline solve through the port's own entry point: run_benchmark at
   512^3, fv4, GSRB, DIRECT bottom, min_coarse_dim 8, float32,
   dynamic_range 3, with every kernel's launch count reset before it and
   read after it: rel_residual <= 1e-3, Richardson order >= 3.0, every
   kernel (K1's two passes, K2, K3, K4's two halves) launched, no plain
   version called; then the BiCGStab-bottom companion;
5. float64 verification: the F-cycle at 256^3 through the kernels, with
   Richardson order >= 3.8.

The line before the last lists the kernels as JSON; the last line is
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


def time_pair(label: str, kernel, plain, reps: int, row: dict, key: str):
    """Time ``kernel`` and ``plain`` (CUDA events), check them against each
    other at the float32 tolerance, and record (ms, plain ms, max abs err)."""
    k_ms = time_ms(kernel, reps)
    p_ms = time_ms(plain, reps)
    out, ref = kernel(), plain()
    if isinstance(out, (tuple, list)):
        out, ref = torch.cat([t.flatten() for t in out[0] + out[1]]), \
            torch.cat([t.flatten() for t in ref[0] + ref[1]])
    rel, err = relerr(out, ref)
    print(f"  {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"max abs err {err:.3e}, rel err {rel:.3e}")
    if not rel <= F32_TOL:
        raise AssertionError(f"{label}: rel err {rel} > {F32_TOL}")
    row[key] = (k_ms, p_ms, err)


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
        time_pair(f"K1 ghost pass {n}^3 f32", lambda: S.fv4_ghost_fill_cuda(x),
                  lambda: ghost_fill_fv(x, BC.DIRICHLET, order=4, radius=2),
                  reps, row, "ghost")
        for mode, kw in (("apply", {}), ("residual", {"rhs": rhs}),
                         ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}),
                         ("fres", {"rhs": rhs})):
            time_pair(f"K1 {mode:8s} {n}^3 f32",
                      lambda: S.fv4_stencil_cuda(lv, x, cfg, mode, **kw),
                      lambda: S.fv4_stencil_plain(lv, x, cfg, mode, **kw),
                      reps, row, mode)
        time_pair(f"K2 gsrb2 {n}^3 f32", lambda: S.fv4_gsrb2_cuda(lv, x, rhs, cfg),
                  lambda: S.fv4_gsrb2_plain(lv, x, rhs, cfg), reps, row, "gsrb2")
        time_pair(f"K3 restrict {n}^3 f32", lambda: R.restrict_cell_cuda(x),
                  lambda: R.restrict_cell_plain(x), reps * 4, row, "restrict")
        res[n] = row
        del prob, lv, x, rhs
        torch.cuda.empty_cache()
    # K4 on the headline's own tail (32-16 above the 8^3 bottom)
    hier, _ = build_bench(64, dataclasses.replace(cfg, min_coarse_dim=8), dev)
    tail = hier.levels[1:3]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    e, rhs = (torch.randn(tail[0].shape, generator=gen, device=dev) for _ in range(2))
    row = {}
    time_pair("K4 down 32-16 f32", lambda: T.tail_down_cuda(tail, e, rhs, cfg, 6),
              lambda: T.tail_down_plain(tail, e, rhs, cfg, 6), 50, row, "tail_down")
    es, rs = T.tail_down_plain(tail, e, rhs, cfg, 6)
    u_bot = torch.randn((8, 8, 8), generator=gen, device=dev)
    time_pair("K4 up 32-16 f32",
              lambda: T.tail_up_cuda(tail, es, [rhs, rs[0]], u_bot, cfg, 6),
              lambda: T.tail_up_plain(tail, es, [rhs, rs[0]], u_bot, cfg, 6),
              50, row, "tail_up")
    res["tail"] = row
    return res


def _counters():
    """(name, wrapper) of every kernel's launch count and every plain
    version's call count."""
    from hpgmg_tpu_torch.kernels import restrict as R
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import tail as T

    kernels = [("fv4_ghost_fill", S.fv4_ghost_fill_cuda),
               ("fv4_stencil", S.fv4_stencil_cuda), ("fv4_gsrb2", S.fv4_gsrb2_cuda),
               ("tail_down", T.tail_down_cuda), ("tail_up", T.tail_up_cuda),
               ("restrict_cell", R.restrict_cell_cuda)]
    plains = [("fv4_stencil_plain", S.fv4_stencil_plain),
              ("fv4_gsrb2_plain", S.fv4_gsrb2_plain),
              ("tail_down_plain", T.tail_down_plain), ("tail_up_plain", T.tail_up_plain),
              ("restrict_cell_plain", R.restrict_cell_plain)]
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


def solve_cfg(bottom: str, dtype):
    from hpgmg_tpu_torch.core.config import BottomSolver, Smoother, SolverConfig

    return SolverConfig(op="fv4", a=0.0, b=1.0, smoother=Smoother.GSRB,
                        bottom=BottomSolver(bottom), min_coarse_dim=8, dtype=dtype)


def headline(n=512):
    """Phase 4: the port's main path, with the launch counts around it."""
    from hpgmg_tpu_torch.bench.driver import run_benchmark

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = run_benchmark(n, solve_cfg("direct", torch.float32), "cuda",
                        min_solve_seconds=1.0, dynamic_range=3)
    counts, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  DOF/s {res.dof_per_second:.6e}, s/solve {res.seconds_per_solve:.6f}, "
          f"rel_residual {res.rel_residual:.6e}, order {res.richardson_order:.6f}, "
          f"peak memory {peak:.3f} GiB")
    print(f"  launches during the headline: {counts}; plain calls: {plain_calls}")
    if not res.rel_residual <= 1e-3:
        raise AssertionError(f"rel_residual {res.rel_residual} > 1e-3")
    if not res.richardson_order >= 3.0:
        raise AssertionError(f"Richardson order {res.richardson_order} < 3.0")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    if any(plain_calls.values()):
        raise AssertionError(f"a plain version ran on the main path: {plain_calls}")
    return res, counts


def companion(n=512):
    from hpgmg_tpu_torch.bench.driver import run_benchmark

    res = run_benchmark(n, solve_cfg("bicgstab", torch.float32), "cuda",
                        min_solve_seconds=1.0)
    if not res.rel_residual <= 1e-3:
        raise AssertionError(f"BiCGStab companion rel_residual {res.rel_residual}")
    return res


def f64_order(n=256):
    from hpgmg_tpu_torch.bench.driver import run_benchmark

    res = run_benchmark(n, solve_cfg("direct", torch.float64), "cuda",
                        min_solve_seconds=0.5, dynamic_range=3)
    if not res.richardson_order >= 3.8:
        raise AssertionError(f"f64 Richardson order {res.richardson_order} < 3.8")
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
    times = time_kernels()
    torch.cuda.empty_cache()

    phase("4 headline fv4 F-cycle 512^3 f32, DIRECT bottom")
    res, counts = headline()
    torch.cuda.empty_cache()
    phase("4b BiCGStab-bottom companion 512^3 f32")
    res_b = companion()
    torch.cuda.empty_cache()

    phase("5 f64 F-cycle 256^3 through the kernels")
    res64 = f64_order()

    big = times[512]
    sources = {
        # name: (source, replaces, timed pair)
        "fv4_ghost_fill": ("fv4_stencil.cu", "hpgmg_tpu/kernels/stencils.py:594",
                           big["ghost"]),
        "fv4_stencil": ("fv4_stencil.cu", "hpgmg_tpu/kernels/stencils.py:594",
                        big["fres"]),
        "fv4_gsrb2": ("fv4_gsrb2.cu", "hpgmg_tpu/kernels/stencils.py:1726",
                      times[64]["gsrb2"]),
        "tail_down": ("tail.cu", "hpgmg_tpu/kernels/tail.py:273",
                      times["tail"]["tail_down"]),
        "tail_up": ("tail.cu", "hpgmg_tpu/kernels/tail.py:298",
                    times["tail"]["tail_up"]),
        "restrict_cell": ("restrict.cu", "hpgmg_tpu/kernels/restrict.py:77",
                          big["restrict"]),
    }
    kernels = [{"name": name, "route": "cuda",
                "source": f"hpgmg_tpu_torch/kernels/csrc/{src}", "replaces": rep,
                "launches": counts[name], "max_abs_err": t[2], "ms": t[0],
                "plain_ms": t[1]}
               for name, (src, rep, t) in sources.items()]
    print(f"  worst relative errors over the checks: {worst}")
    print(json.dumps({"headline": {"dof_per_s": res.dof_per_second,
                                   "rel_residual": res.rel_residual,
                                   "richardson_order": res.richardson_order,
                                   "bicgstab_dof_per_s": res_b.dof_per_second,
                                   "f64_256_order": res64.richardson_order,
                                   "f64_256_dof_per_s": res64.dof_per_second}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
