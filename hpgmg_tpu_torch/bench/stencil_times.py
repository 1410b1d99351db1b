"""Device time of each fv4 (or radius-1) stencil call the F-cycle makes on
one level, on one CUDA device.

    python -m hpgmg_tpu_torch.bench.stencil_times [--sizes 128 256 512]
        [--dtype float32 [float64]] [--bc dirichlet periodic] [--reps 10]
        [--tail] [--r1] [--slab] [--json PATH]

For each size and BC, on the benchmark problem's finest level as the fv4
suite rebuilds it, with x drawn from a seeded generator: the ms per call
(CUDA events over ``--reps`` calls at 512^3, as many cells' worth on
smaller levels up to 64 times as many calls, after 3 warm-up calls) of the
suite's
``apply_op``, ``residual``, ``gsrb_sweep`` (parity 0) and
``restrict_residual`` (K1 on Dirichlet levels, K7a on periodic ones), and
one smoother call (the suite's 6 half-sweeps): as the suite's
``gsrb_smooth`` under the tree's own gate (``smooth``; K7a half-sweeps on
a periodic level), and on a Dirichlet level also as three
``stencils.fv4_gsrb2_cuda`` sweeps (K2, ``smooth_k2``), as three K2c
sweeps on the levels K2c takes (``smooth_k2c``: ``fv4_gsrb2_cluster_cuda``,
or an older tree's cooperative ``fv4_gsrb2_coop_cuda``) and as
``gsrb_smooth`` with ``stencils.GSRB2_MAX_DIM`` set to 0 (K1 half-sweeps,
``smooth_k1``); beside each smoother call's time, the device time of its
kernels alone (torch.profiler), which tells launch overhead from kernel
time on the small levels. With ``--tail``, also K4c, K4a and K4b (the
tail kernels' entries ``tail_v_cuda``, ``tail_down_cuda``,
``tail_up_cuda``) on the headline's tail, the 32^3 and 16^3 levels of the
benchmark hierarchy over its 8^3 DIRECT bottom, each with its device
time (rows with n 32 and calls ``tail_v``, ``tail_down``, ``tail_up``).
With ``--r1``, the radius-1 suites instead of fv4 (sizes 16^3-512^3 by
default): for the var7 body (fv7pt's level) and the 27pt body (27pt's
level, K5 or K7b through the suite), each of ``apply_op``, ``residual``,
``gsrb_sweep`` (parity 0) and ``restrict_residual`` with its ms per call,
its kernels' device ms (``<call>_device``, torch.profiler) and its byte
bound (``<call>_bound``: x, the call's operands and the face arrays the
body reads once, the output written once, over 3.35 TB/s; both bodies do
a few flops a byte, far below the card's ridge in f32 and f64). With
``--slab``, the decomposed fv4 stencil instead: on one whole n^3 block
and on each local block the 2x2 grid gives the levels of an n^3 problem
(``--sizes`` n, default 512: blocks (256, 256, 512) down to (8, 8, 16)),
with random coefficients,
x, rhs and slabs from a seeded generator, K8a's apply, residual and gsrb
(``stencils.fv4_slab_cuda``) and K8b's two gsrb passes
(``fv4_overlap_interior_cuda``, ``fv4_overlap_edge_cuda``, where its
split takes the block), each with its ms per call, its device ms
(``<call>_device``) and its byte bound (``<call>_bound``: the block's
arrays the call reads once and its output written once, K8b's passes
their parts of them, the edge pass also the slabs). It reads
nothing but these and the gate, so the same file times an older tree of
the package too (copied into that tree and run from its root; there
``fv4_gsrb2_cuda`` is its own K2, and a gsrb is handed its ``parity``
only where the tree's ``fv4_slab_cuda`` takes one), in turns with this
one on the same card. Prints one JSON line; ``--json`` also writes it to
a file.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess

import torch

from hpgmg_tpu_torch.bench.driver import build, build_problem
from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils
from hpgmg_tpu_torch.ops.base import get_suite

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published


def time_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` over ``reps`` calls, after 3 warm-up
    calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int):
    """Device ms per call of ``fn``: its kernels' own time in a
    torch.profiler trace of ``reps`` calls, without the gaps between
    launches; None when the trace shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / 1000.0 / reps if us else None


def level_times(n: int, dtype: torch.dtype, bc: BC, reps: int) -> dict:
    """{call: ms} of the four stencil calls and the smoother calls on the
    n^3 level, each over ``reps`` calls at 512^3 and proportionally more on
    smaller levels (the same cells timed); for each smoother call also its
    kernels' device ms (``<call>_device``)."""
    reps = reps * min(64, max(1, (512 // n) ** 3))
    dev = torch.device("cuda")
    cfg = SolverConfig(op="fv4", bc=bc, a=0.0, b=1.0, dtype=dtype)
    suite = get_suite("fv4")
    prob = build_problem(n, cfg, dev)
    lv = suite.rebuild_operator(Level(dim=n, h=1.0 / n, depth=0, beta_i=prob.beta_i,
                                      beta_j=prob.beta_j, beta_k=prob.beta_k), cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, n, n), generator=gen, device=dev, dtype=dtype)
    f = prob.f
    calls = {"apply": lambda: suite.apply_op(lv, x, cfg),
             "residual": lambda: suite.residual(lv, x, f, cfg),
             "gsrb": lambda: suite.gsrb_sweep(lv, x, f, cfg, 0),
             "fres": lambda: suite.restrict_residual(lv, x, f, cfg)}
    out = {name: time_ms(fn, reps) for name, fn in calls.items()}
    nsweeps = 2 * suite.gsrb_num_smooths

    def sweeps(kernel):
        def run():
            y = x
            for _ in range(nsweeps // 2):
                y = kernel(lv, y, f, cfg)
            return y
        return run

    def half_sweeps():
        old = stencils.GSRB2_MAX_DIM
        stencils.GSRB2_MAX_DIM = 0
        try:
            return suite.gsrb_smooth(lv, x, f, cfg, nsweeps)
        finally:
            stencils.GSRB2_MAX_DIM = old

    # the smoother call as the solver makes it, under the tree's own gate
    smooths = {"smooth": lambda: suite.gsrb_smooth(lv, x, f, cfg, nsweeps)}
    if bc == BC.DIRICHLET:
        smooths["smooth_k2"] = sweeps(stencils.fv4_gsrb2_cuda)
        k2c = (getattr(stencils, "fv4_gsrb2_cluster_cuda", None)
               or getattr(stencils, "fv4_gsrb2_coop_cuda", None))
        if k2c is not None and n <= getattr(stencils, "GSRB2_CLUSTER_MAX_N", n):
            smooths["smooth_k2c"] = sweeps(k2c)
        smooths["smooth_k1"] = half_sweeps
    for name, fn in smooths.items():
        out[name] = time_ms(fn, reps)
        out[name + "_device"] = device_ms(fn, reps)
    return out


def r1_times(n: int, dtype: torch.dtype, bc: BC, reps: int) -> dict:
    """{body call: ms} of the four stencil calls of the var7 body (fv7pt's
    level) and of the 27pt body (27pt's level) on the n^3 level, each with
    its kernels' device ms (``<body> <call>_device``), over ``reps`` calls
    at 512^3 and proportionally more on smaller levels, and its byte bound
    (``<body> <call>_bound``)."""
    reps = reps * min(64, max(1, (512 // n) ** 3))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, n, n), generator=gen, device=dev, dtype=dtype)
    out = {}
    for op, body in (("fv7pt", "var7"), ("27pt", "27pt")):
        cfg = SolverConfig(op=op, bc=bc, a=0.0, b=1.0, dtype=dtype)
        suite = get_suite(op)
        prob = build_problem(n, cfg, dev)
        lv = suite.rebuild_operator(Level(dim=n, h=1.0 / n, depth=0, beta_i=prob.beta_i,
                                          beta_j=prob.beta_j, beta_k=prob.beta_k), cfg)
        f = prob.f
        calls = {"apply": lambda: suite.apply_op(lv, x, cfg),
                 "residual": lambda: suite.residual(lv, x, f, cfg),
                 "gsrb": lambda: suite.gsrb_sweep(lv, x, f, cfg, 0),
                 "fres": lambda: suite.restrict_residual(lv, x, f, cfg)}
        faces = sum(t.numel() for t in (lv.beta_i, lv.beta_j, lv.beta_k)) \
            if body == "var7" else 0
        # values read and written: x, rhs, kdinv, the output, the faces
        values = {"apply": 2 * x.numel(), "residual": 3 * x.numel(),
                  "gsrb": 4 * x.numel(), "fres": 2 * x.numel() + x.numel() // 8}
        for name, fn in calls.items():
            out[f"{body} {name}"] = time_ms(fn, reps)
            out[f"{body} {name}_device"] = device_ms(fn, reps)
            out[f"{body} {name}_bound"] = ((values[name] + faces) * x.element_size()
                                           / HBM_BYTES_PER_S * 1e3)
    return out


def slab_times(block, dtype: torch.dtype, bc: BC, reps: int) -> dict:
    """{call: ms} of K8a's apply, residual and gsrb (parity 0) and K8b's two
    gsrb passes on an ni x nj x nk local block, each with its device ms
    (``<call>_device``) and its byte bound (``<call>_bound``), over ``reps``
    calls on the (256, 256, 512) block and proportionally more on smaller
    ones (at most 64 times as many)."""
    ni, nj, nk = block
    reps = reps * min(64, max(1, (256 * 256 * 512) // (ni * nj * nk)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = 2 * ni

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def coef(*shape):
        return 1.0 + 0.25 * torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    dinv = coef(ni, nj, nk) / (8.0 * n * n)
    mask = rb_mask(n, 0, dtype, dev)[:ni, :nj, :nk]
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=coef(ni + 1, nj + 2, nk + 2),
               beta_j=coef(ni + 2, nj + 1, nk + 2), beta_k=coef(ni + 2, nj + 2, nk + 1),
               dinv=dinv, kdinv=(mask * dinv, (1 - mask) * dinv))
    x, rhs = rand(ni, nj, nk), rand(ni, nj, nk)
    slabs = (rand(2, nj, nk), rand(2, nj, nk), rand(ni + 4, 2, nk), rand(ni + 4, 2, nk))
    cfg = SolverConfig(op="fv4", bc=bc, a=0.0, b=1.0, dtype=dtype)
    # an older tree's entries take no parity (its tile kernel reads the
    # colour from kdinv alone) and its split takes the dtype
    par = ({"parity": 0} if "parity" in inspect.signature(stencils.fv4_slab_cuda).parameters
           else {})
    shape_args = (ni, nj, dtype) if len(inspect.signature(
        stencils.overlap_grid_shape).parameters) == 3 else (ni, nj)
    item = x.element_size()
    betas = sum(t.numel() for t in (lv.beta_i, lv.beta_j, lv.beta_k))
    slab_values = sum(t.numel() for t in slabs)
    ops = {"apply": {}, "residual": {"rhs": rhs}, "gsrb": {"rhs": rhs, "kdinv": lv.kdinv[0]}}
    # values read and written: x, the faces, the slabs, the mode's operands,
    # the output
    values = {f"K8a {mode}": x.numel() * (2 + len(kw)) + betas + slab_values
              for mode, kw in ops.items()}
    calls = {f"K8a {mode}": (lambda mode=mode, kw=kw: stencils.fv4_slab_cuda(
        lv, x, slabs, cfg, mode, **kw, **par)) for mode, kw in ops.items()}
    if stencils.overlap_grid_shape(*shape_args) is not None:
        kw = ops["gsrb"]
        inner = stencils.fv4_overlap_interior_cuda(lv, x, cfg, "gsrb", **kw, **par)
        i0, i1, j0, j1 = stencils._interior_region(x)
        part = (i1 - i0) * (j1 - j0) / (ni * nj)
        block_values = values["K8a gsrb"] - slab_values
        calls["K8b interior gsrb"] = lambda: stencils.fv4_overlap_interior_cuda(
            lv, x, cfg, "gsrb", **kw, **par)
        calls["K8b edge gsrb"] = lambda: stencils.fv4_overlap_edge_cuda(
            lv, x, slabs, cfg, "gsrb", inner, **kw, **par)
        values["K8b interior gsrb"] = block_values * part
        values["K8b edge gsrb"] = block_values * (1 - part) + slab_values
    out = {}
    for name, fn in calls.items():
        out[name] = time_ms(fn, reps)
        out[name + "_device"] = device_ms(fn, reps)
        out[name + "_bound"] = values[name] * item / HBM_BYTES_PER_S * 1e3
    return out


def tail_times(dtype: torch.dtype, reps: int) -> dict:
    """{call: ms} of K4c, K4a and K4b on the headline's tail (the 32^3 and
    16^3 levels of the benchmark hierarchy over its 8^3 DIRECT bottom, 6
    half-sweeps a level), with each call's device ms (``<call>_device``)."""
    from hpgmg_tpu_torch.kernels import tail

    dev = torch.device("cuda")
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=dtype, min_coarse_dim=8)
    hier, _ = build(64, cfg, dev)
    levels, bottom = hier.levels[1:3], hier.levels[3]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    e, rhs = (torch.randn(levels[0].shape, generator=gen, device=dev, dtype=dtype)
              for _ in range(2))
    es, rhss = tail.tail_down_cuda(levels, e, rhs, cfg, 6)
    u_bot = torch.randn(bottom.shape, generator=gen, device=dev, dtype=dtype)
    calls = {"tail_v": lambda: tail.tail_v_cuda(levels, bottom, e, rhs, cfg, 6),
             "tail_down": lambda: tail.tail_down_cuda(levels, e, rhs, cfg, 6),
             "tail_up": lambda: tail.tail_up_cuda(levels, es, [rhs, rhss[0]], u_bot,
                                                  cfg, 6)}
    out = {}
    for name, fn in calls.items():
        out[name] = time_ms(fn, reps * 64)
        out[name + "_device"] = device_ms(fn, reps * 64)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", type=int, nargs="+", default=None,
                   help="default 128 256 512; with --r1 16 32 64 128 256 512")
    p.add_argument("--dtype", choices=["float32", "float64"], nargs="+",
                   default=["float32"])
    p.add_argument("--bc", nargs="+", choices=["dirichlet", "periodic"],
                   default=["dirichlet", "periodic"])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--tail", action="store_true",
                   help="also time K4c, K4a and K4b on the headline's 32-16 tail")
    p.add_argument("--r1", action="store_true",
                   help="time the radius-1 suites' calls (var7 and 27pt) instead of fv4's")
    p.add_argument("--slab", action="store_true",
                   help="time K8a and K8b on the local blocks of the 2x2 grid's levels "
                        "of each n^3 of --sizes (default 512) instead")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    sizes = args.sizes or ([16, 32, 64, 128, 256, 512] if args.r1
                           else [512] if args.slab else [128, 256, 512])
    if not torch.cuda.is_available():
        raise SystemExit("stencil_times needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rows = []
    times = r1_times if args.r1 else level_times
    for dt in args.dtype:
        for bc in args.bc:
            for n in sizes:
                # --slab: one whole n^3 block, then the 2x2 grid's blocks of
                # every level from n^3 to 16^3
                for block in ([(n, n, n)] + [(m // 2, m // 2, m) for m in
                                             (n >> s for s in range(8)) if m >= 16]
                              if args.slab else [n]):
                    ms = (slab_times(block, getattr(torch, dt), BC(bc), args.reps)
                          if args.slab else times(n, getattr(torch, dt), BC(bc), args.reps))
                    rows += [{"n": n, **({"block": list(block)} if args.slab else {}),
                              "dtype": dt, "bc": bc, "call": k, "ms": v}
                             for k, v in ms.items()]
                    torch.cuda.empty_cache()
        if args.tail:
            rows += [{"n": 32, "dtype": dt, "bc": "dirichlet", "call": k, "ms": v}
                     for k, v in tail_times(getattr(torch, dt), args.reps).items()]
    out = {"device": torch.cuda.get_device_name(0), "card": card, "rows": rows}
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
