"""Device time of each fv4 (or radius-1) stencil call the F-cycle makes on
one level, on one CUDA device.

    python -m hpgmg_tpu_torch.bench.stencil_times [--sizes 128 256 512]
        [--dtype float32 [float64] [bfloat16]] [--bc dirichlet periodic]
        [--reps 10] [--tail] [--r1] [--slab] [--subtile] [--bf16c]
        [--chunks C ...] [--json PATH]

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
a few flops a byte, far below the card's ridge in f32 and f64); on a
Dirichlet level also one full red+black sweep through K6
(``stencils_r1.r1_gsrb2_cuda``, ``sweep``: 8 values a cell read or
written for var7, 5 for 27pt) and through two K5 gsrb half-sweeps
(``r1_stencil_cuda`` at parity 0, then 1, ``pair``: 14 and 8), and with
``--chunks`` K6 with each forced chunk of i-planes (``sweep chunk <c>``,
where the tree's ``r1_gsrb2_cuda`` takes one) and each var7 mode of
``r1_stencil_cuda`` likewise (``var7 <mode> chunk <c>``, where it takes
one). With ``--subtile``, K1s
instead, on the fv4 benchmark's Dirichlet levels (sizes 16^3-512^3 by
default): its apply, residual and gsrb (``stencils.fv4_subtile_cuda``,
``K1s <mode>``) beside K1's (``K1 <mode>``), K1 with each forced chunk of
``--chunks`` (default 2 4 8 16, ``K1 <mode> chunk <c>``) and K1s with each
as its forced tile length along i where the tree's K1s takes one (up to
``stencils.SUBTILE_MAX_TI``, ``K1s <mode> ti <c>``), each with its device
ms and byte bound (x, the mode's operands and the face arrays read once,
the output written once). ``--dtype bfloat16`` times the bf16
instantiations of K1, K1s and K2c (and with ``--tail`` K4a and K4b) on
bf16 levels, Dirichlet only: K2 and the periodic kernels have none. With
``--bf16c``, K1's gsrb half-sweep (parity 0) on the float32 fv4 levels
(sizes 128^3-512^3 by default) with the float32 face arrays and kdinv
(``K1 gsrb f32``) and with their BF16C bf16 copies
(``stencils.kernel_views_bf16``, ``K1 gsrb BF16C``), in turns f32, BF16C,
BF16C, f32 (``<call> turn <i>``), each with its device ms and byte bound
(BF16C: x, rhs and out in float32, the face arrays and kdinv at 2 bytes a
value). With
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
their parts of them, the edge pass also the slabs), and on the same
block the decomposed radius-1 stencil under the block's BC: K8c's apply,
residual, gsrb and fres (``stencils_r1.r1_slab_cuda``) for fv7pt's var7
body (p1 taps, ``K8c <mode>``; with ``--chunks`` also at each forced chunk,
``K8c <mode> chunk <c>``) and the 27pt body (``K8c 27pt <mode>``), and on
a Dirichlet block one
K8d sweep (``stencils_r1.r1_gsrb2_slab_cuda`` under the edge flags of the
2x2 grid's rank 0, with random ring views, rhs ring and 2-deep slabs,
``K8d sweep``) and two K8c gsrb half-sweeps (``r1_slab_cuda``, ``K8c
pair``), each with its device ms and byte bound. It reads
nothing but these and the gate, so the same file times an older tree of
the package too (copied into that tree and run from its root; there
``fv4_gsrb2_cuda`` is its own K2, and a gsrb is handed its ``parity``
only where the tree's ``fv4_slab_cuda``, ``fv4_subtile_cuda`` or
``r1_slab_cuda`` takes one), in turns with this
one on the same card. Prints one JSON line; ``--json`` also writes it to
a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import subprocess

import torch

from hpgmg_tpu_torch.bench.driver import build, build_problem
from hpgmg_tpu_torch.core.config import BC, BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils
from hpgmg_tpu_torch.kernels import stencils_r1 as K
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
        if dtype != torch.bfloat16:  # K2 has no bf16 instantiation
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


def subtile_times(n: int, dtype: torch.dtype, reps: int, chunks=()) -> dict:
    """{call: ms} of K1s's apply, residual and gsrb (parity 0) on the fv4
    benchmark's n^3 Dirichlet level beside K1's (``fv4_stencil_cuda``) at
    the launcher's rule and with each forced chunk of ``chunks``, and K1s
    with each of them as its forced tile length along i where it takes it
    (up to ``stencils.SUBTILE_MAX_TI``), each with its kernels' device ms
    (``<call>_device``) and its byte bound (``<call>_bound``: x, the mode's
    operands and the face arrays read once, the output written once), over
    ``reps`` calls at 512^3 and proportionally more on smaller levels."""
    reps = reps * min(64, max(1, (512 // n) ** 3))
    dev = torch.device("cuda")
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=dtype)
    prob = build_problem(n, cfg, dev)
    lv = get_suite("fv4").rebuild_operator(
        Level(dim=n, h=1.0 / n, depth=0, beta_i=prob.beta_i, beta_j=prob.beta_j,
              beta_k=prob.beta_k), cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, n, n), generator=gen, device=dev, dtype=dtype)
    # an older tree's K1s takes no parity (it reads the colour from kdinv
    # alone) and no tile length
    k1s_args = inspect.signature(stencils.fv4_subtile_cuda).parameters
    tis = [c for c in chunks if c <= getattr(stencils, "SUBTILE_MAX_TI", 0)] \
        if "ti" in k1s_args else []
    betas = sum(t.numel() for t in (lv.beta_i, lv.beta_j, lv.beta_k))
    calls, values = {}, {}
    for mode, kw in (("apply", {}), ("residual", {"rhs": prob.f}),
                     ("gsrb", {"rhs": prob.f, "kdinv": lv.kdinv[0]})):
        par = {"parity": 0} if mode == "gsrb" else {}
        k1s_par = par if "parity" in k1s_args else {}
        forms = {f"K1s {mode}": lambda m=mode, kw=kw, p=k1s_par: stencils.fv4_subtile_cuda(
            lv, x, cfg, m, **kw, **p)}
        forms.update({f"K1s {mode} ti {t}": lambda m=mode, kw=kw, p=par, t=t:
                      stencils.fv4_subtile_cuda(lv, x, cfg, m, **kw, **p, ti=t)
                      for t in tis})
        forms[f"K1 {mode}"] = lambda m=mode, kw=kw, p=par: stencils.fv4_stencil_cuda(
            lv, x, cfg, m, **kw, **p)
        forms.update({f"K1 {mode} chunk {c}": lambda m=mode, kw=kw, p=par, c=c:
                      stencils.fv4_stencil_cuda(lv, x, cfg, m, **kw, **p, chunk=c)
                      for c in chunks})
        calls.update(forms)
        values.update({k: x.numel() * (2 + len(kw)) + betas for k in forms})
    out = {}
    for name, fn in calls.items():
        out[name] = time_ms(fn, reps)
        out[name + "_device"] = device_ms(fn, reps)
        out[name + "_bound"] = values[name] * x.element_size() / HBM_BYTES_PER_S * 1e3
    return out


def bf16c_times(n: int, reps: int) -> dict:
    """{call: ms} of K1's gsrb half-sweep (parity 0) on the fv4 benchmark's
    n^3 float32 Dirichlet level, with its float32 face arrays and kdinv and
    with their BF16C bf16 copies, in turns (f32, BF16C, BF16C, f32), each
    with its device ms and byte bound, over ``reps`` calls at 512^3 and
    proportionally more on smaller levels."""
    reps = reps * min(64, max(1, (512 // n) ** 3))
    dev = torch.device("cuda")
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float32)
    prob = build_problem(n, cfg, dev)
    lv = get_suite("fv4").rebuild_operator(
        Level(dim=n, h=1.0 / n, depth=0, beta_i=prob.beta_i, beta_j=prob.beta_j,
              beta_k=prob.beta_k), cfg)
    kb16 = stencils.kernel_views_bf16(lv, lv.kdinv)
    view = stencils.bf16c_view(dataclasses.replace(lv, kb16=kb16))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, n, n), generator=gen, device=dev)
    calls = {"K1 gsrb f32": (lambda: stencils.fv4_stencil_cuda(
                lv, x, cfg, "gsrb", rhs=prob.f, kdinv=lv.kdinv[0], parity=0),
                (lv.beta_i, lv.beta_j, lv.beta_k, lv.kdinv[0])),
             "K1 gsrb BF16C": (lambda: stencils.fv4_stencil_cuda(
                 view, x, cfg, "gsrb", rhs=prob.f, kdinv=kb16[3], parity=0),
                 (*kb16[:3], kb16[3]))}
    out = {}
    for i, name in enumerate(("K1 gsrb f32", "K1 gsrb BF16C", "K1 gsrb BF16C",
                              "K1 gsrb f32")):
        fn, coefs = calls[name]
        out[f"{name} turn {i}"] = time_ms(fn, reps)
        out[f"{name} turn {i}_device"] = device_ms(fn, reps)
        # x, rhs and out in float32; the coefficients at their own size
        nbytes = 3 * x.numel() * 4 + sum(t.numel() * t.element_size() for t in coefs)
        out[f"{name}_bound"] = nbytes / HBM_BYTES_PER_S * 1e3
    return out


def r1_times(n: int, dtype: torch.dtype, bc: BC, reps: int, chunks=()) -> dict:
    """{body call: ms} of the four stencil calls of the var7 body (fv7pt's
    level) and of the 27pt body (27pt's level) on the n^3 level, and on a
    Dirichlet level of K6's full sweep, the pair of K5 half-sweeps it
    replaces and K6 with each forced chunk of ``chunks``, each with its
    kernels' device ms (``<body> <call>_device``), over ``reps`` calls at
    512^3 and proportionally more on smaller levels, and its byte bound
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
        if bc == BC.DIRICHLET:
            taps, var7 = ("p1", True) if body == "var7" else ("27pt", False)

            def half(y, p):
                return K.r1_stencil_cuda(lv, y, cfg, "gsrb", taps, var7, rhs=f,
                                         kdinv=lv.kdinv[p], parity=p)

            calls["sweep"] = lambda: K.r1_gsrb2_cuda(lv, x, f, cfg, taps, var7)
            calls["pair"] = lambda: half(half(x, 0), 1)
            # x, rhs, kdinv0, kdinv1, the output (and the faces) once
            values.update(sweep=5 * x.numel(), pair=2 * values["gsrb"])
            faces = {k: faces * (2 if k == "pair" else 1) for k in values}
            if "chunk" in inspect.signature(K.r1_gsrb2_cuda).parameters:
                for c in chunks:
                    calls[f"sweep chunk {c}"] = (lambda c=c: K.r1_gsrb2_cuda(
                        lv, x, f, cfg, taps, var7, chunk=c))
                    values[f"sweep chunk {c}"] = values["sweep"]
                    faces[f"sweep chunk {c}"] = faces["sweep"]
        else:
            faces = {k: faces for k in values}
        if body == "var7" and "chunk" in inspect.signature(K.r1_stencil_cuda).parameters:
            # the var7 kernel with each forced chunk of i-planes
            for mode, kw in (("apply", {}), ("residual", {"rhs": f}),
                             ("gsrb", {"rhs": f, "kdinv": lv.kdinv[0], "parity": 0}),
                             ("fres", {"rhs": f})):
                for c in chunks:
                    key = f"{mode} chunk {c}"
                    calls[key] = (lambda mode=mode, kw=kw, c=c: K.r1_stencil_cuda(
                        lv, x, cfg, mode, "p1", True, **kw, chunk=c))
                    values[key], faces[key] = values[mode], faces[mode]
        for name, fn in calls.items():
            out[f"{body} {name}"] = time_ms(fn, reps)
            out[f"{body} {name}_device"] = device_ms(fn, reps)
            out[f"{body} {name}_bound"] = ((values[name] + faces[name]) * x.element_size()
                                           / HBM_BYTES_PER_S * 1e3)
    return out


def slab_times(block, dtype: torch.dtype, bc: BC, reps: int, chunks=()) -> dict:
    """{call: ms} of K8a's apply, residual and gsrb (parity 0) and K8b's two
    gsrb passes on an ni x nj x nk local block, and of the radius-1 slab
    kernels there (``r1_slab_calls``), each with its device ms
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
    calls.update(r1_slab_calls(n, lv, x, values, gen, dtype, bc, chunks))
    for name, fn in calls.items():
        out[name] = time_ms(fn, reps)
        out[name + "_device"] = device_ms(fn, reps)
        out[name + "_bound"] = values[name] * item / HBM_BYTES_PER_S * 1e3
    return out


def r1_slab_calls(n: int, lv, x, values: dict, gen, dtype, bc: BC, chunks=()) -> dict:
    """K8c's apply, residual, gsrb (parity 0) and fres on x's block under
    ``bc`` (k ghosts wrapped or made), for fv7pt's var7 body (p1 taps,
    ``K8c <mode>``) and the 27pt body (a = 1.5, ``K8c 27pt <mode>``), and
    the var7 body with each forced chunk of i-planes where the tree's
    ``r1_slab_cuda`` takes one (``K8c <mode> chunk <c>``); on a Dirichlet
    block also the radius-1 sweep of the var7 body: K8d under rank 0's edge
    flags (i low and j low are domain faces) and two K8c gsrb half-sweeps
    (``K8c pair``); on random ring views, rhs ring and slabs. Each call's
    values read and written go into ``values``."""
    ni, nj, nk = x.shape
    dev = x.device

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def coef(*shape):
        return 1.0 + 0.25 * torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    rcfg = SolverConfig(op="fv7pt", bc=bc, a=0.0, b=1.0, dtype=dtype)
    pcfg = SolverConfig(op="27pt", bc=bc, a=1.5, b=1.0, dtype=dtype)
    # an older tree's K8c takes no parity (its tile kernel reads the colour
    # from kdinv alone) and no chunk
    k8c_args = inspect.signature(K.r1_slab_cuda).parameters
    par = {"parity": 0} if "parity" in k8c_args else {}
    ring = (ni + 2, nj + 2, nk)
    faces = (coef(ni + 3, nj + 2, nk), coef(ni + 2, nj + 3, nk), coef(ni + 2, nj + 2, nk + 1))
    kd0 = rb_mask(n + 2, 0, dtype, dev)[:ni + 2, :nj + 2, :nk] * coef(*ring) / (8.0 * n * n)
    rlv = Level(dim=n, h=1.0 / n, depth=0,
                beta_i=faces[0][1:-1, 1:-1].contiguous(),
                beta_j=faces[1][1:-1, 1:-1].contiguous(),
                beta_k=faces[2][1:-1, 1:-1].contiguous(),
                kdinv=(kd0[1:-1, 1:-1].contiguous(), lv.kdinv[1]), ring=(kd0, None, *faces))
    rhs2 = rand(*ring)
    rrhs = rhs2[1:-1, 1:-1].contiguous()
    slabs2 = (rand(2, nj, nk), rand(2, nj, nk), rand(ni + 4, 2, nk), rand(ni + 4, 2, nk))
    slabs1 = (rand(1, nj, nk), rand(1, nj, nk), rand(ni + 2, 1, nk), rand(ni + 2, 1, nk))
    edges = (True, False, True, False)

    def half(y, p):
        return K.r1_slab_cuda(rlv, y, slabs1, rcfg, "gsrb", "p1", True, rhs=rrhs,
                              kdinv=rlv.kdinv[p], **({"parity": p} if par else {}))

    calls = {}
    if bc == BC.DIRICHLET:
        calls = {"K8d sweep": lambda: K.r1_gsrb2_slab_cuda(rlv, x, slabs2, edges, rhs2, rcfg,
                                                           "p1", True),
                 "K8c pair": lambda: half(half(x, 0), 1)}
    ops = {"apply": {}, "residual": {"rhs": rrhs}, "gsrb": {"rhs": rrhs, "kdinv": rlv.kdinv[0]},
           "fres": {"rhs": rrhs}}
    cells = x.numel()
    # each K8c call: x, the mode's operands, the output, the faces (var7),
    # the slabs
    slab_values = sum(t.numel() for t in slabs1)
    coefs = sum(t.numel() for t in (rlv.beta_i, rlv.beta_j, rlv.beta_k)) + slab_values
    for mode, kw in ops.items():
        kw = {**kw, **(par if mode == "gsrb" else {})}
        own = cells * (1 + len(ops[mode])) + (cells // 8 if mode == "fres" else cells)
        calls[f"K8c {mode}"] = (lambda mode=mode, kw=kw: K.r1_slab_cuda(
            rlv, x, slabs1, rcfg, mode, "p1", True, **kw))
        calls[f"K8c 27pt {mode}"] = (lambda mode=mode, kw=kw: K.r1_slab_cuda(
            rlv, x, slabs1, pcfg, mode, "27pt", False, **kw))
        values[f"K8c {mode}"] = own + coefs
        values[f"K8c 27pt {mode}"] = own + slab_values
        if "chunk" in k8c_args:
            for c in chunks:
                calls[f"K8c {mode} chunk {c}"] = (lambda mode=mode, kw=kw, c=c: K.r1_slab_cuda(
                    rlv, x, slabs1, rcfg, mode, "p1", True, **kw, chunk=c))
                values[f"K8c {mode} chunk {c}"] = own + coefs
    # K8d: x, kdinv1, the output, the ring views, the rhs ring, the slabs;
    # each K8c half: x, rhs, kdinv, the output, the faces, the slabs
    values["K8d sweep"] = (3 * cells + kd0.numel() + rhs2.numel()
                           + sum(t.numel() for t in (*faces, *slabs2)))
    values["K8c pair"] = 2 * (4 * cells + sum(t.numel() for t in (
        rlv.beta_i, rlv.beta_j, rlv.beta_k, *slabs1)))
    return calls


def tail_times(dtype: torch.dtype, reps: int) -> dict:
    """{call: ms} of K4c, K4a and K4b on the headline's tail (the 32^3 and
    16^3 levels of the benchmark hierarchy over its 8^3 DIRECT bottom, 6
    half-sweeps a level), with each call's device ms (``<call>_device``);
    in bf16 K4a and K4b only, over the bf16 solve's BiCGStab 8-4-2 levels
    (K4c's DIRECT bottom has no bf16 build)."""
    from hpgmg_tpu_torch.kernels import tail

    dev = torch.device("cuda")
    bf16 = dtype == torch.bfloat16
    cfg = SolverConfig(op="fv4", a=0.0, b=1.0, dtype=dtype, min_coarse_dim=2 if bf16 else 8,
                       bottom=BottomSolver.BICGSTAB if bf16 else BottomSolver.DIRECT)
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
    if bf16:
        del calls["tail_v"]
    out = {}
    for name, fn in calls.items():
        out[name] = time_ms(fn, reps * 64)
        out[name + "_device"] = device_ms(fn, reps * 64)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", type=int, nargs="+", default=None,
                   help="default 128 256 512; with --r1 16 32 64 128 256 512")
    p.add_argument("--dtype", choices=["float32", "float64", "bfloat16"], nargs="+",
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
    p.add_argument("--subtile", action="store_true",
                   help="time K1s beside K1 per mode on the Dirichlet fv4 levels "
                        "(sizes 16-512) instead")
    p.add_argument("--bf16c", action="store_true",
                   help="time K1's gsrb with float32 coefficients against BF16C's bf16 "
                        "copies, in turns, on the float32 levels instead")
    p.add_argument("--chunks", type=int, nargs="*", default=None,
                   help="with --r1: also time K6 and the var7 body of K5/K7b with each "
                        "of these chunks of i-planes; with --slab: K8c's var7 body; with "
                        "--subtile: K1 with each as its chunk and K1s with each as its "
                        "tile length (default 2 4 8 16)")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    sizes = args.sizes or ([16, 32, 64, 128, 256, 512] if args.r1 or args.subtile
                           else [512] if args.slab else [128, 256, 512])
    chunks = args.chunks if args.chunks is not None else \
        [2, 4, 8, 16] if args.subtile else []
    bcs = ["dirichlet"] if args.subtile or args.bf16c else args.bc
    if not torch.cuda.is_available():
        raise SystemExit("stencil_times needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rows = []
    for dt in (["float32"] if args.bf16c else args.dtype):
        # bf16 runs the fv4 Dirichlet suite only
        for bc in (["dirichlet"] if dt == "bfloat16" else bcs):
            for n in sizes:
                # --slab: one whole n^3 block, then the 2x2 grid's blocks of
                # every level from n^3 to 16^3
                for block in ([(n, n, n)] + [(m // 2, m // 2, m) for m in
                                             (n >> s for s in range(8)) if m >= 16]
                              if args.slab else [n]):
                    ms = (bf16c_times(n, args.reps) if args.bf16c else
                          slab_times(block, getattr(torch, dt), BC(bc), args.reps, chunks)
                          if args.slab else
                          r1_times(n, getattr(torch, dt), BC(bc), args.reps, chunks)
                          if args.r1 else
                          subtile_times(n, getattr(torch, dt), args.reps, chunks)
                          if args.subtile else level_times(n, getattr(torch, dt), BC(bc),
                                                           args.reps))
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
