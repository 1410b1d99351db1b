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
   versions sum in different orders): K1 and K7a (csrc/fv4_stream.cu, one
   launch a call: apply, residual, gsrb for both parities, fres, each with
   and without the a*alpha*x term, Dirichlet and periodic) at n in {4, 8,
   12, 20, 36, 48, 64, 128, 256}, a gsrb leaving the other colour's cells
   equal to x bit for bit, and on Dirichlet levels equal to K1s bit for bit
   (or held to K1S_TOL); K2 (csrc/fv4_gsrb2.cu, the full red+black sweep
   in one ordinary launch) at the same sizes, f32 and f64, with and without
   a*alpha*x, equal to two K1 gsrb launches bit for bit and to itself with
   the shortest chunk of i-planes; K2c (the sweep in one launch of
   thread-block clusters) at every n from 4 to its largest (64, the top of
   its gate), odd n included, also against two K1 launches, and K3 (cell
   restriction) at n in {8, 16, 32, 48, 64, 128, 256}; K4 (the tail
   descent, climb and one-launch V-cycle, one cluster each) on the tail
   ladders 32-16 and 16 over an 8^3 bottom; K2c and K4 refuse a size beyond
   their limits; then
   kernel vs plain times, with the same error check, at 64^3, 128^3, 256^3
   and 512^3 (K4 at 32-16; K1 also at 512^3 float64), K1 in turns
   with K1s, its bound and its gsrb per chunk of i-planes at 128^3 and up,
   K2 in turns with two K1 launches (also at 512^3 float64), K2c up to its
   gate and K4 on the headline's 32-16 tail each with its device time
   (torch.profiler) and its shared memory a block; the kernels line reports each
   kernel at a size the main path runs it at (K2c smooths the 64^3 level,
   K2 is reported at 512^3, the others run at 512^3);
   K5 (the radius-1 stencil: var7 body with the fv7pt and fv2 ghost taps,
   every mode, with and without a*alpha*x, csrc/r1_var7_stream.cu; 27pt
   body, every mode, with and without its constant a*x, csrc/r1_stream.cu;
   both also at n in {2, 3, 9, 33} and with a chunk of 3 i-planes equal to
   the launcher's bit for bit, each gsrb leaving the other colour's cells
   equal to x bit for bit)
   and K6 (full red+black
   sweep in one streaming launch, csrc/r1_gsrb2.cu, both bodies, all three
   tap sets) at n in {2, 3, 8, 9, 16, 32, 33, 48, 64, 128, 256}, with
   forced chunks of 2 and 3 i-planes equal to its launcher's rule bit for
   bit, then their times, every mode, at 16^3-512^3 on the fv7pt and 27pt
   problems' own levels; the periodic kernels
   with the same checks: K7b (K5 with wrapped ghosts, every mode and body)
   at the same sizes, K4c (the one-launch tail V-cycle over a DIRECT
   bottom) on the 32-16 and 16 ladders, and their times at 512^3 (the var7
   body at 16^3-512^3, the 27pt body at 64^3-512^3, K4c on the headline's
   32-16 tail);
   K2, K2c, K4 and K6 refuse a periodic level; K1s (the one-pass fv4
   stencil for the small levels: apply, residual, gsrb for both parities,
   with and without a*alpha*x) against its plain version and against K1 at
   n in {8, 9, 16, 32, 33, 48, 64, 128, 256}, max relative error <= 2e-6
   (f32) and 1e-13 (f64: its ghosts round in another order than the plain
   version's), with a forced tile length of 3 i-planes equal to the
   launcher's rule bit for bit, and its refusal of a periodic level;
4. the headline solve through the port's own entry point: run_benchmark at
   512^3, fv4, GSRB, DIRECT bottom, min_coarse_dim 8, float32,
   dynamic_range 3, with every kernel's launch count reset before it and
   read after it: rel_residual <= 1e-3, Richardson order >= 3.0, every
   kernel of its path (K1, and K1s up to its gate with stencils.SUBTILE;
   the fused sweeps its gates admit (K2c at 64^3); K3, and K4c or K4's
   two halves, as tail.TAIL_ONE_LAUNCH says) launched, no periodic kernel,
   no K1s with SUBTILE off and no plain version; then the BiCGStab-bottom
   companion, and the headline once more with the other TAIL_ONE_LAUNCH
   setting, once with the other SUBTILE setting (same limits) and once
   with K2 smoothing 512^3-128^3 (4e: rel_residual and order equal to the
   headline's bit for bit);
5. the radius-1 suites through the same entry point at 512^3 float32, the
   counts reset before each and read after it: fv7pt (this slice's
   headline), then fv2 and 27pt on shorter timed chains: rel_residual
   <= 1e-2, Richardson order in (1.5, 2.6), K5 and K3 launched (and K6 for
   fv7pt and fv2, whose var7 body it smooths), no plain version called;
6. float64 verification through the kernels: fv4 at 256^3 with Richardson
   order >= 3.8 (and with the other TAIL_ONE_LAUNCH setting, and with the
   other SUBTILE setting: the same order to 1e-6; with K2 on: the same
   order); fv7pt at 256^3, fv2 and
   27pt at 128^3 with order in (1.8, 2.3);
7. periodic F-cycles (--bc periodic) through the same entry point, float32:
   fv4 and fv7pt at 512^3, fv2 and 27pt at 256^3, with the limits of their
   Dirichlet runs, and the fv4 BiCGStab-bottom companion at 512^3
   (rel_residual <= 1e-3); each launches K7a or K7b and K3, and no K1,
   K1s or K5 launch, K2, K4, K6 or plain version; then float64 orders: fv4
   at 256^3 >= 3.8, fv7pt at 128^3 in (1.8, 2.3);
7b. one counted F-cycle (float32, 512^3) of the headline, its other tail
   setting, K2 on from 128^3, the other SUBTILE setting, fv7pt, 27pt and
   their periodic runs and periodic fv4: every kernel's launches per
   F-cycle, K1's and K7a's, K1s's, K2's and K2c's, K5's and K7b's and K6's
   by level, no plain version;
8. fv4 at 512^3 float32 through the CLI (bench/cli.py) with each other
   smoother (Chebyshev, Jacobi, L1-Jacobi, SymGS; DIRECT bottom): a finite
   rel_residual below 1; and with GSRB over each other bottom solver (CG,
   CABiCGStab, CACG, smooth): rel_residual <= 1e-3; DOF/s and order
   printed, kernels counted as in phase 4;
9. the CLI's drivers: FMGSolve2 and the compensated FMGSolve2-DD at 512^3
   float32 (fmg2dd's lowest residual below 1e-5 and a fifth of fmg2's),
   FMGSolve2 and MGPCG at 256^3 float64 to 1e-10 within 20 cycles;
10. each other smoother and bottom solver at 32^3 float64 on the card
   equals the same F-cycle on the CPU to 1e-10;
11. the decomposed path's slab kernels on one whole-domain block
   (single_chip_slabs*, every K8d edge flag set), float32 and float64, at n
   in {8, ..., 256}, Dirichlet and periodic, every mode, against their
   plain versions and the single-rank kernels at K1S_TOL: K8a (fv4) against
   K1/K7a, K8b (its interior pass, then its edge pass) equal to K8a bit for
   bit, K8c (every body and tap set) against K5/K7b, K8d against K6 (K3
   takes a non-cubic block in phase 3); then K8a on thin, ragged and the
   2x2 grid's local blocks with random slabs (SLAB_BLOCKS, (4,4,8) to
   (128,128,256)), every mode against its plain version, its gsrb's other
   colour equal to x, chunks of 2 and 3 i-planes and K8b's two passes
   equal to it bit for bit; K8c (K5's var7 kernel with the slabs as its
   halo's sources, csrc/r1_var7_stream.cu) on the same blocks with random
   1-deep slabs, every body and tap set, both BCs, every mode against its
   plain version, its gsrb's other colour equal to x, a chunk of 3
   i-planes equal to it bit for bit; and K8d (K6's kernel with the slabs as its
   halo's sources) on the same blocks with random ring views, rhs ring and
   slabs, every body and tap set, under each 2x2 rank's edge flags,
   against its plain version at 1e-5 (f32) and 1e-12 (f64), chunks of 2
   and 3 i-planes equal to it bit for bit;
12. their times (float32) at the local blocks the 2x2 grid's 512^3 path
   gives them (K8a's three modes and K8b's two passes at the finest
   block, each with its device time), with bounds and plain times, and on
   one 512^3 block (K8a's three modes; K8d at the largest level its gate
   admits) beside K1, K5 and K6, in
   turns;
13. the decomposed F-cycle through bench/weak.py: 4 processes in a 2x2
   grid sharing this GPU over gloo (halos staged through host memory; its
   seconds per solve are not a multi-card number): fv4 and fv7pt at 512^3
   float32 (rel_residual <= 1e-3 and, fv7pt's one-rank limit, <= 1e-2;
   order >= 3.0 and in [1.8, 2.2]), fv4 at
   256^3 float64 with OVERLAP on (K8b; order >= 3.8), each one F-cycle per
   timed solve, its u within DECOMPOSED_U_TOL of the one-rank F-cycle's,
   the slab kernels and K3 launched in a counted F-cycle and no
   single-rank stencil, fused sweep, tail kernel or plain version; rank
   0's K8a/K8b/K8c launches and K8d sweeps in it by local block;
14. the FE solver (hpgmg_tpu_torch/fe, no kernel of its own: matrix
   products with TF32 off and elementwise torch ops) on the card, the
   counts reset before it and read after it (no K1-K8 launch, no plain
   version): (a) the reference's t220, t230 and t120 tables and the Q2
   G[8^3] diagnostics in float64 at the CPU tests' limits, that F-cycle's
   u equal to the CPU's to 1e-12; (b) one Q2 float64 F-cycle at G[32^3],
   G[64^3] and G[128^3], e_L2 falling faster than 2^2.5 a doubling, and
   the distorted G[64^3] (-coord_distort 0.05) at the uniform grid's
   error; (c) the sampler through its CLI, -local 50,2097152 -maxsamples 8
   in float32 (G[4^3] to G[128^3]); (d) -local 262144,2097152
   -maxsamples 2 in float64 (G[64^3], G[128^3]); (e) one profiled Q2
   G[128^3] float32 F-cycle: device ms by scope, host reads, idle share.
   Its results are the "fe" JSON line;
15. the bench tooling (bench/timing.py, utils/profiler.py, utils/memory.py,
   the timed cycle of solve/mg.py) on the headline: (a) bench/cli.py at
   512^3 f32, DIRECT bottom, with --timing-table and --solve-timing-table:
   both tables with the 7 level columns 512 ... 8, every cell the JAX
   layout fills > 0 (the CLI's timed total and chain s/solve printed);
   in TURNS_ROUNDS rounds, each an untimed chain of TURNS_CHAIN F-cycles
   (CUDA events, s a solve) then one timed F-cycle, the least timed total
   >= the least untimed s a solve; measure_breakdown's 512^3 smooth within 25%
   of (K1 launches in one smooth call) x (K1's gsrb time from phase 3),
   and the launches of the timed F-cycle by level; (b) the memory report
   after the 512^3 build: bytes_in_use between the hierarchy's tensors
   and bytes_limit; (c) utils.profiler.trace around one untimed F-cycle:
   an mg.L{lev} range on every level, an mg.L{lev}.tail range for each
   K4c launch, >= 90% of the F-cycle's kernel time inside the ranges, the
   ten largest ranges by device ms; (d) bench/weak.py --ranks 1 4
   --per-rank 128 over gloo with --trace: both JAX-format lines and, from
   rank 0's trace of the 4-rank chain, the shares of its wall time in
   communication, in kernels and in neither (and of neither, the host's
   wait in CUDA copies and syncs) (the K8a path launched). Its
   results are the "tooling" JSON line;
16. the 3D process grid: (a) K8a-K8d with k slabs (the KSLAB kernels) on
   blocks split along k, (64,64,64) to (128,128,256), float32 (1e-5) and
   float64 (1e-12), against their plain versions: K8a every mode, Poisson
   and Helmholtz, both BCs, K8b's two passes equal to it bit for bit; K8c
   every mode, var7 and 27pt bodies, both BCs; K8d both bodies with the
   block's k sides on a domain face below, above or neither; and against
   the k-whole kernels: k slabs holding the periodic wrap (K8a bit for
   bit, K8c to rounding), K8d with both k sides on domain faces (bit for
   bit); (b) their times at
   (128,128,256) and (128,128,128) float32 against plain and bound, in
   turns with the k-whole block of the same extent; (c) the decomposed
   F-cycle through bench/weak.py on the (2,2,2) grid of make_mesh, 8
   processes sharing this GPU over gloo: fv4 and fv7pt at 256^3 float32
   (128^3 a rank), and fv4 at 256^3 float64 with OVERLAP on (K8b), held
   to phase 13's limits, every decomposed level split along k: the slab
   kernels launched with k slabs only, no single-rank stencil, fused
   sweep, tail kernel or plain version; the phase's wall time printed;
17. the FE solver and sampler decomposed over the 3D process grid
   (fe/mesh.py), 8 processes sharing this GPU over gloo (the (2,2,2)
   grid): (a) the Poisson1 M=(8,8,8) F-cycle, the anisotropic Poisson2
   M=(4,4,6) F-cycle and V-cycle and a Q2 G[64^3] F-cycle, float64, each
   gathered u against the one-rank u on this card within 1e-12 of max|u|,
   the levels split as fe/mesh.py:_axis_spec says; (b) the sampler
   (fe/sampler.py:run_sample on the ranks of parallel/launch.py, as
   fe/cli.py sample -ranks 8 -backend gloo runs it) at G[128^3] Q2
   float32: its P[  2  2  2] line (the slowest rank's seconds, GF, MEq/s)
   and the phase's wall time. The counts reset before it and read after
   it, here and on each rank of (a) and of (b): no kernel of K1-K8 and no
   plain version. Its results are the "fe_grid" JSON line;
18. bfloat16 and the JAX CLI's ladder: (a) the fv4 F-cycle at 512^3
   float32 with min_coarse_dim 2 and the BiCGStab bottom (512 ... 4, 2)
   through the entry point, rel_residual <= 1e-3 and order >= 3, K1/K1s,
   K2c, K3, K4a/K4b and fv4_small (the plain version, which every device
   takes below 4^3) launched, no plain version, and one counted F-cycle's
   calls by entry and level: the 2^3 level through fv4_small only, no
   kernel refusing a level; (b) each bf16 kernel against its plain version
   on random bf16 operands: K1 every mode and K1s within one bf16 unit in
   the last place of each cell (BF16_CELL_ULPS), K1 == K1s bit for bit,
   K3 likewise, K2c and K4a/K4b within BF16_CHAIN_ULPS of max|out|; K1's
   BF16C gsrb (float32 x, bf16 coefficients) against its plain version at
   F32_TOL and the float32 half-sweep within BF16C_VS_F32; then their
   times 8^3-512^3 on the benchmark's bf16 levels with bounds by bytes at
   2 a value and the plain versions' times; (c) the bf16 fv4 F-cycle at
   512^3 (BiCGStab, min_coarse_dim 2) through the entry point: DOF/s,
   rel_residual, order (no limit: bf16), the bf16 kernels launched and no
   float32 one; one F-cycle through the kernels against the same F-cycle
   through the plain versions on the card within BF16_FCYCLE_GAP units of
   2^-8 max|u|; (d) K1's BF16C gsrb at 256^3 and 512^3 in turns with the
   float32 K1 gsrb, and the fv4 512^3 float32 headline F-cycle with
   stencils.BF16C on: its rel_residual against the fv4 limit of 1e-3,
   reported. Its results are the "bf16" JSON line;
19. bfloat16 on the radius-1 suites and on periodic levels: (a) the bf16
   instantiations of K5 and K7b (both bodies, every tap set and mode), K6
   and K7a against their plain versions at n = 2-256 (K7a from 4), each
   cell within BF16_CELL_ULPS, K6 within BF16_CHAIN_ULPS of max|out| of its
   plain version and of two K5 bf16 half-sweeps, every gsrb's other colour
   equal to x, forced chunks equal to the rule's bits; then their times
   with bounds by bytes at 2 a value, plain times and conv3d in bf16 for
   the 27pt apply, at the size each runs at in (b), and in turns with the
   float32 call; (b) the bf16 F-cycles of fv7pt, 27pt, periodic fv4 and
   periodic fv7pt at 512^3 and of fv2, periodic fv2 and periodic 27pt at
   256^3 (BiCGStab, min_coarse_dim 2) through the entry point: DOF/s,
   rel_residual, order (no limit: bf16), their bf16 kernels launched and
   no kernel of another type or plain version; each held at 128^3 to the
   same F-cycle through the plain versions (counted: no kernel launched,
   the plain versions called) within BF16_R1_FCYCLE_GAP units of 2^-8
   max|u|; (c) the launches of one counted bf16 F-cycle of each.
   Its results join the "bf16" JSON line.

The line before the last lists the kernels as JSON: for each, its launches
on its path, its time, its plain version's time, its bound on the card
(the larger of its bytes over 3.35 TB/s and its flops over 67 TFLOP/s f32,
the H100 SXM's published peaks) and, where one PyTorch call computes the
same function, that call's time. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs one card and imports nothing of JAX.
"""

import contextlib
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261016
F64_TOL, F32_TOL = 1e-12, 1e-5
# K1s against its plain version and K1: its in-kernel ghosts round in
# another order than the plain version's separable fill
K1S_TOL = {torch.float32: 2e-6, torch.float64: 1e-13}
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12  # H100 SXM, published

# flops per cell, counted from the stencils' expressions: fv4 (main 35,
# mixed 72, scale 3), its modes' extra work, the radius-1 bodies (var7:
# 6 differences, 6 products, 5 adds, the scale; 27pt: 26 adds, 4 products,
# 3 adds, a*x and the scale) and a gsrb update (sub, mul, add)
FV4_AX, VAR7_AX, P27_AX, GSRB = 110, 18, 36, 3


def mode_flops(ax: int, mode: str, cells: int, extra: int) -> int:
    """Flops of one stencil call: a gsrb half-sweep updates only the cells
    of its colour, every other mode adds ``extra`` to the operator at
    every cell."""
    if mode == "gsrb":
        return (ax + GSRB) * cells // 2
    return (ax + extra) * cells


def ptxas_report(log: str):
    """(kernel, "registers, spills") of each entry function in the build's
    ptxas log: the kernel's name and its template arguments (types float,
    double, bf16; ints and bools: the mode, K8a's pass, K6's body and slab
    flags) read from the mangled name, in order."""
    import re

    out, name, spill = [], None, ""
    # a repeated class type is a substitution (S<n>_): here always bf16
    arg = r"[fd]|13__nv_bfloat16|S\d*_|L[ib]\d+E"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            # _GLOBAL__N_..._<file>_cu_<8 hex><len><kernel>I<args>E...
            k = re.search(rf"_cu_[0-9a-f]{{8}}\d+(\w+?)I((?:{arg})+)E", name)
            if k:
                args = [{"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}.get(
                    a, "bf16" if a.startswith("S") else a) for a in re.findall(arg, k.group(2))]
                args = [re.sub(r"L[ib](\d+)E", r"\1", a) for a in args]
                name = f"{k.group(1)}<{', '.join(args)}>"
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and name is not None:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((name, f"{regs.group(1) if regs else '?'} registers; {spill}"))
            name = None
    return out


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


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: its kernels' own time in a
    torch.profiler trace of ``reps`` calls (no gaps between launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    if not us:
        raise AssertionError("torch.profiler shows no device time")
    return us / 1000.0 / reps


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
    """Phase 3a: K3 against its plain version, at the sizes the main path
    gives it (the smoother levels run from 512 down; 256 and up span
    several blocks along k); K2c (check_cluster_gsrb2); then K4
    (check_tail). K1 and K7a: check_stream; K2: check_gsrb2."""
    from hpgmg_tpu_torch.kernels import restrict as R
    from hpgmg_tpu_torch.kernels import stencils as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        dn = str(dtype)[6:]
        for n in sizes:
            lv = random_level(n, dtype, dev, rng)
            x = torch.tensor(rng.standard_normal((n, n, n)), dtype=dtype, device=dev)
            rhs = torch.tensor(rng.standard_normal((n, n, n)), dtype=dtype, device=dev)
            check(f"K3 restrict    n={n:3d} {dn}", R.restrict_cell_cuda(x),
                  R.restrict_cell_plain(x), tol, worst, "restrict_cell")
            # a rank's local block of a decomposed level: any even extents
            y = x[:, : max(2, n // 2)].reshape(n // 2, -1, 2 * n).contiguous()
            check(f"K3 restrict {tuple(y.shape)} {dn}", R.restrict_cell_cuda(y),
                  R.restrict_cell_plain(y), tol, worst, "restrict_cell")
            del lv, x, rhs, y
    lv8, x8 = random_level(8, torch.float32, dev, rng), torch.zeros((8,) * 3, device=dev)
    refuses_periodic("K2", lambda cfg: S.fv4_gsrb2_cuda(lv8, x8, x8, cfg))
    check_cluster_gsrb2(worst)
    check_tail(worst)


def check_cluster_gsrb2(worst: dict):
    """Phase 3a, K2c: the full sweep in one launch of clusters against its
    plain version and against two K1 gsrb launches (equal to rounding: its
    ghost planes' edges sum the same taps in another order) at every n from
    4 to its gate's top and its largest n, odd ones included, float32 and
    float64, with and without a*alpha*x; its refusal of a periodic level
    and of n beyond its largest."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    top = max(S.GSRB2_MAX_DIM, S.GSRB2_CLUSTER_MAX_N)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        dn = str(dtype)[6:]
        for n in range(4, top + 1):
            lv = random_level(n, dtype, dev, rng)
            x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
                      for a in rng.standard_normal((2, n, n, n)))
            for label, cfg in (("", SolverConfig(a=0.0, b=1.0, dtype=dtype)),
                               ("+alpha", SolverConfig(a=1.5, b=1.0, helmholtz=True,
                                                       dtype=dtype))):
                out = S.fv4_gsrb2_cluster_cuda(lv, x, rhs, cfg)
                y = S.fv4_stencil_cuda(lv, x, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[0],
                                       parity=0)
                two_k1 = S.fv4_stencil_cuda(lv, y, cfg, "gsrb", rhs=rhs,
                                            kdinv=lv.kdinv[1], parity=1)
                tag = f"n={n:3d} {dn}{label}"
                check(f"K2c gsrb2 vs plain  {tag}", out,
                      S.fv4_gsrb2_plain(lv, x, rhs, cfg), tol, worst, "fv4_gsrb2_cluster")
                check(f"K2c gsrb2 vs 2 K1   {tag}", out, two_k1, tol, worst,
                      "fv4_gsrb2_cluster_vs_two_k1")
            del lv, x, rhs
    lv8, x8 = random_level(8, torch.float32, dev, rng), torch.zeros((8,) * 3, device=dev)
    refuses_periodic("K2c", lambda cfg: S.fv4_gsrb2_cluster_cuda(lv8, x8, x8, cfg))
    n = S.GSRB2_CLUSTER_MAX_N + 2
    big, xb = random_level(n, torch.float32, dev, rng), torch.zeros((n,) * 3, device=dev)
    refuses_size(f"K2c at {n}^3", lambda: S.fv4_gsrb2_cluster_cuda(
        big, xb, xb, SolverConfig(a=0.0, b=1.0)))


def refuses_size(name: str, launch):
    """Raise unless ``launch()`` raises ValueError: a size beyond the
    kernel's limits."""
    try:
        launch()
    except ValueError as e:
        print(f"  {name} refused: {e}")
        return
    raise AssertionError(f"{name} launched beyond the kernel's limits")


def check_gsrb2(worst: dict, sizes=(4, 8, 12, 20, 36, 48, 64, 128, 256)):
    """Phase 3a, K2 (csrc/fv4_gsrb2.cu, one ordinary launch a full sweep):
    with and without a*alpha*x, float32 and float64, at sizes thinner than
    its 16 x 32 column and not a multiple of it: against two K1 gsrb
    launches (parity 0 with kdinv[0], then 1 with kdinv[1]) bit for bit,
    and against its plain version at F32_TOL / F64_TOL; the shortest chunk
    of i-planes the launcher takes (4) gives the launcher's result bit for
    bit."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 11)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        dn = str(dtype)[6:]
        for n in sizes:
            lv = random_level(n, dtype, dev, rng)
            x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
                      for a in rng.standard_normal((2, n, n, n)))
            errs = []
            for cfg in (SolverConfig(a=0.0, b=1.0, dtype=dtype),
                        SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype)):
                out = S.fv4_gsrb2_cuda(lv, x, rhs, cfg)
                y = S.fv4_stencil_cuda(lv, x, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[0],
                                       parity=0)
                two = S.fv4_stencil_cuda(lv, y, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[1],
                                         parity=1)
                if not torch.equal(out, two):
                    raise AssertionError(f"K2 n={n} {dn} helmholtz={cfg.helmholtz}: "
                                         f"differs from two K1 launches by "
                                         f"{relerr(out, two)[0]:.3e}")
                rel, _ = relerr(out, S.fv4_gsrb2_plain(lv, x, rhs, cfg))
                if not rel <= tol:
                    raise AssertionError(f"K2 n={n} {dn} helmholtz={cfg.helmholtz}: "
                                         f"{rel} > {tol}")
                errs.append(rel)
                if n > 4 and not torch.equal(S.fv4_gsrb2_cuda(lv, x, rhs, cfg, chunk=4),
                                             out):
                    raise AssertionError(f"K2 n={n} {dn}: chunk 4 differs")
            print(f"  K2 gsrb2 (2 terms) n={n:3d} {dn}: equals two K1 launches bit for "
                  f"bit; rel err vs plain {max(errs):.3e}")
            worst["fv4_gsrb2"] = max(worst.get("fv4_gsrb2", 0.0), max(errs))
            del lv, x, rhs


def stream_cases(lv, rhs):
    """(label, mode, kwargs, parity) of every mode of K1 and K7a, gsrb at
    both parities, fres where n is even."""
    out = [("apply", "apply", {}, None), ("residual", "residual", {"rhs": rhs}, None)]
    out += [(f"gsrb{p}", "gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}, p) for p in (0, 1)]
    if lv.dim % 2 == 0:
        out.append(("fres", "fres", {"rhs": rhs}, None))
    return out


def check_stream(worst: dict, sizes=(4, 8, 12, 20, 36, 48, 64, 128, 256)):
    """Phase 3a, K1 and K7a (csrc/fv4_stream.cu, one launch a call): every
    mode (apply, residual, gsrb for both parities, fres), both BCs, with and
    without a*alpha*x, float32 and float64, against the plain version at
    F32_TOL / F64_TOL, at sizes that are not a multiple of the 16 x 32
    column tile and levels shorter than one i chunk; a gsrb half-sweep
    leaves the other colour's cells equal to x bit for bit; on Dirichlet
    levels apply, residual and gsrb against K1s (the same arithmetic and
    ghost formula): bit for bit, or the largest difference held to
    K1S_TOL. Returns the largest relative difference from K1s."""
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 7)
    vs_k1s, unequal = 0.0, 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        dn = str(dtype)[6:]
        for n in sizes:
            lv = random_level(n, dtype, dev, rng)
            x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
                      for a in rng.standard_normal((2, n, n, n)))
            for bc in (BC.DIRICHLET, BC.PERIODIC):
                name = "fv4_stencil" if bc == BC.DIRICHLET else "fv4_stencil_periodic"
                errs = []
                for cfg in (SolverConfig(a=0.0, b=1.0, dtype=dtype, bc=bc),
                            SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype, bc=bc)):
                    for label, mode, kw, parity in stream_cases(lv, rhs):
                        out = S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity, **kw)
                        rel, _ = relerr(out, S.fv4_stencil_plain(lv, x, cfg, mode, **kw))
                        if not rel <= tol:
                            raise AssertionError(f"{name} {label} n={n} {dn} helmholtz="
                                                 f"{cfg.helmholtz}: {rel} > {tol}")
                        errs.append(rel)
                        if mode == "gsrb":
                            other = lv.kdinv[parity] == 0
                            if not torch.equal(out[other], x[other]):
                                raise AssertionError(f"{name} {label} n={n} {dn}: the "
                                                     "other colour's cells differ from x")
                        if bc == BC.DIRICHLET and mode in S.SUBTILE_MODES:
                            k1s = S.fv4_subtile_cuda(lv, x, cfg, mode, parity=parity,
                                                     **kw)
                            if not torch.equal(out, k1s):
                                unequal += 1
                                d, _ = relerr(out, k1s)
                                if not d <= K1S_TOL[dtype]:
                                    raise AssertionError(f"K1 {label} n={n} {dn}: {d} from "
                                                         f"K1s > {K1S_TOL[dtype]}")
                                vs_k1s = max(vs_k1s, d)
                print(f"  {'K1 ' if bc == BC.DIRICHLET else 'K7a'} (5 modes x 2 terms) "
                      f"n={n:3d} {dn}: rel err vs plain {max(errs):.3e}")
                worst[name] = max(worst.get(name, 0.0), max(errs))
            del lv, x, rhs
    print(f"  K1 against K1s on every Dirichlet apply, residual and gsrb: "
          + ("bit for bit" if not unequal else
             f"{unequal} calls differ, largest rel diff {vs_k1s:.3e}"))
    return vs_k1s


def check_subtile(worst: dict, sizes=(8, 9, 16, 32, 33, 48, 64, 128, 256)):
    """Phase 3a, K1s: each mode (apply, residual, gsrb for both parities),
    with and without a*alpha*x, float32 and float64, against its plain
    version and against K1 on the same tensors, and with a forced tile
    length along i (3, odd, beside the launcher's rule) equal to the rule's
    result bit for bit. The kernel takes every n >= 4 on its TI x 8 x 32
    tiles; the sizes above the gate's SUBTILE_MAX_DIM call it directly; its
    tiles cover the level partly at 8 and 16, raggedly at 48 (along k), and
    with one cell along j (9) or k (33), whose ghosts come from device
    memory. It refuses a periodic level."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)
    for dtype in (torch.float32, torch.float64):
        dn, tol = str(dtype)[6:], K1S_TOL[dtype]
        for n in sizes:
            lv = random_level(n, dtype, dev, rng)
            x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
                      for a in rng.standard_normal((2, n, n, n)))
            vs_plain = vs_k1 = 0.0
            for cfg in (SolverConfig(a=0.0, b=1.0, dtype=dtype),
                        SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype)):
                for _, mode, kw, parity in stream_cases(lv, rhs):
                    if mode not in S.SUBTILE_MODES:
                        continue
                    out = S.fv4_subtile_cuda(lv, x, cfg, mode, parity=parity, **kw)
                    rp, _ = relerr(out, S.fv4_subtile_plain(lv, x, cfg, mode, parity=parity,
                                                            **kw))
                    rk, _ = relerr(out, S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity,
                                                           **kw))
                    if not (rp <= tol and rk <= tol):
                        raise AssertionError(f"K1s {mode} n={n} {dn} helmholtz="
                                             f"{cfg.helmholtz}: {rp} (plain), {rk} (K1) > {tol}")
                    forced = S.fv4_subtile_cuda(lv, x, cfg, mode, parity=parity, ti=3, **kw)
                    if not torch.equal(forced, out):
                        raise AssertionError(f"K1s {mode} n={n} {dn}: a tile length of 3 "
                                             "differs from the launcher's rule")
                    vs_plain, vs_k1 = max(vs_plain, rp), max(vs_k1, rk)
            print(f"  K1s (3 modes x 2 terms) n={n:3d} {dn}: rel err vs plain "
                  f"{vs_plain:.3e}, vs K1 {vs_k1:.3e}")
            worst["fv4_subtile"] = max(worst.get("fv4_subtile", 0.0), vs_plain)
            del lv, x, rhs
    lv8, x8 = random_level(8, torch.float32, dev, rng), torch.zeros((8,) * 3, device=dev)
    refuses_periodic("K1s", lambda cfg: S.fv4_subtile_cuda(lv8, x8, cfg, "apply"))


def refuses_periodic(name: str, launch):
    """Raise unless ``launch(cfg)`` raises NotImplementedError on a
    periodic level: the fused kernels read no wrapped ghost."""
    from hpgmg_tpu_torch.core.config import BC, SolverConfig

    try:
        launch(SolverConfig(a=0.0, b=1.0, bc=BC.PERIODIC))
    except NotImplementedError as e:
        print(f"  {name} refuses a periodic level: {e}")
        return
    raise AssertionError(f"{name} launched on a periodic level")


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
                # K4c over a DIRECT bottom of a random (well-conditioned) inverse
                bottom = dataclasses.replace(random_level(d, dtype, dev, rng),
                                             bottom_ainv=random_ainv(d, dtype, dev, rng))
                check(f"K4c v           {tag}",
                      T.tail_v_cuda(tail, bottom, e, rhs, cfg, 6),
                      T.tail_v_plain(tail, bottom, e, rhs, cfg, 6), tol, worst,
                      "tail_v")
    refuses_periodic("K4a", lambda c: T.tail_down_cuda(tail, e, rhs, c, 6))
    refuses_periodic("K4b", lambda c: T.tail_up_cuda(tail, es_p, rhss, u_bot, c, 6))
    refuses_periodic("K4c", lambda c: T.tail_v_cuda(tail, bottom, e, rhs, c, 6))
    big = [random_level(d, torch.float32, dev, rng) for d in (64, 32)]
    e64 = torch.zeros(big[0].shape, device=dev)
    refuses_size("K4 on a 64-32 tail", lambda: T.tail_down_cuda(
        big, e64, e64, SolverConfig(a=0.0, b=1.0), 6))


def random_ainv(d: int, dtype, device, rng) -> torch.Tensor:
    """A dense (d^3, d^3) stand-in for a bottom inverse: identity-dominated
    random entries of the scale of h^2."""
    m = d ** 3
    a = np.eye(m) + 0.1 * rng.standard_normal((m, m)) / np.sqrt(m)
    return torch.tensor(a / (8.0 * d * d), dtype=dtype, device=device)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes_`` and do ``flops`` f32 operations."""
    t_b, t_f = nbytes_ / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def time_pair(label: str, kernel, plain, reps: int, row: dict, key: str,
              work=(0, 0), library=None, device=False):
    """Time ``kernel`` and ``plain`` (and ``library``, one PyTorch call
    computing the same function, where there is one) with CUDA events, check
    them against each other at the float32 tolerance, and record the times,
    the max abs error and the bound of ``work`` = (bytes, flops); with
    ``device``, also the kernel's device time (torch.profiler)."""
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
    if device:
        row[key]["device_ms"] = device_ms(kernel, reps)
        print(f"  {label}: device {row[key]['device_ms']:.4f} ms a call")


def stream_work(lv, x, mode: str, kw: dict):
    """(bytes, flops) of one K1 or K7a call: x, the mode's operands and the
    three face arrays read once, the output written once; a gsrb's stencil
    at its colour's cells only."""
    cells = lv.ncells
    out_cells = cells // 8 if mode == "fres" else cells
    return (nbytes(x, *kw.values(), lv.beta_i, lv.beta_j, lv.beta_k)
            + x.element_size() * out_cells, mode_flops(FV4_AX, mode, cells, 2))


def time_stream(lv, x, rhs, cfg, reps: int, row: dict, chunks: bool):
    """K1 (K7a on a periodic level) per mode against its plain version and
    bound; on a Dirichlet level K1s (its bit-exact oracle, one launch too)
    likewise in apply, residual and gsrb, and in turns with K1; with
    ``chunks``, the gsrb's time
    per chunk of i-planes a block (0: the launcher's rule, which the path
    takes)."""
    from hpgmg_tpu_torch.core.config import BC
    from hpgmg_tpu_torch.kernels import stencils as S

    n, dn = lv.dim, str(x.dtype)[6:]
    tag = "K1 " if cfg.bc == BC.DIRICHLET else "K7a"
    for mode, kw, parity in (("apply", {}, None), ("residual", {"rhs": rhs}, None),
                             ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}, 0),
                             ("fres", {"rhs": rhs}, None)):
        k1 = lambda: S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity, **kw)  # noqa: E731
        time_pair(f"{tag} {mode:8s} {n}^3 {dn}", k1,
                  lambda: S.fv4_stencil_plain(lv, x, cfg, mode, **kw), reps, row, mode,
                  work=stream_work(lv, x, mode, kw))
        if cfg.bc == BC.DIRICHLET and mode in S.SUBTILE_MODES:
            k1s = lambda: S.fv4_subtile_cuda(lv, x, cfg, mode, parity=parity,  # noqa: E731
                                             **kw)
            time_pair(f"K1s {mode:8s} {n}^3 {dn}", k1s,
                      lambda: S.fv4_subtile_plain(lv, x, cfg, mode, parity=parity, **kw),
                      reps, row,
                      f"k1s {mode}", work=stream_work(lv, x, mode, kw))
            t = [time_ms(f, reps) for f in (k1, k1s, k1s, k1)]
            print(f"  K1 {mode} {n}^3 {dn} in turns with K1s: K1 {t[0]:.4f} / {t[3]:.4f} "
                  f"ms, K1s {t[1]:.4f} / {t[2]:.4f} ms")
            row[mode]["k1s_in_turns"] = t
    if chunks:
        kw = {"rhs": rhs, "kdinv": lv.kdinv[0]}
        t = {c: time_ms(lambda: S.fv4_stencil_cuda(lv, x, cfg, "gsrb", parity=0,
                                                   chunk=c, **kw), reps)
             for c in (0, 8, 16, 32, 64, n)}
        print(f"  {tag} gsrb {n}^3 {dn} per chunk of i-planes (0: the launcher's rule): "
              + ", ".join(f"{c}: {v:.4f}" for c, v in t.items()) + " ms")
        row["gsrb"]["chunks"] = t


def gsrb2_in_turns(lv, x, rhs, cfg, reps: int, label: str):
    """ms of K2 and of two K1 gsrb launches, one full sweep each, in turns
    K2, K1 x 2, K1 x 2, K2."""
    from hpgmg_tpu_torch.kernels import stencils as S

    def two_k1():
        y = S.fv4_stencil_cuda(lv, x, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[0], parity=0)
        return S.fv4_stencil_cuda(lv, y, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[1], parity=1)

    t = [time_ms(f, reps) for f in (lambda: S.fv4_gsrb2_cuda(lv, x, rhs, cfg), two_k1,
                                     two_k1, lambda: S.fv4_gsrb2_cuda(lv, x, rhs, cfg))]
    print(f"  K2 gsrb2 {label} in turns with two K1 gsrb launches: K2 {t[0]:.4f} / "
          f"{t[3]:.4f} ms, K1 x 2 {t[1]:.4f} / {t[2]:.4f} ms")
    return t


def time_kernels(sizes=(64, 128, 256, 512)):
    """Phase 3b: kernel vs plain time on the benchmark's own coefficients
    (float32), each pair checked against F32_TOL. Returns per size (and
    "tail" for K4 on the 32-16 ladder) {key: (ms, plain ms, max abs err)}."""
    from hpgmg_tpu_torch.bench.driver import build as build_bench
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.core.level import Level
    from hpgmg_tpu_torch.kernels import restrict as R
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import tail as T
    from hpgmg_tpu_torch.ops.base import get_suite
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
        time_stream(lv, x, rhs, cfg, reps, row, n >= 128)
        # K2 and K2c: x, rhs, the kdinv pair and the face arrays read once,
        # out written once; the stencil at one cell of each colour a pair
        sweep = (nbytes(x, rhs, *lv.kdinv, x) + betas,
                 2 * mode_flops(FV4_AX, "gsrb", cells, 0))
        time_pair(f"K2 gsrb2 {n}^3 f32", lambda: S.fv4_gsrb2_cuda(lv, x, rhs, cfg),
                  lambda: S.fv4_gsrb2_plain(lv, x, rhs, cfg), reps, row, "gsrb2",
                  work=sweep)
        row["gsrb2"]["vs_two_k1_in_turns"] = gsrb2_in_turns(lv, x, rhs, cfg, reps,
                                                            f"{n}^3 f32")
        if n <= S.GSRB2_MAX_DIM:
            time_pair(f"K2c gsrb2 {n}^3 f32",
                      lambda: S.fv4_gsrb2_cluster_cuda(lv, x, rhs, cfg),
                      lambda: S.fv4_gsrb2_plain(lv, x, rhs, cfg), reps * 10, row,
                      "gsrb2_cluster", work=sweep, device=True)
            row["gsrb2_cluster"]["smem_bytes"] = S.gsrb2_cluster_smem(n, 4)
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
    sweeps = sum(6 * mode_flops(FV4_AX, "gsrb", lv.ncells, 0) for lv in tail)
    es, rs = T.tail_down_plain(tail, e, rhs, cfg, 6)
    time_pair("K4 down 32-16 f32", lambda: T.tail_down_cuda(tail, e, rhs, cfg, 6),
              lambda: T.tail_down_plain(tail, e, rhs, cfg, 6), 50, row, "tail_down",
              work=(coefs + nbytes(e, rhs, *es, *rs),
                    sweeps + sum((FV4_AX + 2) * lv.ncells for lv in tail)), device=True)
    u_bot = torch.randn((8, 8, 8), generator=gen, device=dev)
    time_pair("K4 up 32-16 f32",
              lambda: T.tail_up_cuda(tail, es, [rhs, rs[0]], u_bot, cfg, 6),
              lambda: T.tail_up_plain(tail, es, [rhs, rs[0]], u_bot, cfg, 6),
              50, row, "tail_up",
              work=(coefs + nbytes(*es, rhs, rs[0], u_bot, e),
                    sweeps + sum(16 * lv.ncells for lv in tail)), device=True)
    # K4c: the same tail over the headline's 8^3 DIRECT bottom, in one launch
    bottom = hier.levels[3]
    m = bottom.ncells
    time_pair("K4c v 32-16 over 8 f32",
              lambda: T.tail_v_cuda(tail, bottom, e, rhs, cfg, 6),
              lambda: T.tail_v_plain(tail, bottom, e, rhs, cfg, 6), 50, row, "tail_v",
              work=(coefs + nbytes(e, rhs, bottom.bottom_ainv, e),
                    2 * sweeps + sum((FV4_AX + 2 + 16) * lv.ncells for lv in tail)
                    + 2 * m * m), device=True)
    for key in ("tail_down", "tail_up", "tail_v"):
        row[key]["smem_bytes"] = T.tail_smem(32, 4)
    res["tail"] = row
    # K1 in float64 at the headline's size, every mode
    prob = init_problem_fv(512, torch.float64, dev)
    c64 = dataclasses.replace(cfg, dtype=torch.float64)
    lv = get_suite("fv4").rebuild_operator(
        Level(dim=512, h=1.0 / 512, depth=0, beta_i=prob.beta_i, beta_j=prob.beta_j,
              beta_k=prob.beta_k), c64)
    x = torch.randn((512,) * 3, generator=gen, device=dev, dtype=torch.float64)
    res["f64"] = {}
    time_stream(lv, x, prob.f, c64, 3, res["f64"], False)
    res["f64"]["gsrb2_vs_two_k1_in_turns"] = gsrb2_in_turns(lv, x, prob.f, c64, 3,
                                                            "512^3 f64")
    del prob, lv, x
    torch.cuda.empty_cache()
    return res


def time_periodic_kernels(n=512, sizes_var7=(16, 32, 64, 128, 256, 512),
                          sizes_27pt=(64, 128, 256, 512)):
    """Phase 3b, K7a and K7b: kernel vs plain time (float32) at n^3 on the
    periodic problems' own finest levels (fv4: the fv problem), and of the
    var7 body (fv7pt: p6) at each of ``sizes_var7`` and the 27pt body (p6)
    at each of ``sizes_27pt``, every mode, each pair checked against
    F32_TOL; the 27pt apply also against a circular pad and conv3d, its
    library yardstick. Returns {key: timing}, each radius-1 body's under
    its name ("var7", "27pt") by size."""
    from hpgmg_tpu_torch.bench.driver import build_problem
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.core.level import Level
    from hpgmg_tpu_torch.ops.base import get_suite

    dev = torch.device("cuda")
    row, reps = {"var7": {}, "27pt": {}}, 5
    runs = [("fv4", None, None, n)] + [("fv7pt", "p1", True, m) for m in sizes_var7]
    runs += [("27pt", "27pt", False, m) for m in sizes_27pt]
    for op, taps, var7, m in runs:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn((m, m, m), generator=gen, device=dev)
        cfg = SolverConfig(op=op, bc=BC.PERIODIC, a=0.0, b=1.0, dtype=torch.float32)
        prob = build_problem(m, cfg, dev)
        lv = get_suite(op).rebuild_operator(
            Level(dim=m, h=1.0 / m, depth=0, beta_i=prob.beta_i,
                  beta_j=prob.beta_j, beta_k=prob.beta_k), cfg)
        rhs = prob.f
        if op == "fv4":
            fv4 = {}
            time_stream(lv, x, rhs, cfg, reps, fv4, True)
            row.update({f"fv4 {mode}": t for mode, t in fv4.items()})
        else:
            body = "var7" if var7 else "27pt"
            row[body][m] = {}
            time_r1_modes(f"K7b {body} {m}^3 f32", lv, x, rhs, cfg, taps, var7,
                          20 if m <= 128 else reps, row[body][m], "")
        del prob, lv, rhs, x
        torch.cuda.empty_cache()
    return row


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


def r1_cases(lv, rhs):
    """(mode, kwargs, parity) of every radius-1 mode: gsrb at both
    parities, fres where n is even."""
    out = [("apply", {}, None), ("residual", {"rhs": rhs}, None)]
    out += [("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}, p) for p in (0, 1)]
    if lv.dim % 2 == 0:
        out.append(("fres", {"rhs": rhs}, None))
    return out


def check_r1_kernels(worst: dict, sizes=(8, 16, 32, 48, 64, 128, 256), odd=(2, 3, 9, 33)):
    """Phase 3a, K5, K7b and K6: every mode of K5 and of K7b (K5 on a
    periodic level) and K6's full sweep, for each body and tap set of
    R1_BODIES, against their plain versions, also at the sizes of ``odd``
    (n = 2, odd n; fres at even n); each body (var7: csrc/r1_var7_stream.cu,
    27pt: csrc/r1_stream.cu) with a forced chunk of 3 i-planes equal to
    its launcher's bit for bit, each gsrb leaving the other colour's cells
    equal to x bit for bit, K6 with forced chunks of 2 and 3 i-planes equal
    to its launcher's rule bit for bit."""
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        dn = str(dtype)[6:]
        for n in sorted(sizes + odd):
            lv = random_level_r1(n, dtype, dev, rng)
            x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
                      for a in rng.standard_normal((2, n, n, n)))
            errs = {}
            for label, taps, var7, helm in R1_BODIES:
                cfg = SolverConfig(a=1.5 if helm else 0.0, b=1.0, helmholtz=helm,
                                   dtype=dtype)
                for bc in (BC.DIRICHLET, BC.PERIODIC):
                    c = dataclasses.replace(cfg, bc=bc)
                    name = (("r1_stencil" if var7 else "r1_stream")
                            + ("_periodic" if bc == BC.PERIODIC else ""))
                    for mode, kw, parity in r1_cases(lv, rhs):
                        ref = K.r1_stencil_plain(lv, x, c, mode, taps, var7, parity=parity,
                                                 **kw)
                        out = K.r1_stencil_cuda(lv, x, c, mode, taps, var7, parity=parity,
                                                **kw)
                        rel, _ = relerr(out, ref)
                        if not rel <= tol:
                            raise AssertionError(f"{name} {label} {mode} {parity} n={n} "
                                                 f"{dn}: {rel} > {tol}")
                        errs[name] = max(errs.get(name, 0.0), rel)
                        short = K.r1_stencil_cuda(lv, x, c, mode, taps, var7,
                                                  parity=parity, chunk=3, **kw)
                        if not torch.equal(short, out):
                            raise AssertionError(f"{name} {label} {mode} {parity} n={n} "
                                                 f"{dn}: chunk 3 differs from the rule")
                        other = kw["kdinv"] == 0 if mode == "gsrb" else None
                        if other is not None and not torch.equal(out[other], x[other]):
                            raise AssertionError(f"{name} {label} gsrb{parity} n={n} "
                                                 f"{dn}: the other colour differs from x")
                out = K.r1_gsrb2_cuda(lv, x, rhs, cfg, taps, var7)
                rel, _ = relerr(out, K.r1_gsrb2_plain(lv, x, rhs, cfg, taps, var7))
                if not rel <= tol:
                    raise AssertionError(f"K6 {label} n={n} {dn}: {rel} > {tol}")
                errs["r1_gsrb2"] = max(errs.get("r1_gsrb2", 0.0), rel)
                for chunk in (2, 3):
                    if not torch.equal(K.r1_gsrb2_cuda(lv, x, rhs, cfg, taps, var7,
                                                       chunk=chunk), out):
                        raise AssertionError(f"K6 {label} n={n} {dn}: chunk {chunk} "
                                             f"differs from the launcher's rule")
            print(f"  radius-1 every mode, body and BC n={n:3d} {dn}: worst rel err "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + "; each gsrb's other colour equals x and chunk 3 the rule bit for "
                    "bit; K6 with chunks of 2 and 3 i-planes equals its rule bit for bit")
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            del lv, x, rhs
    lv8, x8 = random_level_r1(8, torch.float32, dev, rng), torch.zeros((8,) * 3, device=dev)
    refuses_periodic("K6", lambda c: K.r1_gsrb2_cuda(lv8, x8, x8, c, "p1", True))


def r1_library(lv, x, cfg):
    """conv3d of x with its ghosts (a circular pad on a periodic level) and
    the 27pt weights: the 27pt apply in one PyTorch call, its yardstick
    (cudnn's TF32 off)."""
    from hpgmg_tpu_torch.core.config import BC
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    torch.backends.cudnn.allow_tf32 = False
    d = torch.arange(3, device=x.device).sub(1).abs()
    m = d[:, None, None] + d[None, :, None] + d[None, None, :]
    w = torch.tensor([K.C0, K.C1, K.C2, K.C3], device=x.device)[m]
    w = (-cfg.b * lv.h2inv * w)[None, None].to(x.dtype)
    if cfg.bc == BC.PERIODIC:
        return lambda: torch.nn.functional.conv3d(
            torch.nn.functional.pad(x[None, None], (1,) * 6, mode="circular"), w)[0, 0]
    xg = K.ghost_fill_taps(x, "27pt", cfg.bc)[None, None]
    return lambda: torch.nn.functional.conv3d(xg, w)[0, 0]


def time_r1_modes(label: str, lv, x, rhs, cfg, taps: str, var7: bool, reps: int,
                  row: dict, prefix: str):
    """Each mode of K5 (K7b on a periodic level) against its plain version
    and bound, the 27pt apply also against its conv3d yardstick; a gsrb at
    parity 0, its stencil counted at its colour's cells only."""
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    cells = lv.ncells
    betas = nbytes(lv.beta_i, lv.beta_j, lv.beta_k) if var7 else 0
    ax = VAR7_AX if var7 else P27_AX
    for mode, kw, parity in r1_cases(lv, rhs)[:3]:  # apply, residual, gsrb0
        out_cells = cells // 8 if mode == "fres" else cells
        time_pair(f"{label} {mode:8s}",
                  lambda: K.r1_stencil_cuda(lv, x, cfg, mode, taps, var7, parity=parity, **kw),
                  lambda: K.r1_stencil_plain(lv, x, cfg, mode, taps, var7, parity=parity,
                                             **kw),
                  reps, row, f"{prefix}{mode}",
                  work=(nbytes(x, *kw.values()) + betas + x.element_size() * out_cells,
                        mode_flops(ax, mode, cells, 1)),
                  library=r1_library(lv, x, cfg) if not var7 and mode == "apply" else None)
    fres_kw = {"rhs": rhs}
    time_pair(f"{label} fres    ",
              lambda: K.r1_stencil_cuda(lv, x, cfg, "fres", taps, var7, **fres_kw),
              lambda: K.r1_stencil_plain(lv, x, cfg, "fres", taps, var7, **fres_kw),
              reps, row, f"{prefix}fres",
              work=(nbytes(x, rhs) + betas + x.element_size() * cells // 8,
                    mode_flops(ax, "fres", cells, 1)))


def time_r1_kernels(sizes=(16, 32, 64, 128, 256, 512)):
    """Phase 3b, K5 and K6: kernel vs plain time (float32) of every mode on
    the finest level of the fv7pt problem (p6 coefficients, var7 body, p1
    taps) and of the 27pt problem, each pair checked against F32_TOL; the
    27pt apply also against conv3d of the ghost-extended x, its library
    yardstick. Returns per size {key: timing}."""
    from hpgmg_tpu_torch.bench.driver import build_problem
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.core.level import Level
    from hpgmg_tpu_torch.kernels import stencils_r1 as K
    from hpgmg_tpu_torch.ops.base import get_suite

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
            body = "var7" if var7 else "27pt"
            time_r1_modes(f"K5 {body} {n}^3 f32", lv, x, rhs, cfg, taps, var7, reps, row,
                          f"{body} ")
            time_pair(f"K6 {body} gsrb2 {n}^3 f32",
                      lambda: K.r1_gsrb2_cuda(lv, x, rhs, cfg, taps, var7),
                      lambda: K.r1_gsrb2_plain(lv, x, rhs, cfg, taps, var7),
                      reps, row, f"{body} gsrb2",
                      work=(nbytes(x, rhs, *lv.kdinv, x)
                            + (nbytes(lv.beta_i, lv.beta_j, lv.beta_k) if var7 else 0),
                            2 * mode_flops(VAR7_AX if var7 else P27_AX, "gsrb", cells, 0)))
            del prob, lv, rhs
        res[n] = row
        del x
        torch.cuda.empty_cache()
    return res


def reset_counts():
    """Every kernel's launch count and every plain version's call count to
    0 (hpgmg_tpu_torch/kernels/counts.py)."""
    from hpgmg_tpu_torch.kernels import counts

    counts.reset()


def read_counts():
    """({kernel: launches}, {plain version: calls})."""
    from hpgmg_tpu_torch.kernels import counts

    return counts.read()


def solve_cfg(bottom: str, dtype, op: str = "fv4", bc: str = "dirichlet",
              min_coarse_dim: int = 8):
    from hpgmg_tpu_torch.core.config import BC, BottomSolver, Smoother, SolverConfig

    return SolverConfig(op=op, bc=BC(bc), a=0.0, b=1.0, smoother=Smoother.GSRB,
                        bottom=BottomSolver(bottom), min_coarse_dim=min_coarse_dim,
                        dtype=dtype)


# the kernels each suite's F-cycle must launch, per BC
R1_DIRICHLET = ("r1_stencil", "r1_gsrb2", "restrict_cell")
R1_PERIODIC = ("r1_stencil_periodic", "restrict_cell")
# the 27pt body runs on its own kernel (csrc/r1_stream.cu)
PATH_KERNELS = {
    ("fv4", "dirichlet"): ("fv4_gsrb2_cluster", "restrict_cell"),
    ("fv7pt", "dirichlet"): R1_DIRICHLET,
    ("fv2", "dirichlet"): R1_DIRICHLET,
    ("27pt", "dirichlet"): ("r1_stream", "restrict_cell"),
    ("fv4", "periodic"): ("fv4_stencil_periodic", "restrict_cell"),
    ("fv7pt", "periodic"): R1_PERIODIC,
    ("fv2", "periodic"): R1_PERIODIC,
    ("27pt", "periodic"): ("r1_stream_periodic", "restrict_cell"),
}
# and the kernels a periodic F-cycle must never launch: the Dirichlet ghost
# synthesis (K1, K1s, K5) and the fused kernels that read no periodic ghost
# (K2, K4, K6)
DIRICHLET_ONLY = ("fv4_stencil", "fv4_subtile", "fv4_gsrb2", "fv4_gsrb2_cluster",
                  "tail_down", "tail_up", "tail_v", "r1_stencil", "r1_stream", "r1_gsrb2")
PERIODIC_ONLY = ("fv4_stencil_periodic", "r1_stencil_periodic", "r1_stream_periodic")


def fv4_stencil_kernels():
    """The fv4 Dirichlet stencil kernels of the path: K1s on the levels
    the gate admits under stencils.SUBTILE (K1 above them), else K1."""
    from hpgmg_tpu_torch.kernels import stencils as S

    return ("fv4_subtile", "fv4_stencil") if S.SUBTILE else ("fv4_stencil",)


def path_kernels(op: str, bc: str, bottom: str):
    """The kernels the F-cycle of ``op`` under ``bc`` must launch: on fv4
    Dirichlet levels K1s or K1 as stencils.SUBTILE says, and the tail
    through K4c over the DIRECT bottom when tail.TAIL_ONE_LAUNCH says so,
    else through K4's two halves."""
    from hpgmg_tpu_torch.kernels import tail as T

    want = PATH_KERNELS[(op, bc)]
    if (op, bc) == ("fv4", "dirichlet"):
        one = T.TAIL_ONE_LAUNCH and bottom == "direct"
        want += fv4_stencil_kernels() + (("tail_v",) if one else ("tail_down", "tail_up"))
    return want


def check_counts(tag: str, counts: dict, plain_calls: dict, want, bc: str = "dirichlet"):
    """Raise unless every kernel of ``want`` launched, no kernel of the
    other BC did, K1s did not with stencils.SUBTILE off, and no plain
    version ran."""
    from hpgmg_tpu_torch.kernels import stencils as S

    missing = [k for k in want if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels of the path never launched: {missing}")
    stray = [k for k in (DIRICHLET_ONLY if bc == "periodic" else PERIODIC_ONLY)
             if counts[k]]
    if not S.SUBTILE and counts["fv4_subtile"]:
        stray.append("fv4_subtile (SUBTILE off)")
    if stray:
        raise AssertionError(f"{tag}: kernels off the path launched: {stray}")
    if any(plain_calls.values()):
        raise AssertionError(f"{tag}: a plain version ran on the path: {plain_calls}")


def headline(op="fv4", n=512, min_solve_seconds=1.0, rel_limit=1e-3,
             order_range=(3.0, float("inf")), bc="dirichlet", bottom="direct",
             also=(), min_coarse_dim=8):
    """Phases 4, 5 and 7: one suite's F-cycle through the port's entry
    point, with the launch counts reset before it and read after it; the
    kernels of ``also`` must launch too."""
    from hpgmg_tpu_torch.bench.driver import run_benchmark

    from hpgmg_tpu_torch.kernels import stencils as S

    tag = f"{op} {bc} {bottom}" + (" SUBTILE" if S.SUBTILE and op == "fv4" else "")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = run_benchmark(n, solve_cfg(bottom, torch.float32, op, bc, min_coarse_dim), "cuda",
                        min_solve_seconds=min_solve_seconds,
                        dynamic_range=3 if order_range is not None else 1)
    counts, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    order = res.richardson_order
    print(f"  {tag} {n}^3: DOF/s {res.dof_per_second:.6e}, s/solve "
          f"{res.seconds_per_solve:.6f}, rel_residual {res.rel_residual:.6e}, order "
          f"{order if order is None else f'{order:.6f}'}, peak memory {peak:.3f} GiB")
    print(f"  launches during the {tag} run: {counts}; plain calls: {plain_calls}")
    if not res.rel_residual <= rel_limit:
        raise AssertionError(f"{tag} rel_residual {res.rel_residual} > {rel_limit}")
    if order_range is not None and not order_range[0] < order < order_range[1]:
        raise AssertionError(f"{tag} Richardson order {order} outside {order_range}")
    check_counts(tag, counts, plain_calls, path_kernels(op, bc, bottom) + also, bc)
    return res, counts


def companion(n=512, bc="dirichlet"):
    """The BiCGStab-bottom companion of the fv4 headline."""
    res, _ = headline("fv4", n, order_range=None, bc=bc, bottom="bicgstab")
    return res


def f64_order(op="fv4", n=256, order_range=(3.8, float("inf")),
              min_solve_seconds=0.5, bc="dirichlet"):
    from hpgmg_tpu_torch.bench.driver import run_benchmark

    res = run_benchmark(n, solve_cfg("direct", torch.float64, op, bc), "cuda",
                        min_solve_seconds=min_solve_seconds, dynamic_range=3)
    print(f"  {op} {bc} f64 {n}^3: rel_residual {res.rel_residual:.6e}, "
          f"order {res.richardson_order:.6f}")
    if not order_range[0] < res.richardson_order < order_range[1]:
        raise AssertionError(f"{op} {bc} f64 {n}^3 Richardson order "
                             f"{res.richardson_order} outside {order_range}")
    return res


def flipped(module, name: str, fn):
    """Run ``fn()`` with the boolean ``module.name`` flipped."""
    old = getattr(module, name)
    setattr(module, name, not old)
    try:
        return fn()
    finally:
        setattr(module, name, old)


def other_tail_setting(fn):
    """Run ``fn()`` with tail.TAIL_ONE_LAUNCH flipped."""
    from hpgmg_tpu_torch.kernels import tail as T

    return flipped(T, "TAIL_ONE_LAUNCH", fn)


def k2_on(fn, least=128):
    """Run ``fn()`` with K2 (the streaming full sweep) smoothing the fv4
    Dirichlet levels from ``least`` up, K2c below: stencils.GSRB2_MAX_DIM
    raised to take every level and the fv4 suite's fv4_gsrb2 swapped for
    one that launches K2 there (the shipped gate gives K2 no level: two K1
    half-sweeps measured faster)."""
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.ops import fv4 as F

    shipped, gate = F.fv4_gsrb2, S.GSRB2_MAX_DIM

    def sweep(level, x, rhs, cfg):
        if x.is_cuda and level.dim >= least:
            return S.fv4_gsrb2_cuda(level, x, rhs, cfg)
        return shipped(level, x, rhs, cfg)

    S.GSRB2_MAX_DIM, F.fv4_gsrb2 = 1 << 20, sweep
    try:
        return fn()
    finally:
        S.GSRB2_MAX_DIM, F.fv4_gsrb2 = gate, shipped


def other_subtile_setting(fn):
    """Run ``fn()`` with stencils.SUBTILE flipped."""
    from hpgmg_tpu_torch.kernels import stencils as S

    return flipped(S, "SUBTILE", fn)


# (tag, op, bc, flipped setting) of the counted F-cycles: the headline, its
# other tail and SUBTILE settings, the radius-1 suites, the periodic path
FCYCLES = (("fv4", "fv4", "dirichlet", None),
           ("fv4 other tail", "fv4", "dirichlet", "TAIL_ONE_LAUNCH"),
           ("fv4 K2 from 128^3", "fv4", "dirichlet", "K2"),
           ("fv4 other SUBTILE", "fv4", "dirichlet", "SUBTILE"),
           ("fv7pt", "fv7pt", "dirichlet", None), ("27pt", "27pt", "dirichlet", None),
           ("fv4 periodic", "fv4", "periodic", None),
           ("fv7pt periodic", "fv7pt", "periodic", None),
           ("27pt periodic", "27pt", "periodic", None))


def fcycle_launches(n=512):
    """Phase 7b: the launches of one F-cycle (float32, DIRECT bottom) of
    each of FCYCLES: the hierarchy built, the counts reset, one fmg_solve,
    the counts read; K1's and K7a's launches also by level (a tally around
    the fv4 suite's fv4_stencil), K1s's (around its fv4_subtile), K2's and
    K2c's (around its fv4_gsrb2),
    K5's and K7b's (around the radius-1 suites' r1_stencil) and K6's
    (around their r1_gsrb2). No plain version may run, and the fv4
    F-cycles must launch K1 (K7a)."""
    from hpgmg_tpu_torch.bench.driver import build
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K
    from hpgmg_tpu_torch.kernels import tail as T
    from hpgmg_tpu_torch.ops import fv4 as F
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    dev = torch.device("cuda")
    launch = F.fv4_stencil  # the fv4 suite's entry to K1 / K7a, a launch a call
    k1s_launch = F.fv4_subtile  # its entry to K1s, likewise
    r1_launch = K.r1_stencil  # the radius-1 suites' entry to K5 / K7b, likewise
    k6_launch = K.r1_gsrb2  # the radius-1 suites' entry to K6, a launch a call
    out = {}
    for tag, op, bc, flip in FCYCLES:
        cfg = solve_cfg("direct", torch.float32, op, bc)
        by_level, k2_by_level, r1_by_level, k6_by_level = {}, {}, {}, {}
        k1s_by_level = {}

        def tally(level, *args, **kw):
            by_level[level.dim] = by_level.get(level.dim, 0) + 1
            return launch(level, *args, **kw)

        def tally_k1s(level, *args, **kw):
            k1s_by_level[level.dim] = k1s_by_level.get(level.dim, 0) + 1
            return k1s_launch(level, *args, **kw)

        def tally_r1(level, *args, **kw):
            r1_by_level[level.dim] = r1_by_level.get(level.dim, 0) + 1
            return r1_launch(level, *args, **kw)

        def tally_k6(level, *args, **kw):
            k6_by_level[level.dim] = k6_by_level.get(level.dim, 0) + 1
            return k6_launch(level, *args, **kw)

        def one():
            hier, f = build(n, cfg, dev)
            reset_counts()
            sweep = F.fv4_gsrb2  # its entry to K2c (K2 where k2_on forces it)

            def tally_k2(level, *args, **kw):
                k2 = S.fv4_gsrb2_cuda.launches
                out = sweep(level, *args, **kw)
                key = f"{level.dim} {'K2' if S.fv4_gsrb2_cuda.launches > k2 else 'K2c'}"
                k2_by_level[key] = k2_by_level.get(key, 0) + 1
                return out

            F.fv4_stencil, F.fv4_subtile, F.fv4_gsrb2, K.r1_stencil, K.r1_gsrb2 = (
                tally, tally_k1s, tally_k2, tally_r1, tally_k6)
            try:
                fmg_solve(get_suite(op), hier, f, cfg)
                torch.cuda.synchronize()
            finally:
                F.fv4_stencil, F.fv4_subtile, F.fv4_gsrb2, K.r1_stencil, K.r1_gsrb2 = (
                    launch, k1s_launch, sweep, r1_launch, k6_launch)
            return read_counts()

        counts, plain = (one() if flip is None else k2_on(one) if flip == "K2" else
                         flipped(T if flip == "TAIL_ONE_LAUNCH" else S, flip, one))
        counts = {k: v for k, v in counts.items() if v}
        print(f"  {tag} {n}^3: launches per F-cycle {counts}; K1/K7a by level "
              f"{dict(sorted(by_level.items(), reverse=True))}; K1s by level "
              f"{dict(sorted(k1s_by_level.items(), reverse=True))}; K2/K2c by level "
              f"{k2_by_level}; K5/K7b by level "
              f"{dict(sorted(r1_by_level.items(), reverse=True))}; K6 by level "
              f"{dict(sorted(k6_by_level.items(), reverse=True))}")
        if any(plain.values()):
            raise AssertionError(f"{tag}: a plain version ran: {plain}")
        k1 = "fv4_stencil_periodic" if bc == "periodic" else "fv4_stencil"
        if op == "fv4" and not counts.get(k1):
            raise AssertionError(f"{tag}: no {k1} launch")
        if op != "fv4" and sum(r1_by_level.values()) != (
                counts.get("r1_stencil", 0) + counts.get("r1_stencil_periodic", 0)
                + counts.get("r1_stream", 0) + counts.get("r1_stream_periodic", 0)):
            raise AssertionError(f"{tag}: K5/K7b calls {r1_by_level} against launches "
                                 f"{counts}")
        if sum(k6_by_level.values()) != counts.get("r1_gsrb2", 0):
            raise AssertionError(f"{tag}: K6 calls {k6_by_level} against launches {counts}")
        if sum(k1s_by_level.values()) != counts.get("fv4_subtile", 0):
            raise AssertionError(f"{tag}: K1s calls {k1s_by_level} against launches {counts}")
        out[tag] = {"launches": counts, "fv4_stencil_by_level": by_level,
                    "fv4_subtile_by_level": k1s_by_level,
                    "fv4_gsrb2_by_level": k2_by_level, "r1_stencil_by_level": r1_by_level,
                    "r1_gsrb2_by_level": k6_by_level}
        torch.cuda.empty_cache()
    return out


SMOOTHERS = ("chebyshev", "jacobi", "l1jacobi", "symgs")
BOTTOMS = ("cg", "cabicgstab", "cacg", "smooth")


def cli_args(*argv):
    from hpgmg_tpu_torch.bench import cli

    return cli.parser().parse_args(list(argv))


def solver_options(n=512):
    """Phase 8: fv4 at n^3 float32 through the CLI's functions (bench/cli.py
    run) with each other smoother over the DIRECT bottom, held to a finite
    rel_residual below 1, and with GSRB over each other bottom solver, held
    to rel_residual <= 1e-3; the counts reset before each run and read after
    it: the fv4 stencil kernels (K1s or K1) and K3 launched (and K2 with the
    K4a/K4b tail under GSRB), no plain version."""
    from hpgmg_tpu_torch.bench import cli

    out = {}
    base = ("--n", str(n), "--op", "fv4", "--dtype", "float32", "--min-seconds", "0.1")
    runs = [(f"smoother {s}", ("--smoother", s, "--bottom", "direct"), None)
            for s in SMOOTHERS]
    runs += [(f"bottom {b}", ("--bottom", b), 1e-3) for b in BOTTOMS]
    for tag, argv, rel_limit in runs:
        reset_counts()
        res = cli.run(cli_args(*base, *argv))
        counts, plain_calls = read_counts()
        rel = res.rel_residual
        print(f"  {tag} {n}^3 f32: DOF/s {res.dof_per_second:.6e}, rel_residual "
              f"{rel:.6e}, order {res.richardson_order:.6f}")
        ok = rel <= rel_limit if rel_limit is not None else (np.isfinite(rel) and rel < 1.0)
        if not ok:
            raise AssertionError(f"{tag}: rel_residual {rel} fails its limit {rel_limit}")
        want = fv4_stencil_kernels() + ("restrict_cell",)
        if tag.startswith("bottom"):
            want += ("fv4_gsrb2_cluster", "tail_down", "tail_up")
        check_counts(tag, counts, plain_calls, want)
        out[tag] = res
        torch.cuda.empty_cache()
    return out


def drivers():
    """Phase 9: the CLI's drivers (bench/cli.py run_driver) on fv4 over the
    DIRECT bottom: FMGSolve2 and its compensated double-f32 variant at
    512^3 float32, 6 F-cycles each (the f32 iterate floors the plain one
    near 5e-4): fmg2dd's lowest relative residual below 1e-5 and below a
    fifth of fmg2's; then FMGSolve2 and MGPCG at 256^3 float64 to rtol
    1e-10 within 20 F-cycles or iterations."""
    from hpgmg_tpu_torch.bench import cli

    out = {}
    for dtype, n, runs, cap in (("float32", 512, ("fmg2", "fmg2dd"), 6),
                                ("float64", 256, ("fmg2", "mgpcg"), 20)):
        cfg = cli.solver_config(cli_args("--op", "fv4", "--dtype", dtype,
                                         "--bottom", "direct"))
        for driver in runs:
            r = cli.run_driver(driver, n, cfg, "cuda", verbose=False, max_cycles=cap)
            print(f"  {driver} {n}^3 {dtype}: {r['iterations']} cycles, rel residuals "
                  f"{[f'{h:.3e}' for h in r['history']]}, {r['seconds']:.6f} s, "
                  f"{r['dof_per_second']:.6e} DOF/s")
            out[f"{driver} {dtype}"] = r
            torch.cuda.empty_cache()
    low_dd = min(out["fmg2dd float32"]["history"])
    low_plain = min(out["fmg2 float32"]["history"])
    if not (low_dd < 1e-5 and low_dd < low_plain / 5):
        raise AssertionError(f"fmg2dd floor {low_dd} against fmg2's {low_plain}")
    for key in ("fmg2 float64", "mgpcg float64"):
        if not out[key]["rel_residual"] < 1e-10:
            raise AssertionError(f"{key}: {out[key]['history']} never reached 1e-10")
    return out


def card_equals_cpu(n=32):
    """Phase 10: one n^3 float64 fv4 F-cycle per other smoother (DIRECT
    bottom) and per other bottom solver (GSRB) through the kernels, against
    the same F-cycle on the CPU (plain versions), each on a hierarchy
    built and slimmed for its own smoother: max|u_card - u_cpu| /
    max|u_cpu| <= 1e-10."""
    from hpgmg_tpu_torch.bench.driver import build
    from hpgmg_tpu_torch.core.config import BottomSolver, Smoother, SolverConfig
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    worst = 0.0
    for sm, bt in [(s, "direct") for s in SMOOTHERS] + [("gsrb", b) for b in BOTTOMS]:
        cfg = SolverConfig(op="fv4", a=0.0, b=1.0, smoother=Smoother(sm),
                           bottom=BottomSolver(bt), min_coarse_dim=8, dtype=torch.float64)
        sols = []
        for device in ("cuda", "cpu"):
            hier, f = build(n, cfg, torch.device(device))
            sols.append(fmg_solve(get_suite("fv4"), hier, f, cfg)[0].cpu())
        rel, _ = relerr(*sols)
        print(f"  {sm} / {bt} {n}^3 f64: card vs CPU rel err {rel:.3e}")
        if not rel <= 1e-10:
            raise AssertionError(f"{sm} / {bt}: card differs from the CPU by {rel}")
        worst = max(worst, rel)
    return worst


# ---------------------------------------------------------------------------
# the decomposed path: K8a-K8d and the F-cycle over a 2x2 grid of ranks
# ---------------------------------------------------------------------------

def check_slab_kernels(worst: dict, sizes=(8, 16, 32, 48, 64, 128, 256)):
    """Phase 11: the slab kernels driven on one block that is the whole
    domain (single_chip_slabs*, every K8d edge flag set), float32 and
    float64, against their plain versions and against the single-rank
    kernels on the same level, at K1S_TOL (their k ghosts round in another
    order than the plain versions' separable fills): K8a in every mode
    (apply, residual, gsrb for both parities; with and without a*alpha*x),
    Dirichlet and periodic, against K1 (K7a); K8b (both passes) equal to
    K8a bit for bit where the block has >= 3 x 3 tiles; K8c in every mode,
    body and tap set of R1_BODIES, Dirichlet and periodic, against K5
    (K7b); K8d against K6 (Dirichlet)."""
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 5)
    for dtype in (torch.float32, torch.float64):
        tol, dn = K1S_TOL[dtype], str(dtype)[6:]
        for n in sizes:
            lv = random_level(n, dtype, dev, rng)
            x, rhs = (torch.tensor(a, dtype=dtype, device=dev)
                      for a in rng.standard_normal((2, n, n, n)))
            errs = {"fv4_slab": 0.0, "fv4_slab_vs_K1": 0.0, "r1_slab": 0.0,
                    "r1_slab_vs_K5": 0.0, "r1_gsrb2_slab": 0.0,
                    "r1_gsrb2_slab_vs_K6": 0.0}

            def hold(name, out, ref):
                rel, _ = relerr(out, ref)
                if not rel <= tol:
                    raise AssertionError(f"{name} n={n} {dn}: rel err {rel} > {tol}")
                errs[name] = max(errs[name], rel)

            overlap = S.overlap_grid_shape(n, n) is not None
            for bc in (BC.DIRICHLET, BC.PERIODIC):
                slabs = S.single_chip_slabs(x, bc)
                for cfg in (SolverConfig(a=0.0, b=1.0, dtype=dtype, bc=bc),
                            SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype, bc=bc)):
                    for _, mode, kw, parity in stream_cases(lv, rhs):
                        if mode not in S.SLAB_MODES:
                            continue
                        out = S.fv4_slab_cuda(lv, x, slabs, cfg, mode, parity=parity, **kw)
                        hold("fv4_slab", out, S.fv4_slab_plain(lv, x, slabs, cfg, mode, **kw))
                        hold("fv4_slab_vs_K1", out, S.fv4_stencil_cuda(lv, x, cfg, mode,
                                                                       parity=parity, **kw))
                        if overlap:
                            pair = S.fv4_overlap_edge_cuda(
                                lv, x, slabs, cfg, mode,
                                S.fv4_overlap_interior_cuda(lv, x, cfg, mode, parity=parity,
                                                            **kw), parity=parity, **kw)
                            if not torch.equal(pair, out):
                                raise AssertionError(f"K8b {mode} n={n} {dn} {bc.value}: "
                                                     f"differs from K8a by {relerr(pair, out)}")
            del lv
            lr = random_level_r1(n, dtype, dev, rng)
            for label, taps, var7, helm in R1_BODIES:
                for bc in (BC.DIRICHLET, BC.PERIODIC):
                    cfg = SolverConfig(a=1.5 if helm else 0.0, b=1.0, helmholtz=helm,
                                       dtype=dtype, bc=bc)
                    slabs = K.single_chip_slabs_r1(x, bc, taps)
                    for mode, kw, parity in r1_cases(lr, rhs):
                        out = K.r1_slab_cuda(lr, x, slabs, cfg, mode, taps, var7,
                                             parity=parity, **kw)
                        hold("r1_slab", out,
                             K.r1_slab_plain(lr, x, slabs, cfg, mode, taps, var7, **kw))
                        hold("r1_slab_vs_K5", out, K.r1_stencil_cuda(
                            lr, x, cfg, mode, taps, var7, parity=parity, **kw))
                    if bc == BC.DIRICHLET:
                        lr2 = dataclasses.replace(lr, ring=K.ring_views(lr, cfg, var7))
                        s2, r2 = K.single_chip_slabs2_r1(x, taps), K.ring_cut(rhs, 0, 0, n, n)
                        edges = (True,) * 4
                        out = K.r1_gsrb2_slab_cuda(lr2, x, s2, edges, r2, cfg, taps, var7)
                        hold("r1_gsrb2_slab", out, K.r1_gsrb2_slab_plain(
                            lr2, x, s2, edges, r2, cfg, taps, var7))
                        hold("r1_gsrb2_slab_vs_K6", out,
                             K.r1_gsrb2_cuda(lr, x, rhs, cfg, taps, var7))
            print(f"  n={n:3d} {dn}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + (", K8b == K8a" if overlap else ""))
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            del lr, x, rhs
    torch.cuda.empty_cache()
    check_slab_blocks(worst)
    check_k8c_blocks(worst)
    check_k8d_blocks(worst)


# K8a's local blocks beyond the whole-domain ones: thin (a column tile wider
# than the block), ragged (extents no multiple of the 16 x 32 column tile)
# and the 2x2 grid's
SLAB_BLOCKS = ((4, 4, 8), (8, 8, 16), (16, 48, 32), (24, 40, 48), (64, 64, 128),
               (128, 128, 256))


def check_slab_blocks(worst: dict):
    """Phase 11, K8a on SLAB_BLOCKS with random coefficients and slabs (as
    neighbours would send them), float32 and float64, both BCs, with and
    without a*alpha*x: every mode against its plain version at K1S_TOL, a
    gsrb leaving the other colour equal to x bit for bit, chunks of 2 and 3
    i-planes equal to the launcher's rule bit for bit, K8b's two passes
    equal to K8a bit for bit where its split takes the block."""
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 7)
    for dtype in (torch.float32, torch.float64):
        tol, dn = K1S_TOL[dtype], str(dtype)[6:]
        for ni, nj, nk in SLAB_BLOCKS:
            lv = _block_level(ni, nj, nk, dev, rng, r1=False, dtype=dtype)
            lv = dataclasses.replace(lv, alpha=torch.tensor(
                rng.random((ni, nj, nk)), dtype=dtype, device=dev))
            x, rhs = (torch.tensor(rng.standard_normal((ni, nj, nk)), dtype=dtype, device=dev)
                      for _ in range(2))
            slabs = tuple(torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                          for s in ((2, nj, nk),) * 2 + ((ni + 4, 2, nk),) * 2)
            split = S.overlap_grid_shape(ni, nj) is not None
            err = 0.0
            for bc in (BC.DIRICHLET, BC.PERIODIC):
                for cfg in (SolverConfig(a=0.0, b=1.0, dtype=dtype, bc=bc),
                            SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype, bc=bc)):
                    for mode, kw, parity in (
                            ("apply", {}, None), ("residual", {"rhs": rhs}, None),
                            *(("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}, p) for p in (0, 1))):
                        tag = f"K8a {mode} {parity} ({ni},{nj},{nk}) {dn} {bc.value}"
                        out = S.fv4_slab_cuda(lv, x, slabs, cfg, mode, parity=parity, **kw)
                        rel, _ = relerr(out, S.fv4_slab_plain(lv, x, slabs, cfg, mode, **kw))
                        if not rel <= tol:
                            raise AssertionError(f"{tag}: rel err {rel} > {tol}")
                        err = max(err, rel)
                        if mode == "gsrb":
                            other = kw["kdinv"] == 0
                            if not torch.equal(out[other], x[other]):
                                raise AssertionError(f"{tag}: the other colour moved")
                        for chunk in (2, 3):
                            if not torch.equal(S.fv4_slab_cuda(lv, x, slabs, cfg, mode,
                                                               parity=parity, chunk=chunk,
                                                               **kw), out):
                                raise AssertionError(f"{tag}: chunk {chunk} differs")
                        if split:
                            inner = S.fv4_overlap_interior_cuda(lv, x, cfg, mode,
                                                                parity=parity, **kw)
                            if not torch.equal(S.fv4_overlap_edge_cuda(
                                    lv, x, slabs, cfg, mode, inner, parity=parity, **kw), out):
                                raise AssertionError(f"{tag}: K8b differs from K8a")
            print(f"  K8a ({ni},{nj},{nk}) {dn}: rel err vs plain {err:.3e}; the other "
                  f"colour equals x, chunks 2 and 3 equal the rule"
                  + (", K8b == K8a" if split else ""))
            worst["fv4_slab_blocks"] = max(worst.get("fv4_slab_blocks", 0.0), err)
            del lv, x, rhs, slabs
    torch.cuda.empty_cache()


def check_k8c_blocks(worst: dict):
    """Phase 11, K8c (csrc/r1_var7_stream.cu with the slabs as its halo's
    sources) on SLAB_BLOCKS with random natural faces, alpha and 1-deep
    slabs, float32 and float64, both BCs, every body and tap set of
    R1_BODIES: every mode (gsrb at both parities, fres where the extents
    are even) against its plain version at K1S_TOL, a gsrb leaving the
    other colour equal to x bit for bit, a chunk of 3 i-planes equal to
    the launcher's rule bit for bit."""
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 9)
    for dtype in (torch.float32, torch.float64):
        tol, dn = K1S_TOL[dtype], str(dtype)[6:]
        for ni, nj, nk in SLAB_BLOCKS:
            lv = _block_level(ni, nj, nk, dev, rng, r1=True, dtype=dtype)
            lv = dataclasses.replace(lv, alpha=torch.tensor(
                rng.random((ni, nj, nk)), dtype=dtype, device=dev))
            x, rhs = (torch.tensor(rng.standard_normal((ni, nj, nk)), dtype=dtype, device=dev)
                      for _ in range(2))
            slabs = tuple(torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                          for s in ((1, nj, nk),) * 2 + ((ni + 2, 1, nk),) * 2)
            err = 0.0
            for label, taps, var7, helm in R1_BODIES:
                for bc in (BC.DIRICHLET, BC.PERIODIC):
                    cfg = SolverConfig(a=1.5 if helm else 0.0, b=1.0, helmholtz=helm,
                                       dtype=dtype, bc=bc)
                    for mode, kw, parity in (
                            ("apply", {}, None), ("residual", {"rhs": rhs}, None),
                            *(("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[p]}, p) for p in (0, 1)),
                            ("fres", {"rhs": rhs}, None)):
                        tag = f"K8c {label} {mode} {parity} ({ni},{nj},{nk}) {dn} {bc.value}"
                        out = K.r1_slab_cuda(lv, x, slabs, cfg, mode, taps, var7,
                                             parity=parity, **kw)
                        rel, _ = relerr(out, K.r1_slab_plain(lv, x, slabs, cfg, mode, taps,
                                                             var7, **kw))
                        if not rel <= tol:
                            raise AssertionError(f"{tag}: rel err {rel} > {tol}")
                        err = max(err, rel)
                        if mode == "gsrb":
                            other = kw["kdinv"] == 0
                            if not torch.equal(out[other], x[other]):
                                raise AssertionError(f"{tag}: the other colour moved")
                        if not torch.equal(K.r1_slab_cuda(lv, x, slabs, cfg, mode, taps, var7,
                                                          parity=parity, chunk=3, **kw), out):
                            raise AssertionError(f"{tag}: chunk 3 differs")
            print(f"  K8c ({ni},{nj},{nk}) {dn}: rel err vs plain {err:.3e}; the other "
                  f"colour equals x, chunk 3 equals the rule")
            worst["r1_slab_blocks"] = max(worst.get("r1_slab_blocks", 0.0), err)
            del lv, x, rhs, slabs
    torch.cuda.empty_cache()


# the edge flags (i low, i high, j low, j high) of the 2x2 grid's four ranks
GRID_EDGES = ((True, False, True, False), (True, False, False, True),
              (False, True, True, False), (False, True, False, True))


def check_k8d_blocks(worst: dict):
    """Phase 11, K8d on SLAB_BLOCKS with random ring views, rhs ring and
    2-deep slabs (as neighbours would send them), float32 and float64, each
    body and tap set of R1_BODIES, under the edge flags of each rank of a
    2x2 grid: against its plain version at F32_TOL (F64_TOL), chunks of 2
    and 3 i-planes equal to the launcher's rule bit for bit."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 8)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        dn = str(dtype)[6:]
        for ni, nj, nk in SLAB_BLOCKS:
            lv = _block_level(ni, nj, nk, dev, rng, r1=True, dtype=dtype)
            kd0, _, *faces = lv.ring
            lv = dataclasses.replace(lv, ring=(kd0, torch.tensor(
                rng.random((ni + 2, nj + 2, nk)), dtype=dtype, device=dev), *faces))
            x = torch.tensor(rng.standard_normal((ni, nj, nk)), dtype=dtype, device=dev)
            rhs2 = torch.tensor(rng.standard_normal((ni + 2, nj + 2, nk)), dtype=dtype,
                                device=dev)
            slabs = tuple(torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                          for s in ((2, nj, nk),) * 2 + ((ni + 4, 2, nk),) * 2)
            err = 0.0
            for label, taps, var7, helm in R1_BODIES:
                cfg = SolverConfig(a=1.5 if helm else 0.0, b=1.0, helmholtz=helm,
                                   dtype=dtype)
                for edges in GRID_EDGES:
                    tag = f"K8d {label} ({ni},{nj},{nk}) {dn} edges {edges}"
                    out = K.r1_gsrb2_slab_cuda(lv, x, slabs, edges, rhs2, cfg, taps, var7)
                    rel, _ = relerr(out, K.r1_gsrb2_slab_plain(lv, x, slabs, edges, rhs2,
                                                               cfg, taps, var7))
                    if not rel <= tol:
                        raise AssertionError(f"{tag}: rel err {rel} > {tol}")
                    err = max(err, rel)
                    for chunk in (2, 3):
                        if not torch.equal(K.r1_gsrb2_slab_cuda(
                                lv, x, slabs, edges, rhs2, cfg, taps, var7, chunk=chunk), out):
                            raise AssertionError(f"{tag}: chunk {chunk} differs")
            print(f"  K8d ({ni},{nj},{nk}) {dn}: every body, each 2x2 rank's edge flags: "
                  f"rel err vs plain {err:.3e}; chunks 2 and 3 equal the rule")
            worst["r1_gsrb2_slab_blocks"] = max(worst.get("r1_gsrb2_slab_blocks", 0.0), err)
            del lv, x, rhs2, slabs
    torch.cuda.empty_cache()


def _block_level(ni: int, nj: int, nk: int, dev, rng, r1: bool, dtype=torch.float32):
    """A level of random coefficients cut to an ni x nj x nk local block
    (the fv4 tangentially-extended faces with their margins, or the
    natural radius-1 faces), its kdinv pair, and (radius-1) K8d's ring
    views: the operands the 2x2 grid's main path hands the slab kernels."""
    from hpgmg_tpu_torch.core.level import Level, rb_mask

    def t(shape, lo=1.0, span=0.25):
        return torch.tensor(lo + span * rng.random(shape), dtype=dtype, device=dev)

    faces = (((ni + 1, nj, nk), (ni, nj + 1, nk), (ni, nj, nk + 1)) if r1 else
             ((ni + 1, nj + 2, nk + 2), (ni + 2, nj + 1, nk + 2), (ni + 2, nj + 2, nk + 1)))
    n = max(2 * ni, 2 * nj, nk)
    dinv = t((ni, nj, nk), 0.5 / (8.0 * n * n), 1.0 / (8.0 * n * n))
    mask = rb_mask(n, 0, dtype, dev)[:ni, :nj, :nk]
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=t(faces[0]), beta_j=t(faces[1]),
               beta_k=t(faces[2]), dinv=dinv, kdinv=(mask * dinv, (1 - mask) * dinv))
    if r1:
        ring = (ni + 2, nj + 2, nk)
        rmask = rb_mask(n, 0, dtype, dev)[:ni + 2, :nj + 2, :nk]
        lv = dataclasses.replace(lv, ring=(
            rmask * t(ring, 0.5 / (8.0 * n * n), 1.0 / (8.0 * n * n)), None,
            t((ni + 3, nj + 2, nk)), t((ni + 2, nj + 3, nk)), t((ni + 2, nj + 2, nk + 1))))
    return lv


def time_slab_kernels(n=512):
    """Phase 12: the slab kernels' times (float32) at the local blocks the
    2x2 grid's n^3 main path gives them (K8a, K8b, K8c: the (n/2, n/2, n)
    block of the finest level; K8d: the (m/2, m/2, m) block of the
    largest level it sweeps, m = min(n, stencils_r1.GSRB2_MAX_DIM)), on
    random coefficients and slabs, against
    their plain versions and their bounds (each input read once, each
    output written once); then, at n^3 on one whole-domain block, K8a and
    K8c (K8d at m) against their plain versions and bounds, and in turns
    with K1, K5 and K6 on the same level."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 6)
    cfg = SolverConfig(a=0.0, b=1.0, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    row = {}
    ni, nj, nk = n // 2, n // 2, n
    lv = _block_level(ni, nj, nk, dev, rng, r1=False)
    x, rhs = rand(ni, nj, nk), rand(ni, nj, nk)
    slabs = (rand(2, nj, nk), rand(2, nj, nk), rand(ni + 4, 2, nk), rand(ni + 4, 2, nk))
    cells = ni * nj * nk
    kw = {"rhs": rhs, "kdinv": lv.kdinv[0]}
    label = f"({ni},{nj},{nk})"
    # K8a's three modes (the row's own numbers are the gsrb's, the F-cycle's
    # most frequent call)
    for mode, mkw in (("apply", {}), ("residual", {"rhs": rhs}), ("gsrb", kw)):
        par = {"parity": 0} if mode == "gsrb" else {}
        time_pair(f"K8a {mode} {label} f32",
                  lambda: S.fv4_slab_cuda(lv, x, slabs, cfg, mode, **mkw, **par),
                  lambda: S.fv4_slab_plain(lv, x, slabs, cfg, mode, **mkw), 5, row,
                  "fv4_slab" if mode == "gsrb" else f"fv4_slab {mode}",
                  work=(nbytes(x, *slabs, lv.beta_i, lv.beta_j, lv.beta_k, *mkw.values(), x),
                        mode_flops(FV4_AX, mode, cells, 2)))
    # K8b's two passes apart: the interior part from the block alone, then
    # the rest with the slabs into the same output
    i0, i1, j0, j1 = S._interior_region(x)
    inner = (i1 - i0) * (j1 - j0) * nk
    block = nbytes(x, lv.beta_i, lv.beta_j, lv.beta_k, rhs, lv.kdinv[0], x)
    time_pair(f"K8b interior pass gsrb {label} f32",
              lambda: S.fv4_overlap_interior_cuda(lv, x, cfg, "gsrb", parity=0,
                                                  **kw)[i0:i1, j0:j1],
              lambda: S.fv4_overlap_interior_plain(lv, x, cfg, "gsrb", **kw)[i0:i1, j0:j1],
              5, row, "fv4_overlap_interior",
              work=(block * inner / cells, mode_flops(FV4_AX, "gsrb", inner, 2)))
    out_k = S.fv4_overlap_interior_cuda(lv, x, cfg, "gsrb", parity=0, **kw)
    out_p = S.fv4_overlap_interior_plain(lv, x, cfg, "gsrb", **kw)
    time_pair(f"K8b edge pass gsrb {label} f32",
              lambda: S.fv4_overlap_edge_cuda(lv, x, slabs, cfg, "gsrb", out_k, parity=0, **kw),
              lambda: S.fv4_overlap_edge_plain(lv, x, slabs, cfg, "gsrb", out_p.clone(),
                                               **kw),
              5, row, "fv4_overlap_edge",
              work=(block * (cells - inner) / cells + nbytes(*slabs),
                    mode_flops(FV4_AX, "gsrb", cells - inner, 2)))
    del lv, x, rhs, slabs, out_k, out_p
    lr = _block_level(ni, nj, nk, dev, rng, r1=True)
    x, rhs = rand(ni, nj, nk), rand(ni, nj, nk)
    slabs = (rand(1, nj, nk), rand(1, nj, nk), rand(ni + 2, 1, nk), rand(ni + 2, 1, nk))
    kw = {"rhs": rhs, "kdinv": lr.kdinv[0]}
    time_pair(f"K8c var7 gsrb {label} f32",
              lambda: K.r1_slab_cuda(lr, x, slabs, cfg, "gsrb", "p1", True, parity=0, **kw),
              lambda: K.r1_slab_plain(lr, x, slabs, cfg, "gsrb", "p1", True, **kw), 5, row,
              "r1_slab", work=(nbytes(x, *slabs, lr.beta_i, lr.beta_j, lr.beta_k, rhs,
                                      lr.kdinv[0], x), mode_flops(VAR7_AX, "gsrb", cells, 0)))
    del lr, x, rhs, slabs
    md = min(n, K.GSRB2_MAX_DIM)  # the largest level K8d sweeps
    mi, mj, mk = md // 2, md // 2, md
    l2 = _block_level(mi, mj, mk, dev, rng, r1=True)
    x, rhs2 = rand(mi, mj, mk), rand(mi + 2, mj + 2, mk)
    s2 = (rand(2, mj, mk), rand(2, mj, mk), rand(mi + 4, 2, mk), rand(mi + 4, 2, mk))
    edges = (True, False, True, False)
    time_pair(f"K8d var7 sweep ({mi},{mj},{mk}) f32",
              lambda: K.r1_gsrb2_slab_cuda(l2, x, s2, edges, rhs2, cfg, "p1", True),
              lambda: K.r1_gsrb2_slab_plain(l2, x, s2, edges, rhs2, cfg, "p1", True), 5, row,
              "r1_gsrb2_slab",
              work=(nbytes(x, *s2, rhs2, *(r for r in l2.ring if r is not None),
                           l2.kdinv[1], x),
                    2 * mode_flops(VAR7_AX, "gsrb", mi * mj * mk, 0)))
    del l2, x, rhs2, s2
    torch.cuda.empty_cache()

    # one whole-domain block, against its plain version and bound, and
    # beside the single-rank kernel on the same level, in turns
    for m, names in ((n, ("K8a apply", "K8a residual", "K8a gsrb", "K8c")),
                     (md, ("K8d",))):
        lv, lr = (random_level(m, torch.float32, dev, rng),
                  random_level_r1(m, torch.float32, dev, rng))
        x, rhs = rand(m, m, m), rand(m, m, m)
        fkw, rkw = {"rhs": rhs, "kdinv": lv.kdinv[0]}, {"rhs": rhs, "kdinv": lr.kdinv[0]}
        fs, rs = S.single_chip_slabs(x, cfg.bc), K.single_chip_slabs_r1(x, cfg.bc, "p1")
        lr2 = dataclasses.replace(lr, ring=K.ring_views(lr, cfg, True))
        s2, r2 = K.single_chip_slabs2_r1(x, "p1"), K.ring_cut(rhs, 0, 0, m, m)
        cells, edges = m ** 3, (True,) * 4
        runs = {
            f"K8a {mode}": (
                lambda mode=mode, mkw=mkw, par=par: S.fv4_slab_cuda(lv, x, fs, cfg, mode,
                                                                    **mkw, **par),
                lambda mode=mode, mkw=mkw: S.fv4_slab_plain(lv, x, fs, cfg, mode, **mkw),
                (nbytes(x, *fs, lv.beta_i, lv.beta_j, lv.beta_k, *mkw.values(), x),
                 mode_flops(FV4_AX, mode, cells, 2)),
                "K1", lambda mode=mode, mkw=mkw, par=par: S.fv4_stencil_cuda(
                    lv, x, cfg, mode, **mkw, **par))
            for mode, mkw, par in (("apply", {}, {}), ("residual", {"rhs": rhs}, {}),
                                   ("gsrb", fkw, {"parity": 0}))}
        runs.update({
            "K8c": (lambda: K.r1_slab_cuda(lr, x, rs, cfg, "gsrb", "p1", True, parity=0,
                                           **rkw),
                    lambda: K.r1_slab_plain(lr, x, rs, cfg, "gsrb", "p1", True, **rkw),
                    (nbytes(x, *rs, lr.beta_i, lr.beta_j, lr.beta_k, rhs, lr.kdinv[0], x),
                     mode_flops(VAR7_AX, "gsrb", cells, 0)),
                    "K5", lambda: K.r1_stencil_cuda(lr, x, cfg, "gsrb", "p1", True,
                                                    parity=0, **rkw)),
            "K8d": (lambda: K.r1_gsrb2_slab_cuda(lr2, x, s2, edges, r2, cfg, "p1", True),
                    lambda: K.r1_gsrb2_slab_plain(lr2, x, s2, edges, r2, cfg, "p1", True),
                    (nbytes(x, *s2, r2, *(t for t in lr2.ring if t is not None),
                            lr.kdinv[1], x), 2 * mode_flops(VAR7_AX, "gsrb", cells, 0)),
                    "K6", lambda: K.r1_gsrb2_cuda(lr, x, rhs, cfg, "p1", True)),
        })
        for name in names:
            kernel, plain, work, other, ref = runs[name]
            what = name if " " in name else f"{name} gsrb"
            time_pair(f"{what} on one {m}^3 block f32", kernel, plain, 5, row,
                      f"{name} one block", work=work)
            t = [time_ms(f, 5) for f in (ref, kernel, kernel, ref)]
            print(f"  {what} on one {m}^3 block, in turns with {other}: "
                  f"{t[1]:.4f} / {t[2]:.4f} ms; {other}: {t[0]:.4f} / {t[3]:.4f} ms")
            row[f"{name} one block"]["single_rank"] = (other, t)
        del lv, lr, lr2, x, rhs, fs, rs, s2, r2
        torch.cuda.empty_cache()
    return row


# the kernels no decomposed level may launch: the single-rank stencils and
# fused sweeps (K1, K1s, K2, K5, K6, K7a, K7b) and the tail (off under a mesh)
SINGLE_RANK = ("fv4_stencil", "fv4_subtile", "fv4_stencil_periodic", "fv4_gsrb2",
               "fv4_gsrb2_cluster",
               "tail_down", "tail_up", "tail_v", "r1_stencil", "r1_stencil_periodic",
               "r1_stream", "r1_stream_periodic", "r1_gsrb2")
# u of the decomposed F-cycle against the one-rank F-cycle on the same card,
# max|u_ranks - u_one| / max|u_one|: float64 to 1e-9; float32 to 1e-5, a
# few hundred f32 ulps (the blocks sum their reductions, interpolations and
# the DIRECT bottom's inputs in another order than the one-rank run)
DECOMPOSED_U_TOL = {"float32": 1e-5, "float64": 1e-9}


def decomposed(op: str, n: int, dtype: str, order_range, rel_limit: float = 1e-3,
               overlap: bool = False):
    """Phase 13: the decomposed F-cycle through its entry point
    (bench/weak.py:run_weak): 4 processes in a 2x2 grid sharing this GPU
    over gloo, the halos staged through host memory; run_benchmark on the
    mesh (one warm-up F-cycle, calibration, one timed F-cycle, the 2h and
    4h solves for the order), then one F-cycle with the launch counts reset
    before it and read after it, then the one-rank F-cycle of the same
    problem on rank 0. Held to rel_residual <= rel_limit, the Richardson
    order in ``order_range``, u within DECOMPOSED_U_TOL of the one-rank u;
    the slab kernels launched (K8b's passes under ``overlap``), no
    single-rank stencil, fused sweep or tail kernel, no plain version."""
    from hpgmg_tpu_torch.bench.weak import run_weak

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = run_weak(n // 2, 4, op, dtype, reps=1, backend="gloo", check_serial=True,
                 overlap=overlap, timeout=900.0)
    wall = time.perf_counter() - t0
    res, launches, plain = r["res"], r["launches"], r["plain_calls"]
    tag = f"{op} {n}^3 {dtype}" + (" OVERLAP" if overlap else "")
    print(f"  {tag} on the 2x2 grid (4 processes sharing one GPU, gloo, host-staged "
          f"halos): {res['seconds_per_solve']:.6f} s per solve, rel_residual "
          f"{res['rel_residual']:.6e} (one rank: {r['serial_rel_residual']:.6e}), order "
          f"{res['richardson_order']:.6f}, u vs one rank {r['serial_u_rel_diff']:.3e}; "
          f"phase wall {wall:.3f} s")
    print(f"  launches in the counted F-cycle: { {k: v for k, v in launches.items() if v} }")
    if r["slab_launches_by_block"]:
        print(f"  K8a/K8b/K8c/K8d launches by local block (rank 0): "
              f"{r['slab_launches_by_block']}")
    if r["grid"] != [2, 2, 1]:
        raise AssertionError(f"{tag}: grid {r['grid']}")
    if not res["rel_residual"] <= rel_limit:
        raise AssertionError(f"{tag}: rel_residual {res['rel_residual']} > {rel_limit}")
    if not order_range[0] <= res["richardson_order"] <= order_range[1]:
        raise AssertionError(f"{tag}: order {res['richardson_order']} outside {order_range}")
    if not r["serial_u_rel_diff"] <= DECOMPOSED_U_TOL[dtype]:
        raise AssertionError(f"{tag}: u differs from the one-rank u by "
                             f"{r['serial_u_rel_diff']}")
    want = (("fv4_slab",) if op == "fv4" else ("r1_slab", "r1_gsrb2_slab")) + (
        "restrict_cell",) + (("fv4_overlap_interior", "fv4_overlap_edge") if overlap else ())
    missing = [k for k in want if not launches[k] > 0]
    stray = [k for k in SINGLE_RANK if launches[k]]
    if missing or stray or any(plain.values()):
        raise AssertionError(f"{tag}: kernels not launched {missing}, launched off the "
                             f"path {stray}, plain calls { {k: v for k, v in plain.items() if v} }")
    return r


# ---------------------------------------------------------------------------
# phase 14: the FE Q1/Q2 FAS solver, its sampler and the CLI on the card
# ---------------------------------------------------------------------------

# the reference's expected tables (t220-fmg.sh, t230-fmg-poisson2.sh:
# (|e|_2/|u|_2, |r|_2/|f|_2) after F, V, V, printed to 3 digits, rtol 5e-3;
# t120-poissonksp.sh: the KSP error at rtol 1e-4 in 15-19 iterations) and
# the JAX package's recorded Q2 G[8^3] diagnostics (tests/test_golden.py:
# (r_2, e_max, e_L2) after F and after one V, rtol 2e-3)
FE_T220 = [(2.26e-02, 3.37e-02), (2.58e-02, 2.05e-03), (2.60e-02, 1.25e-04)]
FE_T230 = [(9.08e-03, 3.35e-04), (9.17e-03, 8.27e-07), (9.17e-03, 5.54e-09)]
FE_Q2_M8 = ((1.168401e-03, 1.023855e-02, 7.655858e-03),
            (2.944131e-05, 1.021663e-02, 7.789023e-03))
# the Q2 G[8^3] F-cycle's u on the card against the port's on the CPU,
# max|u_card - u_cpu| / max|u_cpu| (f64: cuBLAS and the CPU sum the
# contractions in other orders)
FE_CARD_CPU_TOL = 1e-12
# e_L2 rate of one Q2 F-cycle per doubling (order degree+1 = 3; the JAX
# package's tests hold 2.5 from M=4 to 8)
FE_RATE_LO = 2.5
# the FE path has no kernel of its own: its scopes in one profiled F-cycle
FE_SCOPES = (("gather", "op", "_elements"), ("contract", "op", "_contract"),
             ("contract_t", "op", "_contract_t"),
             ("metric product", "op", "FEOp._apply_metric"),
             ("assembly", "grid", "FEGrid.assemble_interior"),
             ("zero boundaries", "grid", "FEGrid.zero_boundaries"),
             ("interpolate", "grid", "FEGrid.interpolate"),
             ("restrict", "grid", "FEGrid.restrict"),
             ("inject", "grid", "FEGrid.inject"),
             ("host reads", "fas", "_host_flag"))


def fe_table(results, expected, tag):
    got = [(s["rel_e"], s["rel_r"]) for _, s in results]
    for (ge, gr), (ee, er) in zip(got, expected):
        if not (abs(ge - ee) <= 5e-3 * ee and abs(gr - er) <= 5e-3 * er):
            raise AssertionError(f"{tag}: {got} against {expected}")


def fe_tables(dev):
    """Phase 14a: the reference's tables in f64 on the card, the CPU tests'
    limits; the Q2 G[8^3] F-cycle's u on the card against the CPU's."""
    from hpgmg_tpu_torch.fe import fas
    from hpgmg_tpu_torch.fe.grid import FEGrid
    from hpgmg_tpu_torch.fe.op import get_fe_op

    print("  t220: fmg -op_type poisson1 -M 8,16,24 -smooth 3,3 -mg_eig_target 2,0.2")
    r = fas.run_fmg(FEGrid((8, 16, 24), 1, (8 / 24, 16 / 24, 1.0)), get_fe_op("poisson1"),
                    pre=3, post=3, monitor=False, eig=(0.2, 2.0), device=dev)[3]
    fe_table(r, FE_T220, "t220")
    print("  t230: fmg -op_type poisson2 -M 4,4,6 -smooth 4,3 -poisson_solution wave")
    r = fas.run_fmg(FEGrid((4, 4, 6), 2, (4 / 6, 4 / 6, 1.0)), get_fe_op("poisson2"),
                    "wave", pre=4, post=3, monitor=False, device=dev)[3]
    fe_table(r, FE_T230, "t230")
    print("  t120: test-kspsolve -op_type poisson1 -M 8,12,16 -ksp_type chebyshev")
    _, its, err = fas.run_ksp(FEGrid((8, 12, 16), 1), get_fe_op("poisson1"), eig=(0.2, 2.0),
                              device=dev)
    if not (abs(err - 0.0393766) <= 1e-4 * 0.0393766 and 15 <= its <= 19):
        raise AssertionError(f"t120: error {err} in {its} iterations")
    op = get_fe_op("poisson2")
    us = []
    for d in (dev, torch.device("cpu")):
        levels = fas.build_fe_levels(FEGrid((8, 8, 8), 2), op, device=d)
        f = op.forcing(levels[0].grid, levels[0].coords, "sine")
        u = fas.fas_fcycle(op, levels, 0, f)
        got_f = [float(x) for x in fas.diagnostics(op, levels[0], f, u, "sine")]
        us.append(u.cpu())
        v = fas.fas_vcycle(op, levels, 0, f, u)
        got_v = [float(x) for x in fas.diagnostics(op, levels[0], f, v, "sine")]
        for got, want in zip((got_f, got_v), FE_Q2_M8):
            if not all(abs(g - w) <= 2e-3 * w for g, w in zip(got, want)):
                raise AssertionError(f"Q2 G[8^3] on {d}: {got} against {want}")
    diff, _ = relerr(*us)
    print(f"  Q2 G[8^3] F then V: (r_2, e_max, e_L2) {got_f} then {got_v}; F-cycle u "
          f"card vs CPU {diff:.3e}")
    if not diff <= FE_CARD_CPU_TOL:
        raise AssertionError(f"Q2 G[8^3] F-cycle u on the card vs the CPU: {diff}")
    return {"q2_m8_card_vs_cpu": diff, "t120_iterations": its, "t120_error": err}


def fe_rates(dev):
    """Phase 14b: one Q2 f64 F-cycle at G[32^3], G[64^3], G[128^3], its
    e_L2 rate above FE_RATE_LO at each step; the distorted G[64^3]
    (-coord_distort 0.05) converges to the uniform grid's error."""
    from hpgmg_tpu_torch.fe import fas
    from hpgmg_tpu_torch.fe.grid import FEGrid
    from hpgmg_tpu_torch.fe.op import get_fe_op

    op, out = get_fe_op("poisson2"), {}
    for m, distort in ((32, 0.0), (64, 0.0), (128, 0.0), (64, 0.05)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = fas.run_fmg(FEGrid((m, m, m), 2), op, distort=distort, num_vcycles=0,
                        device=dev)[3][0][1]
        torch.cuda.empty_cache()
        print(f"    {time.perf_counter() - t0:.3f} s (build, F-cycle, diagnostics)")
        if not all(math.isfinite(v) for v in s.values()):
            raise AssertionError(f"Q2 G[{m}^3] distort {distort}: {s}")
        out[f"q2_{m}{'_distorted' if distort else ''}"] = s
    rates = [math.log2(out[f"q2_{a}"]["e_L2"] / out[f"q2_{b}"]["e_L2"])
             for a, b in ((32, 64), (64, 128))]
    print(f"  e_L2 rates 32->64->128: {rates}")
    if not min(rates) > FE_RATE_LO:
        raise AssertionError(f"Q2 f64 e_L2 rates {rates}, limit {FE_RATE_LO}")
    dist, flat = out["q2_64_distorted"], out["q2_64"]
    if not (dist["r2"] <= 1e-2 and dist["e_L2"] <= 1.1 * flat["e_L2"]):
        raise AssertionError(f"distorted G[64^3]: {dist} against uniform {flat}")
    return {**out, "e_L2_rates": rates}


def fe_sampler(*argv):
    """Phase 14c/d: the sampler through the CLI (python -m
    hpgmg_tpu_torch.fe.cli sample ...), its lines printed and parsed by
    bench/analyze.py; every sample finite and positive."""
    import io
    from contextlib import redirect_stdout

    from hpgmg_tpu_torch.bench import analyze
    from hpgmg_tpu_torch.fe import cli

    print(f"  python -m hpgmg_tpu_torch.fe.cli {' '.join(argv)}", flush=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = cli.main(list(argv))
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"    {line}")
    samples, _ = analyze.parse(buf.getvalue().splitlines())
    print(f"    {wall:.3f} s")
    if rc != 0 or not samples or not all(
            s["time"] > 0 and s["meqs"] > 0 and s["gf"] > 0 for s in samples):
        raise AssertionError(f"sampler {argv}: rc {rc}, samples {samples}")
    return samples


def fe_profile(dev, m=128):
    """Phase 14e: where the time goes in one Q2 G[m^3] f32 F-cycle: its
    wall time (CUDA events, after a warm-up), the coarsest CG's host reads,
    and a torch.profiler trace with each FE scope (FE_SCOPES) as a
    record_function range: the device ms of its kernels, the device's busy
    ms and the idle share 1 - busy / wall."""
    import importlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from hpgmg_tpu_torch.fe import fas
    from hpgmg_tpu_torch.fe.grid import FEGrid
    from hpgmg_tpu_torch.fe.op import get_fe_op

    op = get_fe_op("poisson2")
    levels = fas.build_fe_levels(FEGrid((m, m, m), 2), op, torch.float32, device=dev)
    f = op.forcing(levels[0].grid, levels[0].coords, "sine")
    fas.fas_fcycle(op, levels, 0, f)
    reads = fas.host_reads
    wall = time_ms(lambda: fas.fas_fcycle(op, levels, 0, f), 3)
    reads = (fas.host_reads - reads) // 4

    saved = []
    for label, mod, attr in FE_SCOPES:
        owner = importlib.import_module(f"hpgmg_tpu_torch.fe.{mod}")
        if "." in attr:
            owner, attr = getattr(owner, attr.split(".")[0]), attr.split(".")[1]
        fn = getattr(owner, attr)

        def scoped(*a, _fn=fn, _label=label, **kw):
            with record_function(f"fe::{_label}"):
                return _fn(*a, **kw)

        saved.append((owner, attr, fn))
        setattr(owner, attr, scoped)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fas.fas_fcycle(op, levels, 0, f)
            torch.cuda.synchronize()
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    ev = prof.key_averages()
    scopes = {e.key[4:]: e.device_time_total / 1000.0 for e in ev
              if e.key.startswith("fe::") and e.device_type == DeviceType.CPU}
    host_ms = {e.key[4:]: e.cpu_time_total / 1000.0 for e in ev
               if e.key == "fe::host reads" and e.device_type == DeviceType.CPU}
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in ev
               if e.device_type == DeviceType.CUDA and not e.key.startswith("fe::"))
    busy /= 1000.0
    if not busy:
        raise AssertionError("torch.profiler shows no device time")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12,
                                    max_name_column_width=60))
    row = {"grid": [m] * 3, "dtype": "float32", "wall_ms": wall, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / wall, "host_reads_per_fcycle": reads,
           "scope_device_ms": scopes, "host_reads_cpu_ms": host_ms.get("host reads"),
           "levels": len(levels)}
    print(f"  one Q2 G[{m}^3] f32 F-cycle: {json.dumps(row)}")
    return row


def fe_on_card():
    """Phase 14: FE on the card. The counts reset before it and read after
    it: the FE path launches no kernel of K1-K8 and calls no plain
    version."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    out = {"tables": fe_tables(dev)}
    print(f"  (a) {time.perf_counter() - t0:.3f} s", flush=True)
    out["rates"] = fe_rates(dev)
    print(f"  (b) {time.perf_counter() - t0:.3f} s", flush=True)
    out["sampler_f32"] = fe_sampler("sample", "-op_type", "poisson2", "-local", "50,2097152",
                                    "-maxsamples", "8", "-dtype", "float32")
    torch.cuda.empty_cache()
    out["sampler_f64"] = fe_sampler("sample", "-op_type", "poisson2", "-local",
                                    "262144,2097152", "-maxsamples", "2", "-dtype", "float64")
    torch.cuda.empty_cache()
    print(f"  (c, d) {time.perf_counter() - t0:.3f} s", flush=True)
    out["profile"] = fe_profile(dev)
    torch.cuda.empty_cache()
    launches, plain = read_counts()
    stray = {k: v for k, v in {**launches, **plain}.items() if v}
    if stray:
        raise AssertionError(f"the FE path launched kernels or plain versions: {stray}")
    print(f"  no kernel of K1-K8 and no plain version launched; phase wall "
          f"{time.perf_counter() - t0:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the bench tooling on the card: the CLI's two timing tables, the
# memory report, a traced F-cycle and the weak sweep with a traced rank
# ---------------------------------------------------------------------------

def echoed(fn):
    """(fn(), its standard output), the output printed as well."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def parse_tables(text: str) -> list:
    """The per-level tables of bench/timing.py in ``text``: for each, its
    level dims and its rows (name -> seconds a level, None where blank)."""
    lines = text.splitlines()
    tables = []
    for i, line in enumerate(lines):
        if not line.startswith("level "):
            continue
        nlev = len(line[16:]) // 12
        rows = {}
        for row in lines[i + 2:]:
            rows[row[:16].strip()] = [
                float(c) if c else None
                for c in (row[16 + 12 * j:28 + 12 * j].strip() for j in range(nlev))]
            if row.startswith("total"):
                break
        tables.append({"dims": [int(d[:-2]) for d in lines[i + 1].split()[1:]],
                       "rows": rows})
    return tables


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_table(tag: str, table: dict, dims, filled) -> None:
    """Raise unless ``table`` has the level columns ``dims`` and every cell
    ``filled(row, level, last level)`` says the JAX layout fills is > 0
    (and every other cell blank)."""
    if table["dims"] != dims:
        raise AssertionError(f"{tag}: level columns {table['dims']}, not {dims}")
    last = len(dims) - 1
    for name, cells in table["rows"].items():
        if name == "total":
            continue
        for lev, v in enumerate(cells):
            want = filled(name, lev, last)
            if (v is not None) != want or (want and not v > 0.0):
                raise AssertionError(f"{tag}: cell ({name}, level {lev}) is {v}")


def timed_launches(op, hier, f, cfg) -> dict:
    """One timed F-cycle (solve/mg.py's timers mode) with the launches of
    each phase tallied by level (a wrapper around mg._phase reading
    kernels/counts.py before and after each phase); launches outside any
    phase (the final residual) under "outside"."""
    from hpgmg_tpu_torch.kernels import counts
    from hpgmg_tpu_torch.solve import mg

    shipped = mg._phase
    by_level = {}

    def tally(timers, lev, name, fn, x):
        before = counts.read()[0]
        out = shipped(timers, lev, name, fn, x)
        for k, v in counts.read()[0].items():
            if v > before[k]:
                key = f"L{lev} {hier.levels[lev].dim}^3"
                by_level.setdefault(key, {})[k] = by_level.get(key, {}).get(k, 0) + v - before[k]
        return out

    reset_counts()
    mg._phase = tally
    try:
        mg.fmg_solve(op, hier, f, cfg, timers={})
        sync(f.device)
    finally:
        mg._phase = shipped
    total, plain = read_counts()
    if any(plain.values()):
        raise AssertionError(f"the timed F-cycle ran a plain version: {plain}")
    outside = {k: v - sum(lv.get(k, 0) for lv in by_level.values())
               for k, v in total.items() if v}
    by_level["outside"] = {k: v for k, v in outside.items() if v}
    return by_level


# phase 15a's rounds in turns: an untimed chain of TURNS_CHAIN F-cycles,
# then one timed F-cycle
TURNS_ROUNDS = 5
TURNS_CHAIN = 3


def timed_against_untimed(op, hier, f, cfg) -> dict:
    """Phase 15a: the timed F-cycle (solve/mg.py's timers mode, a device
    sync around each phase, no K4 tail) against the untimed one, in turns
    on the same hierarchy: TURNS_ROUNDS rounds, each an untimed chain of
    TURNS_CHAIN F-cycles between CUDA events (bench/driver.py:elapsed, s a
    solve) and then one timed F-cycle (its TIMED_PHASES seconds summed, as
    the CLI's table totals them). Raises unless the least timed total is
    >= the least untimed s a solve: the timers drop no work. The rounds
    alternate so that a slow spell of the card or host falls on both sides
    and not on one number alone (one run of this phase read the CLI's
    chain at 0.082 s a solve where others read 0.052-0.055 s, and its
    timed total at 0.079 s; H100 80GB HBM3)."""
    from hpgmg_tpu_torch.bench.driver import elapsed
    from hpgmg_tpu_torch.bench.timing import TIMED_PHASES
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    def chain():
        for _ in range(TURNS_CHAIN):
            fmg_solve(op, hier, f, cfg)

    def timed():
        timers = {}
        fmg_solve(op, hier, f, cfg, timers=timers)
        sync(f.device)
        return sum(v for (_, ph), v in timers.items() if ph in TIMED_PHASES)

    chain()
    timed()
    untimed_s, timed_s = [], []
    for _ in range(TURNS_ROUNDS):
        untimed_s.append(elapsed(f.device, chain) / TURNS_CHAIN)
        timed_s.append(timed())
    lo_u, lo_t = min(untimed_s), min(timed_s)
    print(f"  in turns, {TURNS_ROUNDS} rounds: untimed s a solve "
          f"{[round(v, 6) for v in untimed_s]}, timed "
          f"{[round(v, 6) for v in timed_s]}; least timed {lo_t:.6f} s against least "
          f"untimed {lo_u:.6f} s: ratio {lo_t / lo_u:.4f}")
    if not lo_t >= lo_u:
        raise AssertionError(f"timed solve {lo_t} s < the untimed {lo_u} s a solve")
    return {"untimed_s": untimed_s, "timed_s": timed_s, "ratio": lo_t / lo_u}


def tooling_tables(gsrb_ms: float, dev: torch.device, n: int) -> dict:
    """Phase 15a: the CLI with both tables on the headline (fv4, n^3 (512),
    f32, DIRECT bottom, min_coarse_dim 8): a level column for each of n ...
    8, every cell the JAX layout fills > 0; the timed F-cycle against the
    untimed one in turns (timed_against_untimed); measure_breakdown's n^3
    smooth within 25% of
    (K1 launches in one smooth call) x (K1's gsrb time ``gsrb_ms`` from
    phase 3); then the timed F-cycle's launches by level."""
    from hpgmg_tpu_torch.bench import cli
    from hpgmg_tpu_torch.bench.driver import build
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.solve.smoothers import smooth

    rc, text = echoed(lambda: cli.main([
        "--n", str(n), "--op", "fv4", "--bottom", "direct", "--min-coarse-dim", "8",
        "--dtype", "float32", "--dynamic-range", "1", "--min-seconds", "0.5",
        "--device", dev.type, "--timing-table", "--solve-timing-table"]))
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}")
    chain_s = float(re.search(r"([0-9.]+) s/solve", text).group(1))
    breakdown, solve_table = parse_tables(text)
    dims = [n >> i for i in range(n.bit_length() - 3)]  # n ... 8
    check_table("measure_breakdown", breakdown, dims, lambda name, lev, last: (
        name in ("smooth", "residual", "blas1")
        or (name in ("transfer_v", "transfer_f") and lev < last)
        or (name == "bottom" and lev == last)))
    check_table("fmg_timing_table", solve_table, dims, lambda name, lev, last: (
        name == "bottom") == (lev == last))
    solve_s = sum(solve_table["rows"]["total"])
    print(f"  the CLI: timed solve {solve_s:.6f} s, its chain {chain_s:.6f} s a solve "
          f"(measured seconds apart; held in turns below)")

    cfg = solve_cfg("direct", torch.float32)
    op = get_suite("fv4")
    hier, f = build(n, cfg, dev)
    turns = timed_against_untimed(op, hier, f, cfg)
    lv = hier.levels[0]
    x, r = torch.zeros_like(f), torch.ones_like(f)
    smooth(op, lv, x, r, cfg)
    sync(dev)
    reset_counts()
    smooth(op, lv, x, r, cfg)
    sync(dev)
    launches = read_counts()[0]
    k1 = launches["fv4_stencil"]
    if not k1 > 0:
        raise AssertionError(f"one {n}^3 smooth call launched no K1: {launches}")
    expect_ms = k1 * gsrb_ms
    got_ms = breakdown["rows"]["smooth"][0] * 1e3
    print(f"  measure_breakdown's {n}^3 smooth {got_ms:.3f} ms against {k1} K1 gsrb "
          f"launches x {gsrb_ms:.4f} ms = {expect_ms:.3f} ms (ratio "
          f"{got_ms / expect_ms:.4f}); one smooth call launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if not abs(got_ms - expect_ms) <= 0.25 * expect_ms:
        raise AssertionError(f"{n}^3 smooth {got_ms} ms against {expect_ms} ms")
    by_level = timed_launches(op, hier, f, cfg)
    print(f"  launches of the timed F-cycle by level: {by_level}")
    return {"chain_s_per_solve": chain_s, "timed_solve_s": solve_s, "in_turns": turns,
            "breakdown": breakdown, "solve_table": solve_table,
            "smooth_512_ms": got_ms, "smooth_512_expect_ms": expect_ms,
            "timed_launches_by_level": by_level, "hier": hier, "f": f}


def hierarchy_bytes(hier) -> int:
    """Bytes of the distinct tensors the hierarchy's levels hold."""
    seen = {}
    for lv in hier.levels:
        for fld in dataclasses.fields(lv):
            v = getattr(lv, fld.name)
            for t in (v if isinstance(v, tuple) else (v,)):
                if isinstance(t, torch.Tensor):
                    seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def tooling_memory(hier, f) -> dict:
    """Phase 15b: utils/memory.py after the 512^3 build: bytes_in_use at
    least the hierarchy's and the rhs's tensors, at most bytes_limit."""
    from hpgmg_tpu_torch.utils.memory import device_memory_stats, format_memory_report

    sync(f.device)
    held = hierarchy_bytes(hier) + f.numel() * f.element_size()
    print(format_memory_report())
    stats = device_memory_stats()["cuda:0"]
    used, limit = stats["bytes_in_use"], stats["bytes_limit"]
    print(f"  bytes_in_use {used} against the hierarchy's and rhs's {held} bytes; "
          f"bytes_limit {limit}")
    if not held <= used <= limit:
        raise AssertionError(f"bytes_in_use {used} outside [{held}, {limit}]")
    return {"bytes_in_use": used, "bytes_limit": limit, "hierarchy_bytes": held}


def tooling_trace(hier, f) -> dict:
    """Phase 15c: utils.profiler.trace around one untimed headline F-cycle:
    an mg.L{lev}.* range on every level, mg.L{lev}.tail on each level whose
    V-cycle takes the tail (one K4c launch a range), and >= 90% of the
    F-cycle's kernel time inside the ranges; the ten largest ranges."""
    from hpgmg_tpu_torch.kernels.tail import use_tail
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.solve.mg import fmg_solve
    from hpgmg_tpu_torch.utils.profiler import kernel_ms_by_range, read_trace, trace

    cfg = solve_cfg("direct", torch.float32)
    op = get_suite("fv4")
    fmg_solve(op, hier, f, cfg)
    sync(f.device)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        with trace(tmp) as log_dir:
            fmg_solve(op, hier, f, cfg)
        launches = read_counts()[0]
        events = read_trace(log_dir)
    by_range, total, inside = kernel_ms_by_range(events)
    levels = {int(name.split(".")[1][1:]) for name in by_range}
    tails = {lev for lev in range(len(hier.levels)) if use_tail(op, cfg, hier.levels, lev)}
    tail_calls = sum(by_range[f"mg.L{lev}.tail"][1] for lev in tails
                     if f"mg.L{lev}.tail" in by_range)
    top = sorted(by_range.items(), key=lambda kv: -kv[1][0])[:10]
    if not total > 0.0:
        raise AssertionError("the trace of the F-cycle holds no kernel")
    print(f"  kernels {total:.3f} device ms in the F-cycle, {inside:.3f} inside the "
          f"mg.L ranges ({inside / total:.4f}); tail ranges on levels {sorted(tails)}: "
          f"{tail_calls} calls, K4c launches {launches['tail_v']}")
    for name, (ms, calls) in top:
        print(f"    {name:28s} {ms:9.4f} device ms in {calls} calls")
    if levels != set(range(len(hier.levels))):
        raise AssertionError(f"mg.L ranges on levels {sorted(levels)}")
    empty = [lev for lev in sorted(tails)
             if by_range.get(f"mg.L{lev}.tail", (0.0, 0))[0] <= 0.0]
    if not tails or empty:
        for lev in empty:
            tail_range_events(events, f"mg.L{lev}.tail")
        raise AssertionError(f"no tail range with kernel time on levels {empty} of "
                             f"{sorted(tails)}")
    if tail_calls != launches["tail_v"]:
        raise AssertionError(f"{tail_calls} tail ranges against {launches['tail_v']} K4c")
    if not inside >= 0.9 * total:
        raise AssertionError(f"{inside} of {total} device ms inside the ranges")
    interp = interpolation_host(events, by_range)
    return {"kernel_ms": total, "inside_ms": inside, "interpolation_host": interp,
            "top_ranges": {name: {"device_ms": ms, "calls": c} for name, (ms, c) in top}}


def tail_range_events(events: list, name: str) -> None:
    """Print what a trace holds for each ``name`` range: its span and
    thread, the launch calls on that thread inside it (their correlation
    and whether a kernel event carries it), and every kernel event whose
    name holds "tail" (its correlation, start and launch found or not)."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = {e.get("args", {}).get("correlation"): e for e in events
               if e.get("cat") == "kernel"}
    for r in events:
        if r.get("cat") != "user_annotation" or r.get("name") != name:
            continue
        lo, hi = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        print(f"  {name}: ts {lo} .. {hi}, pid {r.get('pid')} tid {r.get('tid')}")
        for c, e in sorted(launches.items(), key=lambda kv: float(kv[1]["ts"])):
            if lo <= float(e["ts"]) <= hi:
                k = kernels.get(c)
                print(f"    launch {e['name']} ts {e['ts']} pid {e.get('pid')} tid "
                      f"{e.get('tid')} correlation {c}: kernel "
                      f"{None if k is None else (k['name'][:60], k['ts'], k['dur'])}")
    for c, k in kernels.items():
        if "tail" in k.get("name", ""):
            e = launches.get(c)
            print(f"  kernel {k['name'][:60]} ts {k['ts']} correlation {c}: launch "
                  f"{None if e is None else (e['name'], e['ts'], e.get('tid'))}")


GEMM_OPS = ("aten::mm", "aten::bmm", "aten::matmul")


def interpolation_host(events: list, by_range: dict) -> dict:
    """Phase 15c: where the host time of each level's interpolation ranges
    (``mg.L{lev}.interpolation`` and ``.interpolation_f``) goes: the
    matrix build (the range's start to its first GEMM op, ``interp_matrix``
    and the tap ops it runs), the GEMMs (``sep_apply``) and the rest (the
    final axpy), with the outermost host ops of the build counted. Host
    times are of the traced run, profiler overhead included."""
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: float(e["ts"]))
    out = {}
    for r in events:
        name = r.get("name", "")
        if r.get("cat") != "user_annotation" or not (
                name.startswith("mg.L") and name.endswith((".interpolation",
                                                           ".interpolation_f"))):
            continue
        lo, hi = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        outer, end = [], lo
        for o in ops:  # the outermost ops inside the range, in order
            a, b = float(o["ts"]), float(o["ts"]) + float(o["dur"])
            if (o.get("pid"), o.get("tid")) != (r.get("pid"), r.get("tid")):
                continue
            if a >= lo and b <= hi and a >= end:
                outer.append(o)
                end = b
        first = next((float(o["ts"]) for o in outer if o["name"] in GEMM_OPS), hi)
        gemm = sum(float(o["dur"]) for o in outer if o["name"] in GEMM_OPS)
        acc = out.setdefault(name, {"calls": 0, "host_ms": 0.0, "build_ms": 0.0,
                                    "gemm_ms": 0.0, "build_ops": 0})
        acc["calls"] += 1
        acc["host_ms"] += (hi - lo) / 1e3
        acc["build_ms"] += (first - lo) / 1e3
        acc["gemm_ms"] += gemm / 1e3
        acc["build_ops"] += sum(float(o["ts"]) < first for o in outer)
    print("  interpolation ranges, host ms a call (traced): total, matrix build "
          "(its outermost ops), GEMMs, rest; device ms a call")
    for name in sorted(out, key=lambda s: (int(s.split(".")[1][1:]), s)):
        acc = out[name]
        c = acc["calls"]
        h, b, g = acc["host_ms"] / c, acc["build_ms"] / c, acc["gemm_ms"] / c
        acc["device_ms"] = by_range.get(name, (0.0, 0))[0]
        print(f"    {name:24s} {c:2d} calls: host {h:.4f}, build {b:.4f} ({b / h:.3f}, "
              f"{acc['build_ops'] / c:.1f} ops), GEMMs {g:.4f}, rest {h - b - g:.4f}; "
              f"device {acc['device_ms'] / c:.4f}")
    if not out:
        raise AssertionError("no interpolation range in the trace")
    return out


def tooling_weak(dev: torch.device, per_rank: int) -> dict:
    """Phase 15d: bench/weak.py's sweep over 1 and 4 ranks (gloo, sharing
    this card) with --trace: both JAX lines, and from rank 0's trace of
    the 4-rank chain the shares of its wall time in the process group's
    communication, in kernels and in neither."""
    from hpgmg_tpu_torch.bench import weak

    with tempfile.TemporaryDirectory() as tmp:
        rc, text = echoed(lambda: weak.main([
            "--ranks", "1", "4", "--per-rank", str(per_rank), "--backend", "gloo",
            "--device", dev.type, "--reps", "3", "--trace", tmp, "--timeout", "600"]))
    if rc != 0:
        raise AssertionError(f"bench.weak exited {rc}")
    lines = text.splitlines()
    jax_lines = [line for line in lines if line.startswith("devices=")]
    records = [json.loads(line) for line in lines if line.startswith("{")]
    if len(jax_lines) != 2 or [r["ranks"] for r in records] != [1, 4]:
        raise AssertionError(f"the sweep printed {lines}")
    tr = records[1]["trace"]
    print(f"  rank 0 of 4, its traced chain of {tr['solves']} solves: wall "
          f"{tr['wall_ms']:.3f} ms; communication {tr['comm_share']:.4f}, kernels "
          f"{tr['kernel_share']:.4f} (both at once {tr['overlap_share']:.4f}), neither "
          f"{tr['neither_share']:.4f}, of it in CUDA copies and syncs "
          f"{tr['host_wait_share']:.4f}")
    if not (tr["kernel_share"] > 0.0 and records[1]["launches"].get("fv4_slab", 0) > 0):
        raise AssertionError(f"the 4-rank run: kernel share {tr['kernel_share']}, "
                             f"launches {records[1]['launches']}")
    return {"jax_lines": jax_lines,
            "seconds_per_solve": [r["seconds_per_solve"] for r in records],
            "rank0_trace": tr}


def tooling(gsrb_ms: float, dev=torch.device("cuda"), n=512, per_rank=128) -> dict:
    """Phase 15: (a)-(d) above at the headline's n = 512 and 128^3 cells a
    rank (smaller ``n`` and ``per_rank``, and ``dev`` the CPU, rehearse it
    without a card)."""
    t0 = time.perf_counter()
    a = tooling_tables(gsrb_ms, dev, n)
    hier, f = a.pop("hier"), a.pop("f")
    print(f"  (a) {time.perf_counter() - t0:.3f} s", flush=True)
    b = tooling_memory(hier, f)
    c = tooling_trace(hier, f)
    del hier, f
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"  (b, c) {time.perf_counter() - t0:.3f} s", flush=True)
    d = tooling_weak(dev, per_rank)
    print(f"  (d) {time.perf_counter() - t0:.3f} s", flush=True)
    return {"tables": a, "memory": b, "trace": c, "weak": d}


# ---------------------------------------------------------------------------
# phase 16: the 3D process grid: K8a-K8d with k slabs, the (2,2,2) F-cycles
# ---------------------------------------------------------------------------

# the blocks of the k-split checks: the (2,2,2) grid's at 128^3 and 256^3,
# and a block split along k of the 2x2 grid's extents
KSLAB_BLOCKS = ((64, 64, 64), (64, 64, 128), (128, 128, 128), (128, 128, 256))
KSLAB_TOL = {torch.float32: F32_TOL, torch.float64: F64_TOL}


def kslab_operands(block, dtype, dev, rng, kind: str, kring: bool = True):
    """A block split along k (``kring``; else whole along k) as the main
    path hands it to the slab kernels: the level (kind "fv4": the
    tangentially-extended faces with their margins; "r1": the natural
    faces; "k8d": K8d's ring views, with the k ring where ``kring``), its
    kdinv pair and alpha, x, rhs (K8d: the rhs ring) and the random slabs
    of the kind's depth (six where ``kring``, else four)."""
    from hpgmg_tpu_torch.core.level import Level, rb_mask

    ni, nj, nk = block
    n = 2 * max(block) + 2

    def t(*shape, lo=None):
        a = rng.standard_normal(shape) if lo is None else lo + 0.25 * rng.random(shape)
        return torch.tensor(a, dtype=dtype, device=dev)

    scale = 1.0 / (8.0 * n * n)
    dinv = scale * t(ni, nj, nk, lo=2.0)
    mask = rb_mask(n, 0, dtype, dev)[:ni, :nj, :nk]
    d = 1 if kind == "r1" else 2
    slabs = (t(d, nj, nk), t(d, nj, nk), t(ni + 2 * d, d, nk), t(ni + 2 * d, d, nk))
    if kring:
        slabs += (t(ni + 2 * d, nj + 2 * d, d), t(ni + 2 * d, nj + 2 * d, d))
    if kind == "k8d":
        kr = nk + 2 if kring else nk
        # a ring cell (I, J, K) is cell (I-1, J-1, K-1) of the block (K
        # without a k ring); block offsets are even
        red = rb_mask(n, 1 if kring else 0, dtype, dev)[:ni + 2, :nj + 2, :kr]
        faces = (t(ni + 3, nj + 2, kr, lo=1.0), t(ni + 2, nj + 3, kr, lo=1.0),
                 t(ni + 2, nj + 2, kr + 1, lo=1.0))
        lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=faces[0], beta_j=faces[1],
                   beta_k=faces[2], kdinv=(None, (1 - mask) * dinv),
                   ring=(red * scale * t(ni + 2, nj + 2, kr, lo=2.0), None, *faces))
        return lv, t(ni, nj, nk), t(ni + 2, nj + 2, kr), slabs
    m = 2 if kind == "fv4" else 0
    faces = ((ni + 1, nj + m, nk + m), (ni + m, nj + 1, nk + m), (ni + m, nj + m, nk + 1))
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=t(*faces[0], lo=1.0),
               beta_j=t(*faces[1], lo=1.0), beta_k=t(*faces[2], lo=1.0),
               alpha=t(ni, nj, nk, lo=0.5), dinv=dinv, kdinv=(mask * dinv, (1 - mask) * dinv))
    return lv, t(ni, nj, nk), t(ni, nj, nk), slabs


def domain_k_slabs(x, slabs, edges, taps: str):
    """K8d's k slabs with those on a domain k face (``edges[4:]``) holding
    the 2-tap Dirichlet ghost twice, as the exchange builds them (K8d makes
    its k ghosts there and reads no k slab; its plain version reads them)."""
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    xe = S.extend_slabs(x, slabs[:4])
    ghost = K.taps_ghost2(taps)
    return slabs[:4] + (ghost(xe[:, :, :2], 2, True).contiguous() if edges[4] else slabs[4],
                        ghost(xe[:, :, -2:], 2, False).contiguous() if edges[5] else slabs[5])


def check_kslab(worst: dict, blocks=KSLAB_BLOCKS):
    """Phase 16a: K8a-K8d with k slabs on blocks split along k against
    their plain versions, float32 (1e-5) and float64 (1e-12): K8a every
    mode, Poisson and Helmholtz, both BCs, K8b's two passes equal to it bit
    for bit where its split takes the block; K8c every mode, the var7 and
    27pt bodies, both BCs; K8d both bodies with the block's k sides on a
    domain face below, above or neither. Against the k-whole path: K8a
    given k slabs that hold the periodic wrap equals the kernel that wraps k
    itself bit for bit (K8c to rounding: its k-slab instantiation rounds
    the var7 sum apart); K8d with both k sides on domain faces equals K8d
    on the block whole along k bit for bit."""
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 16)
    for block in blocks:
        for dtype in (torch.float32, torch.float64):
            tol, tag = KSLAB_TOL[dtype], f"{block} {str(dtype)[6:]}"
            lv, x, rhs, slabs = kslab_operands(block, dtype, dev, rng, "fv4")
            split = S.overlap_grid_shape(*block) is not None
            for bc in (BC.DIRICHLET, BC.PERIODIC):
                for cfg in (SolverConfig(a=0.0, b=1.0, dtype=dtype, bc=bc),
                            SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=dtype, bc=bc)):
                    for mode, kw, par in (("apply", {}, None), ("residual", {"rhs": rhs}, None),
                                          ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}, 0),
                                          ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[1]}, 1)):
                        out = S.fv4_slab_cuda(lv, x, slabs, cfg, mode, parity=par, **kw)
                        ref = S.fv4_slab_plain(lv, x, slabs, cfg, mode, **kw)
                        rel, _ = relerr(out, ref)
                        if not rel <= tol:
                            raise AssertionError(f"K8a k-split {tag} {bc.value} {mode} "
                                                 f"{par}: {rel}")
                        worst["fv4_slab_kslab"] = max(worst.get("fv4_slab_kslab", 0.0), rel)
                        if split:
                            inner = S.fv4_overlap_interior_cuda(lv, x, cfg, mode, parity=par,
                                                                ksplit=True, **kw)
                            if not torch.equal(S.fv4_overlap_edge_cuda(
                                    lv, x, slabs, cfg, mode, inner, parity=par, **kw), out):
                                raise AssertionError(f"K8b k-split {tag} {mode}: not K8a")
            xe = S.extend_slabs(x, slabs[:4])
            wrap = slabs[:4] + (xe[:, :, -2:].contiguous(), xe[:, :, :2].contiguous())
            cfg = SolverConfig(a=0.0, b=1.0, dtype=dtype, bc=BC.PERIODIC)
            kw = {"rhs": rhs, "kdinv": lv.kdinv[0]}
            if not torch.equal(S.fv4_slab_cuda(lv, x, wrap, cfg, "gsrb", parity=0, **kw),
                               S.fv4_slab_cuda(lv, x, slabs[:4], cfg, "gsrb", parity=0, **kw)):
                raise AssertionError(f"K8a k-split {tag}: the wrap in k slabs differs")
            del lv, x, rhs, slabs, xe, wrap

            lr, x, rhs, slabs = kslab_operands(block, dtype, dev, rng, "r1")
            for bc in (BC.DIRICHLET, BC.PERIODIC):
                for taps, var7 in (("p1", True), ("27pt", False)):
                    cfg = SolverConfig(op="fv7pt" if var7 else "27pt", a=0.0, b=1.0,
                                       dtype=dtype, bc=bc)
                    for mode, kw in (("apply", {}), ("residual", {"rhs": rhs}),
                                     ("fres", {"rhs": rhs}),
                                     ("gsrb", {"rhs": rhs, "kdinv": lr.kdinv[1]})):
                        par = {"parity": 1} if mode == "gsrb" else {}
                        out = K.r1_slab_cuda(lr, x, slabs, cfg, mode, taps, var7, **kw, **par)
                        ref = K.r1_slab_plain(lr, x, slabs, cfg, mode, taps, var7, **kw)
                        rel, _ = relerr(out, ref)
                        if not rel <= tol:
                            raise AssertionError(f"K8c k-split {tag} {bc.value} {taps} "
                                                 f"{mode}: {rel}")
                        worst["r1_slab_kslab"] = max(worst.get("r1_slab_kslab", 0.0), rel)
            xe = S.extend_slabs(x, slabs[:4])
            wrap = slabs[:4] + (xe[:, :, -1:].contiguous(), xe[:, :, :1].contiguous())
            cfg = SolverConfig(op="fv7pt", a=0.0, b=1.0, dtype=dtype, bc=BC.PERIODIC)
            kw = {"rhs": rhs, "kdinv": lr.kdinv[1], "parity": 1}
            # to rounding: the k-slab instantiation rounds the var7 sum in
            # another order (an ulp, at interior cells too)
            a = K.r1_slab_cuda(lr, x, wrap, cfg, "gsrb", "p1", True, **kw)
            b = K.r1_slab_cuda(lr, x, slabs[:4], cfg, "gsrb", "p1", True, **kw)
            rel, _ = relerr(a, b)
            if not rel <= tol:
                raise AssertionError(f"K8c k-split {tag}: the wrap in k slabs: {rel}")
            worst["r1_slab_kslab_wrap"] = max(worst.get("r1_slab_kslab_wrap", 0.0), rel)
            del lr, x, rhs, slabs, xe, wrap

            l2, x, rhs2, slabs = kslab_operands(block, dtype, dev, rng, "k8d")
            for taps, var7 in (("p1", True), ("27pt", False)):
                cfg = SolverConfig(op="fv7pt" if var7 else "27pt", a=0.0, b=1.0, dtype=dtype)
                for edges in ((True, False, True, False, True, False),
                              (False, True, False, True, False, True), (False,) * 6):
                    s6 = domain_k_slabs(x, slabs, edges, taps)
                    out = K.r1_gsrb2_slab_cuda(l2, x, s6, edges, rhs2, cfg, taps, var7)
                    ref = K.r1_gsrb2_slab_plain(l2, x, s6, edges, rhs2, cfg, taps, var7)
                    rel, _ = relerr(out, ref)
                    if not rel <= tol:
                        raise AssertionError(f"K8d k-split {tag} {taps} {edges}: {rel}")
                    worst["r1_gsrb2_slab_kslab"] = max(worst.get("r1_gsrb2_slab_kslab", 0.0),
                                                       rel)
                edges = (True, False, False, True)
                whole = dataclasses.replace(l2, ring=tuple(
                    None if r is None else r[:, :, 1:-1].contiguous() for r in l2.ring[:4])
                    + (l2.ring[4][:, :, 1:-1].contiguous(),))
                if not torch.equal(
                        K.r1_gsrb2_slab_cuda(l2, x, slabs, edges + (True, True), rhs2, cfg,
                                             taps, var7),
                        K.r1_gsrb2_slab_cuda(whole, x, slabs[:4], edges,
                                             rhs2[:, :, 1:-1].contiguous(), cfg, taps, var7)):
                    raise AssertionError(f"K8d k-split {tag} {taps}: with both k sides on "
                                         "domain faces it differs from the k-whole sweep")
            del l2, x, rhs2, slabs
            torch.cuda.empty_cache()
        print(f"  K8a/K8b/K8c/K8d with k slabs on {block}: f32 and f64, both BCs, every "
              f"mode and body: within tolerance; equal to the k-whole kernels")


def time_kslab(blocks=((128, 128, 256), (128, 128, 128))):
    """Phase 16b: the slab kernels' times (float32, Dirichlet) on blocks
    split along k: K8a gsrb, K8b's two passes, K8c var7 gsrb, K8d var7
    sweep, each with k slabs against its plain version and bound (the six
    slabs read once), then in turns with the same kernel on the block of
    the same extent whole along k (events: whole, k-split, k-split,
    whole)."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 17)
    cfg = SolverConfig(a=0.0, b=1.0, dtype=torch.float32)
    out = {}
    for block in blocks:
        ni, nj, nk = block
        cells = ni * nj * nk
        label = f"({ni},{nj},{nk})"
        row = {}
        lv, x, rhs, slabs = kslab_operands(block, torch.float32, dev, rng, "fv4")
        kw = {"rhs": rhs, "kdinv": lv.kdinv[0]}
        runs = {"fv4_slab": (
            lambda: S.fv4_slab_cuda(lv, x, slabs, cfg, "gsrb", parity=0, **kw),
            lambda: S.fv4_slab_plain(lv, x, slabs, cfg, "gsrb", **kw),
            lambda: S.fv4_slab_cuda(lv, x, slabs[:4], cfg, "gsrb", parity=0, **kw),
            (nbytes(x, *slabs, lv.beta_i, lv.beta_j, lv.beta_k, rhs, lv.kdinv[0], x),
             mode_flops(FV4_AX, "gsrb", cells, 2)))}
        if S.overlap_grid_shape(*block) is not None:
            i0, i1, j0, j1, k0, k1 = S._interior_box(x, True)
            inner = (i1 - i0) * (j1 - j0) * (k1 - k0)
            whole = nbytes(x, lv.beta_i, lv.beta_j, lv.beta_k, rhs, lv.kdinv[0], x)
            out_k = S.fv4_overlap_interior_cuda(lv, x, cfg, "gsrb", parity=0, ksplit=True, **kw)
            out_p = S.fv4_overlap_interior_plain(lv, x, cfg, "gsrb", ksplit=True, **kw)
            runs["fv4_overlap_interior"] = (
                lambda: S.fv4_overlap_interior_cuda(lv, x, cfg, "gsrb", parity=0, ksplit=True,
                                                    **kw)[i0:i1, j0:j1, k0:k1],
                lambda: S.fv4_overlap_interior_plain(lv, x, cfg, "gsrb", ksplit=True,
                                                     **kw)[i0:i1, j0:j1, k0:k1],
                lambda: S.fv4_overlap_interior_cuda(lv, x, cfg, "gsrb", parity=0, **kw),
                (whole * inner / cells, mode_flops(FV4_AX, "gsrb", inner, 2)))
            runs["fv4_overlap_edge"] = (
                lambda: S.fv4_overlap_edge_cuda(lv, x, slabs, cfg, "gsrb", out_k, parity=0,
                                                **kw),
                lambda: S.fv4_overlap_edge_plain(lv, x, slabs, cfg, "gsrb", out_p.clone(),
                                                 **kw),
                lambda: S.fv4_overlap_edge_cuda(lv, x, slabs[:4], cfg, "gsrb", out_k,
                                                parity=0, **kw),
                (whole * (cells - inner) / cells + nbytes(*slabs),
                 mode_flops(FV4_AX, "gsrb", cells - inner, 2)))
        lr, xr, rr, rs = kslab_operands(block, torch.float32, dev, rng, "r1")
        rkw = {"rhs": rr, "kdinv": lr.kdinv[0]}
        runs["r1_slab"] = (
            lambda: K.r1_slab_cuda(lr, xr, rs, cfg, "gsrb", "p1", True, parity=0, **rkw),
            lambda: K.r1_slab_plain(lr, xr, rs, cfg, "gsrb", "p1", True, **rkw),
            lambda: K.r1_slab_cuda(lr, xr, rs[:4], cfg, "gsrb", "p1", True, parity=0, **rkw),
            (nbytes(xr, *rs, lr.beta_i, lr.beta_j, lr.beta_k, rr, lr.kdinv[0], xr),
             mode_flops(VAR7_AX, "gsrb", cells, 0)))
        l2, x2, r2, s2 = kslab_operands(block, torch.float32, dev, rng, "k8d")
        w2, wx, wr, ws = kslab_operands(block, torch.float32, dev, rng, "k8d", kring=False)
        e6 = (True, False, True, False, False, True)
        s2 = domain_k_slabs(x2, s2, e6, "p1")
        runs["r1_gsrb2_slab"] = (
            lambda: K.r1_gsrb2_slab_cuda(l2, x2, s2, e6, r2, cfg, "p1", True),
            lambda: K.r1_gsrb2_slab_plain(l2, x2, s2, e6, r2, cfg, "p1", True),
            lambda: K.r1_gsrb2_slab_cuda(w2, wx, ws, e6[:4], wr, cfg, "p1", True),
            (nbytes(x2, *s2, r2, *(t for t in l2.ring if t is not None), l2.kdinv[1], x2),
             2 * mode_flops(VAR7_AX, "gsrb", cells, 0)))
        for name, (kernel, plain, k_whole, work) in runs.items():
            time_pair(f"{name} k-split {label} f32", kernel, plain, 10, row, name, work=work)
            t = [time_ms(f, 10) for f in (k_whole, kernel, kernel, k_whole)]
            row[name]["in_turns_ms"] = {"k_split": t[1:3], "k_whole": [t[0], t[3]]}
            print(f"  {name} {label} in turns: k-split {t[1]:.4f} / {t[2]:.4f} ms, "
                  f"k-whole {t[0]:.4f} / {t[3]:.4f} ms")
        out[label] = row
        del lv, x, rhs, slabs, lr, xr, rr, rs, l2, x2, r2, s2, w2, wx, wr, ws, runs
        torch.cuda.empty_cache()
    return out


def decomposed_3d(op: str, n: int, dtype: str, order_range, rel_limit: float = 1e-3,
                  overlap: bool = False):
    """Phase 16c: the decomposed F-cycle through bench/weak.py:run_weak on
    the (2,2,2) grid of make_mesh: 8 processes sharing this GPU over gloo,
    as phase 13's 2x2 runs; held to the same limits, and every decomposed
    level split along k: the slab kernels launched with k slabs (and K8b's
    passes under ``overlap``), no launch without them, no single-rank
    stencil, fused sweep, tail kernel or plain version."""
    from hpgmg_tpu_torch.bench.weak import run_weak

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = run_weak(n // 2, 8, op, dtype, reps=1, backend="gloo", check_serial=True,
                 overlap=overlap, timeout=600.0)
    wall = time.perf_counter() - t0
    res, launches, plain = r["res"], r["launches"], r["plain_calls"]
    tag = f"{op} {n}^3 {dtype}" + (" OVERLAP" if overlap else "")
    print(f"  {tag} on the (2,2,2) grid (8 processes sharing one GPU, gloo, host-staged "
          f"halos): {res['seconds_per_solve']:.6f} s per solve, rel_residual "
          f"{res['rel_residual']:.6e} (one rank: {r['serial_rel_residual']:.6e}), order "
          f"{res['richardson_order']:.6f}, u vs one rank {r['serial_u_rel_diff']:.3e}; "
          f"phase wall {wall:.3f} s")
    print(f"  launches in the counted F-cycle: { {k: v for k, v in launches.items() if v} }")
    print(f"  K8a/K8b/K8c/K8d launches by local block (rank 0): "
          f"{r['slab_launches_by_block']}")
    if r["grid"] != [2, 2, 2]:
        raise AssertionError(f"{tag}: grid {r['grid']}")
    if not res["rel_residual"] <= rel_limit:
        raise AssertionError(f"{tag}: rel_residual {res['rel_residual']} > {rel_limit}")
    if not order_range[0] <= res["richardson_order"] <= order_range[1]:
        raise AssertionError(f"{tag}: order {res['richardson_order']} outside {order_range}")
    if not r["serial_u_rel_diff"] <= DECOMPOSED_U_TOL[dtype]:
        raise AssertionError(f"{tag}: u differs from the one-rank u by "
                             f"{r['serial_u_rel_diff']}")
    slab = ("fv4_slab",) if op == "fv4" else ("r1_slab", "r1_gsrb2_slab")
    slab += ("fv4_overlap_interior", "fv4_overlap_edge") if overlap else ()
    missing = [k for k in slab + tuple(f"{k}_kslab" for k in slab) + ("restrict_cell",)
               if not launches[k] > 0]
    whole = [k for k in slab if launches[k] != launches[f"{k}_kslab"]]
    stray = [k for k in SINGLE_RANK if launches[k]]
    if missing or whole or stray or any(plain.values()):
        raise AssertionError(f"{tag}: kernels not launched {missing}, launched without k "
                             f"slabs {whole}, launched off the path {stray}, plain calls "
                             f"{ {k: v for k, v in plain.items() if v} }")
    r["wall_seconds_phase"] = wall
    return r


def grid3d_on_card(worst: dict) -> dict:
    """Phase 16: check_kslab, time_kslab, and the (2,2,2) F-cycles of fv4
    and fv7pt at 256^3 float32 (128^3 a rank), and of fv4 at 256^3 float64
    with OVERLAP on (K8b's passes with k slabs on the 128^3 blocks, the
    only ones with 3 column tiles along k); its wall time printed."""
    t0 = time.perf_counter()
    check_kslab(worst)
    times = time_kslab()
    dec = {"fv4": decomposed_3d("fv4", 256, "float32", (3.0, float("inf"))),
           "fv7pt": decomposed_3d("fv7pt", 256, "float32", (1.8, 2.2), rel_limit=1e-2),
           "fv4_f64": decomposed_3d("fv4", 256, "float64", (3.8, float("inf")),
                                    overlap=True)}
    wall = time.perf_counter() - t0
    print(f"  phase 16 wall {wall:.3f} s")
    return {"times": times, "decomposed": dec, "wall_seconds": wall}


# ---------------------------------------------------------------------------
# phase 17: the FE solver and sampler decomposed over the 3D process grid
# ---------------------------------------------------------------------------

# (op, M, L, V-cycles after the F-cycle) of 17a, float64; the decomposed u
# against the one-rank u on the card, max|u_ranks - u_one| / max|u_one|
FE_GRID_CASES = (("poisson1", (8, 8, 8), (1.0, 1.0, 1.0), 0),
                 ("poisson2", (4, 4, 6), (4 / 6, 4 / 6, 1.0), 1),
                 ("poisson2", (64, 64, 64), (1.0, 1.0, 1.0), 0))
FE_GRID_TOL = 1e-12
# 17b: F-cycles a timed chain of the G[128^3] sample (one repeat: the
# sampler's only sample is its "instant feedback" one)
FE_GRID_CHAIN = 2


def fe_grid_solves(device, cases) -> dict:
    """A rank of 17a: each case's F-cycle (and V-cycles) on the make_mesh
    grid, the levels built on the blocks; rank 0's result: the gathered u
    after each cycle, each level's split (None: replicated), the seconds
    of the cycles (the slowest rank's) and the kernel counts."""
    from hpgmg_tpu_torch.bench.driver import slowest
    from hpgmg_tpu_torch.fe.fas import build_fe_levels, fas_fcycle, fas_vcycle
    from hpgmg_tpu_torch.fe.grid import FEGrid
    from hpgmg_tpu_torch.fe.mesh import gather_fe_field
    from hpgmg_tpu_torch.fe.op import get_fe_op
    from hpgmg_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device)
    reset_counts()
    out = {"grid": mesh.shape, "cases": {}}
    for case in cases:
        name, M, L, cycles = case
        op = get_fe_op(name)
        levels = build_fe_levels(FEGrid(M, op.degree, L), op, torch.float64, device=device,
                                 mesh=mesh)
        f = op.forcing(levels[0].block, levels[0].coords, "sine")
        sync(device)
        t0 = time.perf_counter()
        us = [fas_fcycle(op, levels, 0, f)]
        for _ in range(cycles):
            us.append(fas_vcycle(op, levels, 0, f, us[-1]))
        sync(device)
        seconds = slowest(time.perf_counter() - t0, mesh)
        out["cases"][case] = {
            "u": [gather_fe_field(levels[0].part, u).cpu() for u in us],
            "split": [None if lv.part is None else lv.part.split for lv in levels],
            "seconds": seconds}
    out["counts"] = every_rank_counts()
    return out


def fe_grid_sample(device, local, chain) -> dict:
    """A rank of 17b: the sampler (fe/sampler.py:run_sample, the CLI's
    sample action on ranks) at ``local`` elements, Q2 float32, one sample
    of ``chain`` F-cycles a timed chain; rank 0's result: the kernel
    counts of every rank."""
    from hpgmg_tpu_torch.fe.op import get_fe_op
    from hpgmg_tpu_torch.fe.sampler import run_sample

    reset_counts()
    op = get_fe_op("poisson2")
    run_sample(op, degree=op.degree, local=local, maxsamples=1, dtype=torch.float32,
               device=device, chain=chain)
    return {"counts": every_rank_counts()}


def every_rank_counts() -> list:
    """Each rank's (launches, plain calls) of the group, by rank."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, read_counts())
    return out


def stray_counts(per_rank) -> dict:
    """The nonzero counts among ``per_rank`` (read_counts pairs), by rank."""
    out = {}
    for rank, (launches, plain) in enumerate(per_rank):
        nz = {k: v for k, v in {**launches, **plain}.items() if v}
        if nz:
            out[rank] = nz
    return out


def fe_grid_one_rank(case, dev):
    """The one-rank u of a 17a case on ``dev``, after each cycle."""
    from hpgmg_tpu_torch.fe import fas
    from hpgmg_tpu_torch.fe.grid import FEGrid
    from hpgmg_tpu_torch.fe.op import get_fe_op

    name, M, L, cycles = case
    op = get_fe_op(name)
    levels = fas.build_fe_levels(FEGrid(M, op.degree, L), op, torch.float64, device=dev)
    f = op.forcing(levels[0].grid, levels[0].coords, "sine")
    us = [fas.fas_fcycle(op, levels, 0, f)]
    for _ in range(cycles):
        us.append(fas.fas_vcycle(op, levels, 0, f, us[-1]))
    return [u.cpu() for u in us]


def fe_grid_on_card(dev=torch.device("cuda"), cases=FE_GRID_CASES,
                    sample_local=(262144, 262144), chain=FE_GRID_CHAIN) -> dict:
    """Phase 17 (``dev`` the CPU and smaller ``cases`` and
    ``sample_local`` rehearse it without a card)."""
    import io
    from contextlib import redirect_stdout

    from hpgmg_tpu_torch.bench import analyze
    from hpgmg_tpu_torch.fe.mesh import _axis_spec
    from hpgmg_tpu_torch.parallel.launch import spawn_ranks

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    res = spawn_ranks(8, "gloo", dev, fe_grid_solves, (cases,), timeout=600.0)
    out = {"grid": list(res["grid"]), "solves": {}}
    if tuple(res["grid"]) != (2, 2, 2):
        raise AssertionError(f"make_mesh on 8 ranks gave {res['grid']}")
    for case in cases:
        name, M, L, cycles = case
        got = res["cases"][case]
        want = fe_grid_one_rank(case, dev)
        diffs = [relerr(a, b)[0] for a, b in zip(got["u"], want, strict=True)]
        g = M
        split = []
        while True:
            spec = _axis_spec((2, 2, 2), g)
            split.append(None if all(a is None for a in spec)
                         else tuple(a is not None for a in spec))
            if any(m % 2 for m in g):
                break
            g = tuple(m // 2 for m in g)
        tag = f"{name} M={M} F{'+V' * cycles}"
        print(f"  {tag}: levels split {got['split']}; u vs one rank after each cycle "
              f"{['%.3e' % d for d in diffs]}; the cycles {got['seconds']:.3f} s (slowest rank)")
        if got["split"] != split or not max(diffs) <= FE_GRID_TOL:
            raise AssertionError(f"{tag}: split {got['split']} (want {split}), u vs one rank "
                                 f"{diffs} (limit {FE_GRID_TOL})")
        out["solves"][tag] = {"u_vs_one_rank": diffs, "split": got["split"],
                              "seconds": got["seconds"]}
    stray = {"a": stray_counts(res["counts"])}
    print(f"  (a) {time.perf_counter() - t0:.3f} s", flush=True)
    print(f"  the sampler on 8 gloo ranks (python -m hpgmg_tpu_torch.fe.cli sample "
          f"-op_type poisson2 -local {sample_local[0]},{sample_local[1]} -maxsamples 1 "
          f"-dtype float32 -ranks 8 -backend gloo, {chain} F-cycles a chain)", flush=True)
    buf = io.StringIO()
    t1 = time.perf_counter()
    with redirect_stdout(buf):
        res_b = spawn_ranks(8, "gloo", dev, fe_grid_sample, (sample_local, chain),
                            timeout=900.0)
    wall_b = time.perf_counter() - t1
    for line in buf.getvalue().splitlines():
        print(f"    {line}")
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("Q2 ")]
    samples, _ = analyze.parse(lines)
    if not (len(samples) == len(lines) == 1 and "P[  2  2  2]" in lines[0]
            and samples[0]["time"] > 0 and samples[0]["meqs"] > 0 and samples[0]["gf"] > 0):
        raise AssertionError(f"the sampler on 8 ranks: samples {samples}, lines {lines}")
    out["sampler"] = {"samples": samples, "chain": chain, "wall_seconds": wall_b}
    print(f"  (b) {wall_b:.3f} s", flush=True)
    stray["b"] = stray_counts(res_b["counts"])
    launches, plain = read_counts()
    stray["parent"] = {k: v for k, v in {**launches, **plain}.items() if v}
    if any(stray.values()):
        raise AssertionError(f"the decomposed FE path launched kernels or plain "
                             f"versions: {stray}")
    out["wall_seconds"] = time.perf_counter() - t0
    print(f"  no kernel of K1-K8 and no plain version launched (here and on each of the "
          f"8 ranks of (a) and of (b)); phase wall {out['wall_seconds']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 18: bfloat16 (the fv4 Dirichlet path) and BF16C
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# a bf16 output against its plain version: the same float32 arithmetic on
# the same widened operands and one rounding, so equal, or one bf16 unit in
# the last place of the cell apart where the float32 sums differ in order
# (the kernels' ghosts are tensor products of taps, the plain version's a
# separable fill); at a cell that cancels far below max|output| (its bf16
# unit below F32_TOL * max|output|) the float32 kernels' own tolerance
# holds instead (bf16_ulps)
BF16_CELL_ULPS = 1.0
# the kernels that chain roundings (K2c: two half-sweeps; K4a, K4b: six
# half-sweeps a level, e, res and the climb's interpolation), against their
# plain versions with the same roundings: a one-ulp difference at a cell
# moves its neighbours' next update, so the bound is in units in the last
# place of max|output| (bf16_max_ulps; measured on an H100 80GB HBM3 at
# 700 W on random levels: K2c 0.0625, K4a 0.031, K4b 3.1e-5)
BF16_CHAIN_ULPS = {"K2c": 1.0, "K4a": 1.0, "K4b": 1.0, "K6": 1.0}
# BF16C: a float32 half-sweep with bf16 coefficients, against the float32
# half-sweep (the JAX package's test_bf16c_gsrb_close_to_f32 bound)
BF16C_VS_F32 = 5e-3


def bf16_spacing(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |v| (2^(e-7) for |v| in [2^e,
    2^(e+1))), at least the smallest normal's."""
    return torch.exp2(torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126))) - 7)


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max over cells of |out - ref| in units in the last place of ref, a
    unit being at least F32_TOL * max|ref| (see BF16_CELL_ULPS)."""
    r = ref.float()
    unit = torch.clamp_min(bf16_spacing(r), F32_TOL * float(r.abs().max()))
    return float(((out.float() - r).abs() / unit).max())


def bf16_max_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max|out - ref| in units in the last place of max|ref|."""
    diff = (out.float() - ref.float()).abs().max()
    return float(diff / bf16_spacing(ref.float().abs().max()))


def bf16_cfgs():
    from hpgmg_tpu_torch.core.config import SolverConfig

    return (("", SolverConfig(a=0.0, b=1.0, dtype=BF16)),
            ("+alpha", SolverConfig(a=1.5, b=1.0, helmholtz=True, dtype=BF16)))


def hold_ulps(label: str, got: float, limit: float, worst: dict, name: str):
    print(f"  {label}: {got:.3f} ulps (limit {limit})")
    if not got <= limit:
        raise AssertionError(f"{label}: {got} ulps > {limit}")
    worst[name] = max(worst.get(name, 0.0), got)


def check_bf16_kernels(worst: dict, sizes=(4, 5, 8, 12, 16, 33, 64, 128, 256)):
    """Phase 18b: each bf16 kernel against its plain version on random bf16
    operands, with and without a*alpha*x: K1 every mode and K1s (apply,
    residual, gsrb) within BF16_CELL_ULPS of each cell, K1 == K1s bit for
    bit; K3 within BF16_CELL_ULPS; K2c at n = 4 .. 64 against its plain
    version and two K1 launches, K4a and K4b on the 32-16 and 16 ladders
    within BF16_CHAIN_ULPS of max|out|; a gsrb's other colour equal to x;
    then K1's BF16C gsrb (float32 x, bf16 coefficients) against its plain
    version at F32_TOL and against the float32 half-sweep within
    BF16C_VS_F32."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.kernels import restrict as R
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import tail as T

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 18)

    def field(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=BF16, device=dev)

    unequal = 0
    for n in sizes:
        lv, x, rhs = random_level(n, BF16, dev, rng), field(n, n, n), field(n, n, n)
        k1 = k1s = 0.0
        for _, cfg in bf16_cfgs():
            for label, mode, kw, parity in stream_cases(lv, rhs):
                out = S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity, **kw)
                k1 = max(k1, bf16_ulps(out, S.fv4_stencil_plain(lv, x, cfg, mode, **kw)))
                if mode == "gsrb":
                    other = lv.kdinv[parity] == 0
                    if not torch.equal(out[other], x[other]):
                        raise AssertionError(f"K1 bf16 {label} n={n}: the other colour's "
                                             "cells differ from x")
                if mode in S.SUBTILE_MODES:
                    sub = S.fv4_subtile_cuda(lv, x, cfg, mode, parity=parity, **kw)
                    k1s = max(k1s, bf16_ulps(sub, S.fv4_subtile_plain(
                        lv, x, cfg, mode, parity=parity, **kw)))
                    unequal += not torch.equal(sub, out)
        hold_ulps(f"K1 bf16 (5 modes x 2 terms) n={n:3d} vs plain", k1, BF16_CELL_ULPS,
                  worst, "fv4_stencil_bf16")
        hold_ulps(f"K1s bf16 (3 modes x 2 terms) n={n:3d} vs plain", k1s, BF16_CELL_ULPS,
                  worst, "fv4_subtile_bf16")
        if n % 2 == 0:
            hold_ulps(f"K3 bf16 n={n:3d} vs plain", bf16_ulps(
                R.restrict_cell_cuda(x), R.restrict_cell_plain(x)), BF16_CELL_ULPS, worst,
                "restrict_cell_bf16")
        if n <= S.GSRB2_CLUSTER_MAX_N:
            for label, cfg in bf16_cfgs():
                out = S.fv4_gsrb2_cluster_cuda(lv, x, rhs, cfg)
                y = S.fv4_stencil_cuda(lv, x, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[0],
                                       parity=0)
                two = S.fv4_stencil_cuda(lv, y, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[1],
                                         parity=1)
                hold_ulps(f"K2c bf16 n={n:3d}{label} vs plain", bf16_max_ulps(
                    out, S.fv4_gsrb2_plain(lv, x, rhs, cfg)), BF16_CHAIN_ULPS["K2c"], worst,
                    "fv4_gsrb2_cluster_bf16")
                hold_ulps(f"K2c bf16 n={n:3d}{label} vs two K1", bf16_max_ulps(out, two),
                          BF16_CHAIN_ULPS["K2c"], worst, "fv4_gsrb2_cluster_bf16_vs_two_k1")
        del lv, x, rhs
    print("  K1 against K1s in bf16: " + ("bit for bit" if not unequal
                                          else f"{unequal} calls differ"))
    if unequal:
        raise AssertionError("K1 and K1s differ in bf16")
    for dims in ((32, 16), (16,)):
        for label, cfg in bf16_cfgs():
            tail = [random_level(d, BF16, dev, rng) for d in dims]
            e, rhs = field(*tail[0].shape), field(*tail[0].shape)
            tag = f"{'-'.join(map(str, dims))}{label}"
            es_k, rs_k = T.tail_down_cuda(tail, e, rhs, cfg, 6)
            es_p, rs_p = T.tail_down_plain(tail, e, rhs, cfg, 6)
            got = max(bf16_max_ulps(a, b) for a, b in zip(es_k + rs_k, es_p + rs_p))
            hold_ulps(f"K4a bf16 {tag} vs plain", got, BF16_CHAIN_ULPS["K4a"], worst,
                      "tail_down_bf16")
            d = dims[-1] // 2
            u_bot = field(d, d, d)
            rhss = [rhs] + rs_p[:-1]
            hold_ulps(f"K4b bf16 {tag} vs plain", bf16_max_ulps(
                T.tail_up_cuda(tail, es_p, rhss, u_bot, cfg, 6),
                T.tail_up_plain(tail, es_p, rhss, u_bot, cfg, 6)), BF16_CHAIN_ULPS["K4b"],
                worst, "tail_up_bf16")
    for n in (8, 33, 64, 128):
        lv = random_level(n, torch.float32, dev, rng)
        kb16 = S.kernel_views_bf16(lv, lv.kdinv)
        view = S.bf16c_view(dataclasses.replace(lv, kb16=kb16))
        x, rhs = (torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in rng.standard_normal((2, n, n, n)))
        for label, cfg in (("", SolverConfig(a=0.0, b=1.0)),
                           ("+alpha", SolverConfig(a=1.5, b=1.0, helmholtz=True))):
            for p in (0, 1):
                out = S.fv4_stencil_cuda(view, x, cfg, "gsrb", rhs=rhs, kdinv=kb16[3 + p],
                                         parity=p)
                check(f"K1 BF16C gsrb{p} n={n:3d}{label} vs plain", out,
                      S.fv4_stencil_plain(view, x, cfg, "gsrb", rhs=rhs, kdinv=kb16[3 + p]),
                      F32_TOL, worst, "fv4_stencil_bf16c")
                check(f"K1 BF16C gsrb{p} n={n:3d}{label} vs the f32 half-sweep", out,
                      S.fv4_stencil_cuda(lv, x, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[p],
                                         parity=p), BF16C_VS_F32, worst,
                      "fv4_stencil_bf16c_vs_f32")


def time_bf16(label: str, kernel, plain, reps: int, row: dict, key: str, work,
              limit: float, per_cell: bool, library=None):
    """Time a bf16 kernel and its plain version (and ``library``, one
    PyTorch call computing the same function, where there is one) with CUDA
    events, hold the kernel to the plain version (per_cell: bf16_ulps
    within ``limit``; else bf16_max_ulps), and record the times, the max abs
    error and the bound of ``work`` = (bytes, flops) at bf16's 2 bytes a
    value."""
    k_ms, p_ms = time_ms(kernel, reps), time_ms(plain, max(1, reps // 4))
    lib_ms = time_ms(library, reps) if library is not None else None
    out, ref = kernel(), plain()
    if isinstance(out, (tuple, list)):
        out = torch.cat([t.flatten() for t in out[0] + out[1]])
        ref = torch.cat([t.flatten() for t in ref[0] + ref[1]])
    got = bf16_ulps(out, ref) if per_cell else bf16_max_ulps(out, ref)
    err = float((out.float() - ref.float()).abs().max())
    b_ms, b_by = bound(*work)
    print(f"  {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          + (f"library {lib_ms:.4f} ms, " if lib_ms is not None else "")
          + f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3e}, {got:.3f} ulps")
    if not got <= limit:
        raise AssertionError(f"{label}: {got} ulps > {limit}")
    row[key] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err, "ulps": got,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def bench_level(n: int, dtype, dev):
    """The benchmark problem's fv4 level at n^3 in ``dtype`` (as
    rebuild_operator leaves it), a seeded x and the rhs."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.core.level import Level
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.problems.fv import init_problem_fv

    prob = init_problem_fv(n, dtype, dev)
    lv = get_suite("fv4").rebuild_operator(
        Level(dim=n, h=1.0 / n, depth=0, beta_i=prob.beta_i, beta_j=prob.beta_j,
              beta_k=prob.beta_k), SolverConfig(a=0.0, b=1.0, dtype=dtype))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return lv, torch.randn((n, n, n), generator=gen, device=dev).to(dtype), prob.f


def time_bf16_kernels(sizes=(8, 16, 32, 64, 128, 256, 512)):
    """Phase 18b's times: each bf16 kernel against its plain version on the
    benchmark's own bf16 levels, 8^3-512^3: K1 in its four modes and K1s
    in its three up to its gate, K2c up to its gate, K3, and K4a/K4b on the
    32-16 tail; bounds by bytes at 2 a value (half the f32 ones)."""
    from hpgmg_tpu_torch.bench.driver import build as build_bench
    from hpgmg_tpu_torch.core.config import BottomSolver, SolverConfig
    from hpgmg_tpu_torch.kernels import restrict as R
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import tail as T

    dev = torch.device("cuda")
    cfg = SolverConfig(a=0.0, b=1.0, dtype=BF16)
    res = {}
    for n in sizes:
        lv, x, rhs = bench_level(n, BF16, dev)
        reps = 20 if n <= 128 else 5
        row, cells = {}, n ** 3
        for mode, kw, parity in (("apply", {}, None), ("residual", {"rhs": rhs}, None),
                                 ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}, 0),
                                 ("fres", {"rhs": rhs}, None)):
            if n >= 128 or mode == "gsrb":
                time_bf16(f"K1 bf16 {mode:8s} {n}^3",
                          lambda: S.fv4_stencil_cuda(lv, x, cfg, mode, parity=parity, **kw),
                          lambda: S.fv4_stencil_plain(lv, x, cfg, mode, **kw), reps, row,
                          mode, stream_work(lv, x, mode, kw), BF16_CELL_ULPS, True)
            if mode in S.SUBTILE_MODES and n <= S.SUBTILE_MAX_DIM:
                time_bf16(f"K1s bf16 {mode:8s} {n}^3",
                          lambda: S.fv4_subtile_cuda(lv, x, cfg, mode, parity=parity, **kw),
                          lambda: S.fv4_subtile_plain(lv, x, cfg, mode, parity=parity,
                                                      **kw),
                          reps, row, f"k1s {mode}", stream_work(lv, x, mode, kw),
                          BF16_CELL_ULPS, True)
        if n <= S.GSRB2_MAX_DIM:
            sweep = (nbytes(x, rhs, *lv.kdinv, x, lv.beta_i, lv.beta_j, lv.beta_k),
                     2 * mode_flops(FV4_AX, "gsrb", cells, 0))
            time_bf16(f"K2c bf16 gsrb2 {n}^3", lambda: S.fv4_gsrb2_cluster_cuda(lv, x, rhs, cfg),
                      lambda: S.fv4_gsrb2_plain(lv, x, rhs, cfg), reps * 5, row,
                      "gsrb2_cluster", sweep, BF16_CHAIN_ULPS["K2c"], False)
            row["gsrb2_cluster"]["smem_bytes"] = S.gsrb2_cluster_smem(n, 4)
        if n >= 16:
            time_bf16(f"K3 bf16 restrict {n}^3", lambda: R.restrict_cell_cuda(x),
                      lambda: R.restrict_cell_plain(x), reps * 4, row, "restrict",
                      (2 * (cells + cells // 8), cells), BF16_CELL_ULPS, True,
                      library=lambda: torch.nn.functional.avg_pool3d(x[None, None], 2)[0, 0])
        res[n] = row
        del lv, x, rhs
        torch.cuda.empty_cache()
    # K4a, K4b on the bf16 solve's 32-16 tail (above its 8-4-2 levels)
    hier, _ = build_bench(64, SolverConfig(a=0.0, b=1.0, dtype=BF16, min_coarse_dim=2,
                                           bottom=BottomSolver.BICGSTAB), dev)
    tail = hier.levels[1:3]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    e, rhs = (torch.randn(tail[0].shape, generator=gen, device=dev).to(BF16) for _ in range(2))
    row = {}
    coefs = sum(nbytes(lv.beta_i, lv.beta_j, lv.beta_k, *lv.kdinv) for lv in tail)
    sweeps = sum(6 * mode_flops(FV4_AX, "gsrb", lv.ncells, 0) for lv in tail)
    es, rs = T.tail_down_plain(tail, e, rhs, cfg, 6)
    time_bf16("K4a bf16 down 32-16", lambda: T.tail_down_cuda(tail, e, rhs, cfg, 6),
              lambda: T.tail_down_plain(tail, e, rhs, cfg, 6), 50, row, "tail_down",
              (coefs + nbytes(e, rhs, *es, *rs),
               sweeps + sum((FV4_AX + 2) * lv.ncells for lv in tail)),
              BF16_CHAIN_ULPS["K4a"], False)
    u_bot = torch.randn((8, 8, 8), generator=gen, device=dev).to(BF16)
    time_bf16("K4b bf16 up 32-16",
              lambda: T.tail_up_cuda(tail, es, [rhs, rs[0]], u_bot, cfg, 6),
              lambda: T.tail_up_plain(tail, es, [rhs, rs[0]], u_bot, cfg, 6), 50, row,
              "tail_up", (coefs + nbytes(*es, rhs, rs[0], u_bot, e),
                          sweeps + sum(16 * lv.ncells for lv in tail)),
              BF16_CHAIN_ULPS["K4b"], False)
    for key in ("tail_down", "tail_up"):
        row[key]["smem_bytes"] = T.tail_smem(32, 4)
    res["tail"] = row
    return res


def tally_by_level(tally: dict):
    """Context manager: every call of the fv4 suite's stencil entries (K1,
    K1s, the plain version below 4^3), its full-sweep entry (K2c) and the
    cycle's tail entries (K4a, K4b, K4c) during it, counted by entry and
    level (a tail call by its first level) into ``tally``."""
    from hpgmg_tpu_torch.ops import fv4 as F
    from hpgmg_tpu_torch.solve import mg as MG

    entries = [(F, "fv4_stencil"), (F, "fv4_subtile"), (F, "fv4_small"), (F, "fv4_gsrb2"),
               (MG, "tail_down"), (MG, "tail_up"), (MG, "tail_v")]

    def wrap(name, fn):
        def counted(level, *args, **kw):
            dim = level[0].dim if isinstance(level, (list, tuple)) else level.dim
            key = f"{name} {dim}"
            tally[key] = tally.get(key, 0) + 1
            return fn(level, *args, **kw)
        return counted

    @contextlib.contextmanager
    def scope():
        saved = [(mod, name, getattr(mod, name)) for mod, name in entries]
        for mod, name, fn in saved:
            setattr(mod, name, wrap(name, fn))
        try:
            yield tally
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    return scope()


def cli_ladder_fcycle(n=512):
    """Phase 18a: the fv4 F-cycle at n^3 float32 on the JAX CLI's ladder
    (min_coarse_dim 2, n ... 4, 2), BiCGStab bottom, through the port's
    entry point (rel_residual <= 1e-3, order >= 3; K1/K1s, K2c, K3, K4a/K4b
    and fv4_small launched, no plain version), then one counted F-cycle:
    its calls by entry and level, the 2^3 level's through fv4_small only,
    the 4^3 level's through K1s and K2c."""
    from hpgmg_tpu_torch.bench.driver import build
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    res, counts = headline("fv4", n, min_solve_seconds=0.25, bottom="bicgstab",
                           min_coarse_dim=2, also=("fv4_small",))
    cfg = solve_cfg("bicgstab", torch.float32, min_coarse_dim=2)
    hier, f = build(n, cfg, torch.device("cuda"))
    dims = [lv.dim for lv in hier.levels]
    tally = {}
    reset_counts()
    with tally_by_level(tally):
        fmg_solve(get_suite("fv4"), hier, f, cfg)
        torch.cuda.synchronize()
    launched, plain = read_counts()
    print(f"  ladder {dims}; one F-cycle's calls by entry and level: {tally}")
    small = {k for k in tally if k.startswith("fv4_small")}
    if dims[-2:] != [4, 2] or small != {"fv4_small 2"}:
        raise AssertionError(f"fv4_small took {small} on the ladder {dims}")
    if any(k.endswith(" 2") for k in tally if not k.startswith("fv4_small")):
        raise AssertionError(f"a kernel's entry took the 2^3 level: {tally}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran: {plain}")
    del hier, f
    torch.cuda.empty_cache()
    return {"dof_per_s": res.dof_per_second, "rel_residual": res.rel_residual,
            "richardson_order": res.richardson_order, "ladder": dims,
            "calls_by_level": tally, "launches": {k: v for k, v in launched.items() if v}}


def plain_path():
    """Context manager: the kernel entries of the fv4 suite (K1, K1s, K2c,
    K3, K4a/K4b; K7a on a periodic level) and of the radius-1 suites (K5,
    K6; K7b) swapped for their plain versions, so that a CUDA solve runs
    the plain versions on the card."""
    from hpgmg_tpu_torch.kernels import restrict as R
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K
    from hpgmg_tpu_torch.kernels import tail as T
    from hpgmg_tpu_torch.ops import fv4 as F
    from hpgmg_tpu_torch.solve import mg as MG

    def fv4_stencil_plain(level, x, cfg, mode, rhs=None, kdinv=None, parity=None):
        return S.fv4_stencil_plain(level, x, cfg, mode, rhs, kdinv)

    swaps = [(F, "fv4_stencil", fv4_stencil_plain),
             (F, "fv4_subtile", S.fv4_subtile_plain),
             (F, "fv4_gsrb2", S.fv4_gsrb2_plain),
             (F, "restrict_cell", R.restrict_cell_plain),
             (MG, "restrict_cell", R.restrict_cell_plain),
             (MG, "tail_down", T.tail_down_plain), (MG, "tail_up", T.tail_up_plain),
             (K, "r1_stencil", K.r1_stencil_plain), (K, "r1_gsrb2", K.r1_gsrb2_plain)]

    @contextlib.contextmanager
    def scope():
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    return scope()


# the bf16 F-cycle through the kernels against the plain versions, in
# units of 2^-8 max|u| (measured on an H100 80GB HBM3 at 700 W: 3.765)
BF16_FCYCLE_GAP = 8.0


def bf16_fcycle(n=512):
    """Phase 18c: the bf16 fv4 F-cycle at n^3 (GSRB, BiCGStab, min_coarse_dim
    2) through the port's entry point: DOF/s, rel_residual and order
    (printed; the fv4 limit of 1e-3 does not apply in bf16), the bf16
    kernels launched (K1, K1s, K2c, K3, K4a, K4b) and no float32 one, no
    plain version; then one F-cycle through the kernels against the same
    F-cycle through the plain versions on the card: max|u - u_plain| in
    units of 2^-8 max|u_plain|, held to BF16_FCYCLE_GAP (each step rounds
    at the same places; the float32 sums differ in order, and a one-unit
    difference moves the cycle's later steps)."""
    from hpgmg_tpu_torch.bench.driver import build, run_benchmark
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    cfg = solve_cfg("bicgstab", BF16, min_coarse_dim=2)
    reset_counts()
    res = run_benchmark(n, cfg, "cuda", min_solve_seconds=0.25, dynamic_range=3)
    launched, plain = read_counts()
    print(f"  fv4 bf16 {n}^3: DOF/s {res.dof_per_second:.6e}, s/solve "
          f"{res.seconds_per_solve:.6f}, rel_residual {res.rel_residual:.6e}, order "
          f"{res.richardson_order:.6f}")
    print(f"  launches: { {k: v for k, v in launched.items() if v} }; plain calls: {plain}")
    want = ("fv4_stencil_bf16", "fv4_subtile_bf16", "fv4_gsrb2_cluster_bf16",
            "restrict_cell_bf16", "tail_down_bf16", "tail_up_bf16", "fv4_small")
    missing = [k for k in want if not launched[k]]
    f32 = [k for k in ("fv4_stencil", "fv4_subtile", "fv4_gsrb2_cluster", "restrict_cell",
                       "tail_down", "tail_up", "tail_v") if launched[k]]
    if missing or f32 or any(plain.values()):
        raise AssertionError(f"bf16 F-cycle: kernels not launched {missing}, float32 "
                             f"kernels launched {f32}, plain calls {plain}")
    # no limit on rel_residual in bf16: a bf16 u's rounding alone leaves a
    # residual of ~2^-9 max|u| times the operator's 1/h^2 scale
    if not math.isfinite(res.rel_residual):
        raise AssertionError(f"bf16 F-cycle rel_residual {res.rel_residual}")
    hier, f = build(n, cfg, torch.device("cuda"))
    u = fmg_solve(get_suite("fv4"), hier, f, cfg)[0]
    with plain_path():
        t0 = time.perf_counter()
        u_plain, nr, nf = fmg_solve(get_suite("fv4"), hier, f, cfg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    gap = float((u.float() - u_plain.float()).abs().max()
                / (u_plain.float().abs().max() * 2.0 ** -8))
    print(f"  one F-cycle through the kernels against the plain versions on the card: "
          f"{gap:.3f} units of 2^-8 max|u| (limit {BF16_FCYCLE_GAP}); the plain "
          f"F-cycle's rel_residual {float(nr) / float(nf):.6e}, {plain_s:.3f} s")
    if not gap <= BF16_FCYCLE_GAP:
        raise AssertionError(f"bf16 F-cycle: kernels vs plain {gap} > {BF16_FCYCLE_GAP}")
    del hier, f, u, u_plain
    torch.cuda.empty_cache()
    return {"dof_per_s": res.dof_per_second, "seconds_per_solve": res.seconds_per_solve,
            "rel_residual": res.rel_residual, "richardson_order": res.richardson_order,
            "u_vs_plain_units": gap, "plain_rel_residual": float(nr) / float(nf),
            "plain_fcycle_s": plain_s, "launches": {k: v for k, v in launched.items() if v}}


def bf16c_phase(sizes=(256, 512)):
    """Phase 18d: K1's gsrb with the BF16C coefficient streams against the
    float32 K1 gsrb, in turns (f32, BF16C, BF16C, f32), at 256^3 and 512^3,
    each against its plain version, with bounds (BF16C: x, rhs and out in
    float32, the face arrays and kdinv in bf16); then the fv4 512^3 float32
    headline F-cycle (DIRECT bottom) with stencils.BF16C on: its
    rel_residual and order, and whether it meets the fv4 limit of 1e-3
    (reported, not required: BF16C stays off unless it does)."""
    from hpgmg_tpu_torch.core.config import SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S

    dev = torch.device("cuda")
    cfg = SolverConfig(a=0.0, b=1.0)
    out = {}
    for n in sizes:
        lv, x, rhs = bench_level(n, torch.float32, dev)
        kb16 = S.kernel_views_bf16(lv, lv.kdinv)
        view = S.bf16c_view(dataclasses.replace(lv, kb16=kb16))
        reps = 10
        f32 = lambda: S.fv4_stencil_cuda(lv, x, cfg, "gsrb", rhs=rhs,  # noqa: E731
                                         kdinv=lv.kdinv[0], parity=0)
        b16 = lambda: S.fv4_stencil_cuda(view, x, cfg, "gsrb", rhs=rhs,  # noqa: E731
                                         kdinv=kb16[3], parity=0)
        row = {}
        time_pair(f"K1 BF16C gsrb {n}^3", b16,
                  lambda: S.fv4_stencil_plain(view, x, cfg, "gsrb", rhs=rhs, kdinv=kb16[3]),
                  reps, row, "bf16c",
                  work=stream_work(view, x, "gsrb", {"rhs": rhs, "kdinv": kb16[3]}))
        t = [time_ms(fn, reps) for fn in (f32, b16, b16, f32)]
        rel, _ = relerr(b16(), f32())
        print(f"  K1 gsrb {n}^3 in turns: f32 {t[0]:.4f} / {t[3]:.4f} ms, BF16C "
              f"{t[1]:.4f} / {t[2]:.4f} ms; BF16C vs f32 rel diff {rel:.3e}")
        if not rel <= BF16C_VS_F32:
            raise AssertionError(f"BF16C gsrb {n}^3 vs f32: {rel} > {BF16C_VS_F32}")
        row["bf16c"]["in_turns_f32_bf16c_bf16c_f32"] = t
        row["bf16c"]["vs_f32"] = rel
        out[n] = row
        del lv, x, rhs, kb16, view
        torch.cuda.empty_cache()
    saved = S.BF16C, S.BF16C_MIN_DIM
    S.BF16C, S.BF16C_MIN_DIM = True, 512
    try:
        res, counts = headline("fv4", 512, min_solve_seconds=0.25, rel_limit=float("inf"),
                               order_range=(-float("inf"), float("inf")),
                               also=("fv4_stencil_bf16c",))
    finally:
        S.BF16C, S.BF16C_MIN_DIM = saved
    meets = res.rel_residual <= 1e-3
    print(f"  fv4 512^3 f32 with BF16C on: rel_residual {res.rel_residual:.6e} "
          f"({'meets' if meets else 'misses'} the fv4 limit 1e-3), order "
          f"{res.richardson_order:.6f}, DOF/s {res.dof_per_second:.6e}")
    torch.cuda.empty_cache()
    out["fcycle"] = {"rel_residual": res.rel_residual, "meets_1e-3": meets,
                     "richardson_order": res.richardson_order,
                     "dof_per_s": res.dof_per_second,
                     "bf16c_launches": counts["fv4_stencil_bf16c"]}
    return out


# ---------------------------------------------------------------------------
# phase 19: bfloat16 on the radius-1 suites and on periodic levels
# ---------------------------------------------------------------------------

def check_bf16_r1_kernels(worst: dict, sizes=(2, 3, 4, 8, 9, 16, 33, 64, 128, 256)):
    """Phase 19a: the bf16 instantiations of K5 and K7b (both bodies, every
    tap set of R1_BODIES, every mode) and of K7a (every mode, with and
    without a*alpha*x, n >= 4) against their plain versions on random bf16
    operands, each cell within BF16_CELL_ULPS, each gsrb's other colour
    equal to x and a chunk of 3 i-planes equal to the launcher's rule bit
    for bit; K6 in bf16 (each body) within BF16_CHAIN_ULPS["K6"] of max|out|
    of its plain version and of two K5 bf16 half-sweeps, with chunks of 2
    and 3 i-planes equal to its rule bit for bit."""
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 19)

    def field(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=BF16, device=dev)

    limits = {"r1_gsrb2_bf16": BF16_CHAIN_ULPS["K6"],
              "r1_gsrb2_bf16_vs_two_k5": BF16_CHAIN_ULPS["K6"]}
    for n in sizes:
        lv, x, rhs = random_level_r1(n, BF16, dev, rng), field(n, n, n), field(n, n, n)
        errs = {}
        for label, taps, var7, helm in R1_BODIES:
            cfg = SolverConfig(a=1.5 if helm else 0.0, b=1.0, helmholtz=helm and var7,
                               dtype=BF16)
            for bc in (BC.DIRICHLET, BC.PERIODIC):
                c = dataclasses.replace(cfg, bc=bc)
                name = (("r1_stencil" if var7 else "r1_stream")
                        + ("_periodic" if bc == BC.PERIODIC else "") + "_bf16")
                for mode, kw, parity in r1_cases(lv, rhs):
                    out = K.r1_stencil_cuda(lv, x, c, mode, taps, var7, parity=parity, **kw)
                    ref = K.r1_stencil_plain(lv, x, c, mode, taps, var7, parity=parity, **kw)
                    errs[name] = max(errs.get(name, 0.0), bf16_ulps(out, ref))
                    tag = f"{name} {label} {mode} {parity} n={n}"
                    if not torch.equal(K.r1_stencil_cuda(lv, x, c, mode, taps, var7,
                                                         parity=parity, chunk=3, **kw), out):
                        raise AssertionError(f"{tag}: chunk 3 differs from the rule")
                    other = kw["kdinv"] == 0 if mode == "gsrb" else None
                    if other is not None and not torch.equal(out[other], x[other]):
                        raise AssertionError(f"{tag}: the other colour differs from x")
            out = K.r1_gsrb2_cuda(lv, x, rhs, cfg, taps, var7)
            y = K.r1_stencil_cuda(lv, x, cfg, "gsrb", taps, var7, rhs=rhs, kdinv=lv.kdinv[0],
                                  parity=0)
            two = K.r1_stencil_cuda(lv, y, cfg, "gsrb", taps, var7, rhs=rhs,
                                    kdinv=lv.kdinv[1], parity=1)
            for key, ref in (("r1_gsrb2_bf16", K.r1_gsrb2_plain(lv, x, rhs, cfg, taps, var7)),
                             ("r1_gsrb2_bf16_vs_two_k5", two)):
                errs[key] = max(errs.get(key, 0.0), bf16_max_ulps(out, ref))
            for chunk in (2, 3):
                if not torch.equal(K.r1_gsrb2_cuda(lv, x, rhs, cfg, taps, var7, chunk=chunk),
                                   out):
                    raise AssertionError(f"K6 bf16 {label} n={n}: chunk {chunk} differs "
                                         f"from the launcher's rule")
        if n >= 4:
            lv4 = random_level(n, BF16, dev, rng)
            for label, cfg in bf16_cfgs():
                c = dataclasses.replace(cfg, bc=BC.PERIODIC)
                for case, mode, kw, parity in stream_cases(lv4, rhs):
                    kw = {k: (lv4.kdinv[parity] if k == "kdinv" else v) for k, v in kw.items()}
                    out = S.fv4_stencil_cuda(lv4, x, c, mode, parity=parity, **kw)
                    errs["fv4_stencil_periodic_bf16"] = max(
                        errs.get("fv4_stencil_periodic_bf16", 0.0),
                        bf16_ulps(out, S.fv4_stencil_plain(lv4, x, c, mode, **kw)))
                    if mode == "gsrb":
                        other = lv4.kdinv[parity] == 0
                        if not torch.equal(out[other], x[other]):
                            raise AssertionError(f"K7a bf16 {case}{label} n={n}: the other "
                                                 f"colour differs from x")
            del lv4
        print(f"  bf16 K5/K7b every mode, body and BC, K6, K7a n={n:3d}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in errs.items())
              + " ulps; each gsrb's other colour equals x, chunks give the rule's bits")
        for k, v in errs.items():
            if not v <= limits.get(k, BF16_CELL_ULPS):
                raise AssertionError(f"{k} n={n}: {v} ulps > {limits.get(k, BF16_CELL_ULPS)}")
            worst[k] = max(worst.get(k, 0.0), v)
        del lv, x, rhs


def bf16_r1_level(op: str, bc: str, n: int, dtype):
    """The suite's benchmark level at n^3 in ``dtype`` (as its rebuild
    leaves it), the rhs, and a seeded x."""
    from hpgmg_tpu_torch.bench.driver import build_problem
    from hpgmg_tpu_torch.core.config import BC, SolverConfig
    from hpgmg_tpu_torch.core.level import Level
    from hpgmg_tpu_torch.ops.base import get_suite

    dev = torch.device("cuda")
    cfg = SolverConfig(op=op, bc=BC(bc), a=0.0, b=1.0, dtype=dtype)
    prob = build_problem(n, cfg, dev)
    lv = get_suite(op).rebuild_operator(
        Level(dim=n, h=1.0 / n, depth=0, beta_i=prob.beta_i, beta_j=prob.beta_j,
              beta_k=prob.beta_k), cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return lv, prob.f, torch.randn((n, n, n), generator=gen, device=dev).to(dtype), cfg


# (key, op, taps, BC, n): the levels of phase 19a's times, at the size
# each bf16 F-cycle of phase 19b runs the kernel at
BF16_R1_TIMES = (("var7", "fv7pt", "p1", "dirichlet", 512),
                 ("27pt", "27pt", "27pt", "dirichlet", 512),
                 ("fv4 periodic", "fv4", None, "periodic", 512),
                 ("var7 periodic", "fv7pt", "p1", "periodic", 512),
                 ("27pt periodic", "27pt", "27pt", "periodic", 256))


def time_bf16_r1_kernels(runs=BF16_R1_TIMES):
    """Phase 19a's times: each new bf16 instantiation against its plain
    version on the suites' own bf16 levels, every mode (K5/K7b: the var7
    body at fv7pt's level, the 27pt body at 27pt's, the 27pt apply also
    against conv3d in bf16; K7a at fv4's periodic level), K6's full sweep
    on the Dirichlet var7 level; bounds by bytes at 2 a value; then the
    gsrb (the 27pt apply, K6's sweep) in turns with the same call on the
    float32 level (f32, bf16, bf16, f32)."""
    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import stencils_r1 as K

    res = {}
    for key, op, taps, bc, n in runs:
        lv, f, x, cfg = bf16_r1_level(op, bc, n, BF16)
        lv32, f32_, x32, cfg32 = bf16_r1_level(op, bc, n, torch.float32)
        var7, cells, row, reps = op != "27pt", n ** 3, {}, 5
        if op == "fv4":
            def call(level, xx, c, mode, kw, parity):
                return S.fv4_stencil_cuda(level, xx, c, mode, parity=parity, **kw)

            def plain(mode, kw, parity):
                return S.fv4_stencil_plain(lv, x, cfg, mode, **kw)

            def work(mode, kw):
                return stream_work(lv, x, mode, kw)
        else:
            def call(level, xx, c, mode, kw, parity):
                return K.r1_stencil_cuda(level, xx, c, mode, taps, var7, parity=parity, **kw)

            def plain(mode, kw, parity):
                return K.r1_stencil_plain(lv, x, cfg, mode, taps, var7, parity=parity, **kw)

            def work(mode, kw):
                betas = nbytes(lv.beta_i, lv.beta_j, lv.beta_k) if var7 else 0
                out_cells = cells // 8 if mode == "fres" else cells
                return (nbytes(x, *kw.values()) + betas + x.element_size() * out_cells,
                        mode_flops(VAR7_AX if var7 else P27_AX, mode, cells, 1))
        modes = (("apply", {}, None), ("residual", {"rhs": f}, None),
                 ("gsrb", {"rhs": f, "kdinv": lv.kdinv[0]}, 0), ("fres", {"rhs": f}, None))
        for mode, kw, parity in modes:
            time_bf16(f"{key} bf16 {mode:8s} {n}^3",
                      lambda: call(lv, x, cfg, mode, kw, parity),
                      lambda: plain(mode, kw, parity), reps, row, mode, work(mode, kw),
                      BF16_CELL_ULPS, True,
                      library=r1_library(lv, x, cfg) if op == "27pt" and mode == "apply"
                      else None)
        turns = {"27pt": "apply"}.get(op, "gsrb")
        kw = {"rhs": f, "kdinv": lv.kdinv[0]} if turns == "gsrb" else {}
        kw32 = {"rhs": f32_, "kdinv": lv32.kdinv[0]} if turns == "gsrb" else {}
        pair = {"f32": lambda: call(lv32, x32, cfg32, turns, kw32, 0 if kw else None),
                "bf16": lambda: call(lv, x, cfg, turns, kw, 0 if kw else None)}
        if key == "var7":
            time_bf16(f"K6 bf16 var7 gsrb2 {n}^3",
                      lambda: K.r1_gsrb2_cuda(lv, x, f, cfg, taps, True),
                      lambda: K.r1_gsrb2_plain(lv, x, f, cfg, taps, True), reps * 2, row,
                      "gsrb2", (nbytes(x, f, *lv.kdinv, x, lv.beta_i, lv.beta_j, lv.beta_k),
                                2 * mode_flops(VAR7_AX, "gsrb", cells, 0)),
                      BF16_CHAIN_ULPS["K6"], False)
            sweeps = {"f32": lambda: K.r1_gsrb2_cuda(lv32, x32, f32_, cfg32, taps, True),
                      "bf16": lambda: K.r1_gsrb2_cuda(lv, x, f, cfg, taps, True)}
            t = [time_ms(sweeps[d], reps * 2) for d in ("f32", "bf16", "bf16", "f32")]
            print(f"  K6 var7 {n}^3 in turns: f32 {t[0]:.4f} / {t[3]:.4f} ms, bf16 "
                  f"{t[1]:.4f} / {t[2]:.4f} ms")
            row["gsrb2"]["in_turns_f32_bf16_bf16_f32"] = t
        t = [time_ms(pair[d], reps * 2) for d in ("f32", "bf16", "bf16", "f32")]
        print(f"  {key} {turns} {n}^3 in turns: f32 {t[0]:.4f} / {t[3]:.4f} ms, bf16 "
              f"{t[1]:.4f} / {t[2]:.4f} ms")
        row[turns]["in_turns_f32_bf16_bf16_f32"] = t
        res[key] = row
        del lv, f, x, lv32, f32_, x32
        torch.cuda.empty_cache()
    return res


# (tag, op, bc, n) of the bf16 F-cycles of phase 19b, and the bf16 kernels
# each must launch
BF16_SUITES = (("fv7pt", "fv7pt", "dirichlet", 512), ("27pt", "27pt", "dirichlet", 512),
               ("fv2", "fv2", "dirichlet", 256), ("fv4 periodic", "fv4", "periodic", 512),
               ("fv7pt periodic", "fv7pt", "periodic", 512),
               ("fv2 periodic", "fv2", "periodic", 256),
               ("27pt periodic", "27pt", "periodic", 256))
BF16_PATH_KERNELS = {
    ("fv7pt", "dirichlet"): ("r1_stencil_bf16", "r1_gsrb2_bf16", "restrict_cell_bf16"),
    ("fv2", "dirichlet"): ("r1_stencil_bf16", "r1_gsrb2_bf16", "restrict_cell_bf16"),
    ("27pt", "dirichlet"): ("r1_stream_bf16", "restrict_cell_bf16"),
    ("fv4", "periodic"): ("fv4_stencil_periodic_bf16", "restrict_cell_bf16"),
    ("fv7pt", "periodic"): ("r1_stencil_periodic_bf16", "restrict_cell_bf16"),
    ("fv2", "periodic"): ("r1_stencil_periodic_bf16", "restrict_cell_bf16"),
    ("27pt", "periodic"): ("r1_stream_periodic_bf16", "restrict_cell_bf16"),
}
# the plain versions the comparison F-cycle of each path of phase 19b must
# call in place of those kernels
BF16_PATH_PLAINS = {
    ("fv7pt", "dirichlet"): ("r1_stencil_plain", "r1_gsrb2_plain", "restrict_cell_plain"),
    ("fv2", "dirichlet"): ("r1_stencil_plain", "r1_gsrb2_plain", "restrict_cell_plain"),
    ("27pt", "dirichlet"): ("r1_stencil_plain", "restrict_cell_plain"),
    ("fv4", "periodic"): ("fv4_stencil_plain", "restrict_cell_plain"),
    ("fv7pt", "periodic"): ("r1_stencil_plain", "restrict_cell_plain"),
    ("fv2", "periodic"): ("r1_stencil_plain", "restrict_cell_plain"),
    ("27pt", "periodic"): ("r1_stencil_plain", "restrict_cell_plain"),
}
# one F-cycle through the kernels against one through the plain versions
# at 128^3, in units of 2^-8 max|u| (as BF16_FCYCLE_GAP; measured on an
# H100 80GB HBM3 at 700 W: 0.000-1.641 over the seven paths)
BF16_R1_FCYCLE_GAP = 4.0


def plain_fcycle(op, hier, f, cfg, want):
    """One F-cycle through the plain versions on the card (plain_path) with
    the counts reset just before it and read just after it: no kernel
    launched (fv4_small, the plain arithmetic of the levels below 4^3,
    aside) and each plain version of ``want`` called. Returns fmg_solve's
    (u, norm_r, norm_f) and the plain calls."""
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    reset_counts()
    with plain_path():
        out = fmg_solve(get_suite(op), hier, f, cfg)
    torch.cuda.synchronize()
    launched, plain = read_counts()
    stray = {k: v for k, v in launched.items() if v and k != "fv4_small"}
    missing = [k for k in want if not plain[k]]
    if stray or missing:
        raise AssertionError(f"{op} plain F-cycle: kernels launched {stray}, plain "
                             f"versions not called {missing}")
    return out, {k: v for k, v in plain.items() if v}


def bf16_suites(compare_n=128):
    """Phase 19b: each bf16 F-cycle of BF16_SUITES (GSRB, BiCGStab,
    min_coarse_dim 2) through the port's entry point with the counts reset
    before it and read after it: DOF/s, rel_residual and order printed (no
    limit in bf16), the bf16 kernels of its path launched, no kernel of
    another type (fv4_small, the plain arithmetic every device takes on
    levels below 4^3, aside), no plain version; then one F-cycle at
    ``compare_n`` through the kernels against the same F-cycle through the
    plain versions on the card (plain_fcycle: no kernel launched, the plain
    versions of BF16_PATH_PLAINS called), within BF16_R1_FCYCLE_GAP units of
    2^-8 max|u_plain|."""
    from hpgmg_tpu_torch.bench.driver import build, run_benchmark
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    out = {}
    for tag, op, bc, n in BF16_SUITES:
        cfg = solve_cfg("bicgstab", BF16, op, bc, min_coarse_dim=2)
        t0 = time.perf_counter()
        reset_counts()
        res = run_benchmark(n, cfg, "cuda", min_solve_seconds=0.25, dynamic_range=3)
        launched, plain = read_counts()
        print(f"  {tag} bf16 {n}^3: DOF/s {res.dof_per_second:.6e}, s/solve "
              f"{res.seconds_per_solve:.6f}, rel_residual {res.rel_residual:.6e}, order "
              f"{res.richardson_order:.6f}")
        print(f"  launches: { {k: v for k, v in launched.items() if v} }")
        missing = [k for k in BF16_PATH_KERNELS[(op, bc)] if not launched[k]]
        other = [k for k, v in launched.items()
                 if v and not k.endswith("_bf16") and k != "fv4_small"]
        if missing or other or any(plain.values()):
            raise AssertionError(f"{tag} bf16 F-cycle: kernels not launched {missing}, "
                                 f"kernels of another type launched {other}, plain calls "
                                 f"{plain}")
        if not math.isfinite(res.rel_residual):
            raise AssertionError(f"{tag} bf16 F-cycle rel_residual {res.rel_residual}")
        hier, f = build(compare_n, cfg, torch.device("cuda"))
        u = fmg_solve(get_suite(op), hier, f, cfg)[0]
        (u_plain, nr, nf), plain_calls = plain_fcycle(op, hier, f, cfg,
                                                      BF16_PATH_PLAINS[(op, bc)])
        gap = float((u.float() - u_plain.float()).abs().max()
                    / (u_plain.float().abs().max() * 2.0 ** -8))
        print(f"  {tag} {compare_n}^3: kernels vs plain versions {gap:.3f} units of 2^-8 "
              f"max|u| (limit {BF16_R1_FCYCLE_GAP}); the plain F-cycle: no kernel, plain "
              f"calls {plain_calls}, rel_residual {float(nr) / float(nf):.6e}; "
              f"{time.perf_counter() - t0:.1f} s")
        if not gap <= BF16_R1_FCYCLE_GAP:
            raise AssertionError(f"{tag} bf16 F-cycle: kernels vs plain {gap} > "
                                 f"{BF16_R1_FCYCLE_GAP}")
        out[tag] = {"n": n, "dof_per_s": res.dof_per_second,
                    "seconds_per_solve": res.seconds_per_solve,
                    "rel_residual": res.rel_residual, "richardson_order": res.richardson_order,
                    "u_vs_plain_units": gap, "plain_rel_residual": float(nr) / float(nf),
                    "launches": {k: v for k, v in launched.items() if v},
                    "plain_calls": plain_calls}
        del hier, f, u, u_plain
        torch.cuda.empty_cache()
    return out


def bf16_fcycle_launches():
    """Phase 19c: the launches of one bf16 F-cycle of each of BF16_SUITES at
    its size: the hierarchy built, the counts reset, one fmg_solve, the
    counts read; no plain version."""
    from hpgmg_tpu_torch.bench.driver import build
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    out = {}
    for tag, op, bc, n in BF16_SUITES:
        cfg = solve_cfg("bicgstab", BF16, op, bc, min_coarse_dim=2)
        hier, f = build(n, cfg, torch.device("cuda"))
        reset_counts()
        fmg_solve(get_suite(op), hier, f, cfg)
        torch.cuda.synchronize()
        launched, plain = read_counts()
        out[tag] = {k: v for k, v in launched.items() if v}
        print(f"  {tag} bf16 {n}^3: launches per F-cycle {out[tag]}")
        if any(plain.values()):
            raise AssertionError(f"{tag}: a plain version ran: {plain}")
        del hier, f
        torch.cuda.empty_cache()
    return out


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
    ptxas = ptxas_report(lib_path.with_suffix(".log").read_text())
    for name, props in ptxas:
        print(f"  {name}: {props}")

    phase("3 kernels vs plain")
    worst = {}
    worst["fv4_stencil_vs_K1s"] = check_stream(worst)
    check_gsrb2(worst)
    check_kernels(worst)
    check_r1_kernels(worst)
    check_subtile(worst)
    times = time_kernels()
    r1_times = time_r1_kernels()
    p_times = time_periodic_kernels()
    torch.cuda.empty_cache()

    from hpgmg_tpu_torch.kernels import stencils as S
    from hpgmg_tpu_torch.kernels import tail as T

    phase(f"4 headline fv4 F-cycle 512^3 f32, DIRECT bottom "
          f"(TAIL_ONE_LAUNCH={T.TAIL_ONE_LAUNCH}, SUBTILE={S.SUBTILE})")
    res, counts = headline()
    torch.cuda.empty_cache()
    phase("4b BiCGStab-bottom companion 512^3 f32")
    res_b = companion()
    torch.cuda.empty_cache()
    phase(f"4c the headline with TAIL_ONE_LAUNCH={not T.TAIL_ONE_LAUNCH}")
    res_alt, counts_alt = other_tail_setting(lambda: headline(min_solve_seconds=0.25))
    torch.cuda.empty_cache()
    phase(f"4d the headline with SUBTILE={not S.SUBTILE} (K1s up to "
          f"{S.SUBTILE_MAX_DIM}^3 when on)")
    res_st, counts_st = other_subtile_setting(lambda: headline(min_solve_seconds=0.25))
    torch.cuda.empty_cache()
    phase("4e the headline with K2 smoothing 512^3-128^3 (its gate admits none): K2 "
          "equals two K1 launches bit for bit, so the same residual and order")
    res_k2, counts_k2 = k2_on(lambda: headline(min_solve_seconds=0.25,
                                               also=("fv4_gsrb2",)))
    if (res_k2.rel_residual, res_k2.richardson_order) != (res.rel_residual,
                                                          res.richardson_order):
        raise AssertionError(f"K2 on: rel_residual {res_k2.rel_residual}, order "
                             f"{res_k2.richardson_order} against {res.rel_residual}, "
                             f"{res.richardson_order}")
    torch.cuda.empty_cache()

    phase("5 radius-1 F-cycles 512^3 f32, DIRECT bottom: fv7pt, fv2, 27pt")
    r1 = {}
    for op, secs in (("fv7pt", 1.0), ("fv2", 0.25), ("27pt", 0.25)):
        r1[op] = headline(op, min_solve_seconds=secs, rel_limit=1e-2,
                          order_range=(1.5, 2.6))
        torch.cuda.empty_cache()

    phase("6 f64 F-cycles through the kernels")
    res64 = f64_order()
    res64_alt = other_tail_setting(f64_order)
    if not abs(res64_alt.richardson_order - res64.richardson_order) <= 1e-6:
        raise AssertionError(f"fv4 f64 order {res64.richardson_order} changes to "
                             f"{res64_alt.richardson_order} with the other tail setting")
    res64_k2 = k2_on(f64_order)
    if res64_k2.richardson_order != res64.richardson_order:
        raise AssertionError(f"fv4 f64 order {res64.richardson_order} changes to "
                             f"{res64_k2.richardson_order} with K2 on")
    res64_st = other_subtile_setting(f64_order)
    if not abs(res64_st.richardson_order - res64.richardson_order) <= 1e-6:
        raise AssertionError(f"fv4 f64 order {res64.richardson_order} changes to "
                             f"{res64_st.richardson_order} with the other SUBTILE setting")
    r1_64 = {op: f64_order(op, n, (1.8, 2.3), 0.25)
             for op, n in (("fv7pt", 256), ("fv2", 128), ("27pt", 128))}
    torch.cuda.empty_cache()

    phase("7 periodic F-cycles f32, DIRECT bottom: fv4, fv7pt at 512^3; fv2, 27pt "
          "at 256^3; the fv4 BiCGStab companion; f64 orders")
    per = {"fv4": headline("fv4", bc="periodic", min_solve_seconds=0.5)}
    torch.cuda.empty_cache()
    for op, n, secs in (("fv7pt", 512, 0.5), ("fv2", 256, 0.25), ("27pt", 256, 0.25)):
        per[op] = headline(op, n, min_solve_seconds=secs, rel_limit=1e-2,
                           order_range=(1.5, 2.6), bc="periodic")
        torch.cuda.empty_cache()
    res_pb = companion(bc="periodic")
    torch.cuda.empty_cache()
    # fv4 at 256^3: at 128^3 its f64 order is 3.67, still pre-asymptotic as
    # the JAX package's own (1.25 at 32^3, 2.86 at 64^3; ROADMAP Queue 3)
    per64 = {op: f64_order(op, n, rng_, 0.25, bc="periodic")
             for op, n, rng_ in (("fv4", 256, (3.8, float("inf"))),
                                 ("fv7pt", 128, (1.8, 2.3)))}
    torch.cuda.empty_cache()

    phase("7b launches per F-cycle: one counted F-cycle of each path at 512^3 f32")
    per_cycle = fcycle_launches()
    torch.cuda.empty_cache()

    phase("8 fv4 512^3 f32 through the CLI: each other smoother (DIRECT bottom), "
          "each other bottom solver (GSRB)")
    options = solver_options()
    phase("9 the CLI's drivers: fmg2, fmg2dd at 512^3 f32; fmg2, mgpcg at 256^3 f64")
    drv = drivers()
    phase("10 card equals CPU: fv4 32^3 f64 per smoother and bottom solver")
    worst["solver_options_card_vs_cpu"] = card_equals_cpu()
    torch.cuda.empty_cache()

    phase("11 the slab kernels K8a-K8d vs plain and vs K1/K5/K6, one whole-domain block")
    check_slab_kernels(worst)
    phase("12 the slab kernels' times at the 2x2 grid's 512^3 blocks; one-block K8 vs "
          "K1/K5/K6")
    s_times = time_slab_kernels()
    phase("13 the decomposed F-cycle over a 2x2 grid: 4 processes sharing one GPU, gloo, "
          "host-staged halos (not a multi-card number)")
    dec = {"fv4": decomposed("fv4", 512, "float32", (3.0, float("inf"))),
           "fv7pt": decomposed("fv7pt", 512, "float32", (1.8, 2.2), rel_limit=1e-2),
           "fv4_f64": decomposed("fv4", 256, "float64", (3.8, float("inf")),
                                 overlap=True)}
    phase("14 FE on the card: the reference's tables, Q2 f64 e_L2 rates to G[128^3], "
          "the sampler in f32 to G[128^3] and in f64 at G[64^3] and G[128^3], one "
          "profiled F-cycle; no kernel of K1-K8")
    fe = fe_on_card()
    phase("15 the bench tooling: the CLI's two timing tables at 512^3 f32, the memory "
          "report, a traced F-cycle, the weak sweep over 1 and 4 ranks with a trace")
    tools = tooling(times[512]["gsrb"]["ms"])
    phase("16 the 3D process grid: K8a-K8d with k slabs vs plain, their times in turns "
          "with the k-whole blocks, the (2,2,2) F-cycles at 256^3 (8 processes sharing "
          "one GPU, gloo)")
    g3 = grid3d_on_card(worst)
    phase("17 the FE solver and sampler over the (2,2,2) grid: 8 processes sharing one "
          "GPU, gloo; F-cycles against one rank, the sampler at G[128^3] Q2 f32")
    fe_grid = fe_grid_on_card()
    torch.cuda.empty_cache()

    phase("18a fv4 512^3 f32 on the JAX CLI's ladder (min_coarse_dim 2, BiCGStab): the "
          "2^3 level by the plain version, every other level through the kernels")
    ladder = cli_ladder_fcycle()
    phase("18b the bf16 kernels (K1, K1s, K2c, K3, K4a, K4b) and K1's BF16C gsrb vs plain; "
          "their times 8^3-512^3")
    check_bf16_kernels(worst)
    t_bf16 = time_bf16_kernels()
    phase("18c the bf16 fv4 F-cycle at 512^3 (BiCGStab, min_coarse_dim 2) through the "
          "kernels, and against the same F-cycle through the plain versions on the card")
    bf = bf16_fcycle()
    phase("18d K1's gsrb with BF16C in turns with the f32 K1 at 256^3 and 512^3; the fv4 "
          "512^3 f32 F-cycle with BF16C on")
    bf16c = bf16c_phase()
    phase("19a the bf16 radius-1 and periodic kernels (K5 and K7b, both bodies; K6; K7a) "
          "vs plain at n = 2-256; their times at the bf16 F-cycles' sizes, in turns with f32")
    check_bf16_r1_kernels(worst)
    t19 = time_bf16_r1_kernels()
    phase("19b the bf16 F-cycles of the radius-1 suites and of the periodic BCs (BiCGStab, "
          "min_coarse_dim 2) through the kernels, each against the plain versions at 128^3")
    bf19 = bf16_suites()
    phase("19c launches per bf16 F-cycle: one counted F-cycle of each path of 19b")
    bf19_cycle = bf16_fcycle_launches()

    big = times[512]
    # K6 at the largest level it smooths on the path
    gsrb2_n = max((m for m in r1_times if m <= K.GSRB2_MAX_DIM), default=min(r1_times))
    # K4c launches on the run whose tail setting is on, K4a/K4b on the other
    c_v, c_du = (counts, counts_alt) if T.TAIL_ONE_LAUNCH else (counts_alt, counts)
    # K1s launches on the run with SUBTILE on (K1 above its gate), K1 alone
    # on the other; K1's launches are the main path's either way
    c_k1s = counts if S.SUBTILE else counts_st
    rows = [
        # name, source, replaces, timed pair, launches
        ("fv4_stencil", "fv4_stream.cu", "hpgmg_tpu/kernels/stencils.py:594",
         big["gsrb"], counts["fv4_stencil"]),
        # K1s at the largest level it takes on its path (the gate's maximum)
        ("fv4_subtile", "fv4_subtile.cu", "hpgmg_tpu/kernels/stencils.py:918",
         times[max(m for m in times if isinstance(m, int) and m <= S.SUBTILE_MAX_DIM)][
             "k1s gsrb"],
         c_k1s["fv4_subtile"]),
        # K2 at the headline's size, its launches in the run that forces it
        # on 512^3-128^3 (phase 4e; the shipped gate gives it no level, see
        # "shipped_path_launches"); K2c at the largest level it smooths
        ("fv4_gsrb2", "fv4_gsrb2.cu", "hpgmg_tpu/kernels/stencils.py:1726",
         big["gsrb2"], counts_k2["fv4_gsrb2"]),
        ("fv4_gsrb2_cluster", "fv4_gsrb2_cluster.cu", "hpgmg_tpu/kernels/stencils.py:1726",
         times[max(m for m in times if isinstance(m, int) and m <= S.GSRB2_MAX_DIM)][
             "gsrb2_cluster"], counts["fv4_gsrb2_cluster"]),
        ("tail_down", "tail.cu", "hpgmg_tpu/kernels/tail.py:273",
         times["tail"]["tail_down"], c_du["tail_down"]),
        ("tail_up", "tail.cu", "hpgmg_tpu/kernels/tail.py:298",
         times["tail"]["tail_up"], c_du["tail_up"]),
        ("tail_v", "tail.cu", "hpgmg_tpu/kernels/tail.py:231",
         times["tail"]["tail_v"], c_v["tail_v"]),
        ("restrict_cell", "restrict.cu", "hpgmg_tpu/kernels/restrict.py:77",
         big["restrict"], counts["restrict_cell"]),
        ("r1_stencil_var7", "r1_var7_stream.cu", "hpgmg_tpu/kernels/stencils_r1.py:364",
         r1_times[512]["var7 gsrb"], r1["fv7pt"][1]["r1_stencil"]),
        ("r1_stencil_27pt", "r1_stream.cu", "hpgmg_tpu/kernels/stencils_r1.py:364",
         r1_times[512]["27pt apply"], r1["27pt"][1]["r1_stream"]),
        ("r1_gsrb2", "r1_gsrb2.cu", "hpgmg_tpu/kernels/stencils_r1.py:783",
         r1_times[gsrb2_n]["var7 gsrb2"], r1["fv7pt"][1]["r1_gsrb2"]),
        ("fv4_stencil_periodic", "fv4_stream.cu", "hpgmg_tpu/kernels/stencils.py:1106",
         p_times["fv4 gsrb"], per["fv4"][1]["fv4_stencil_periodic"]),
        ("r1_stencil_periodic_var7", "r1_var7_stream.cu",
         "hpgmg_tpu/kernels/stencils_r1.py:517", p_times["var7"][512]["gsrb"],
         per["fv7pt"][1]["r1_stencil_periodic"]),
        ("r1_stencil_periodic_27pt", "r1_stream.cu",
         "hpgmg_tpu/kernels/stencils_r1.py:517", p_times["27pt"][512]["apply"],
         per["27pt"][1]["r1_stream_periodic"]),
        # the decomposed path: launches in the counted F-cycle of phase 13
        # (K8b's in the run with OVERLAP on)
        ("fv4_slab", "fv4_slab.cu", "hpgmg_tpu/kernels/stencils.py:1268",
         s_times["fv4_slab"], dec["fv4"]["launches"]["fv4_slab"]),
        ("fv4_overlap_interior", "fv4_slab.cu", "hpgmg_tpu/kernels/stencils.py:1370",
         s_times["fv4_overlap_interior"], dec["fv4_f64"]["launches"]["fv4_overlap_interior"]),
        ("fv4_overlap_edge", "fv4_slab.cu", "hpgmg_tpu/kernels/stencils.py:1421",
         s_times["fv4_overlap_edge"], dec["fv4_f64"]["launches"]["fv4_overlap_edge"]),
        ("r1_slab", "r1_var7_stream.cu", "hpgmg_tpu/kernels/stencils_r1.py:645",
         s_times["r1_slab"], dec["fv7pt"]["launches"]["r1_slab"]),
        ("r1_gsrb2_slab", "r1_gsrb2.cu", "hpgmg_tpu/kernels/stencils_r1.py:1029",
         s_times["r1_gsrb2_slab"], dec["fv7pt"]["launches"]["r1_gsrb2_slab"]),
        # the bf16 instantiations: launches in phase 18c's bf16 F-cycle (the
        # BF16C gsrb's in phase 18d's F-cycle with BF16C on), times at the
        # largest level each takes on that path
        ("fv4_stencil_bf16", "fv4_stream.cu", "hpgmg_tpu/kernels/stencils.py:594",
         t_bf16[512]["gsrb"], bf["launches"]["fv4_stencil_bf16"]),
        ("fv4_subtile_bf16", "fv4_subtile.cu", "hpgmg_tpu/kernels/stencils.py:918",
         t_bf16[S.SUBTILE_MAX_DIM]["k1s gsrb"], bf["launches"]["fv4_subtile_bf16"]),
        ("fv4_gsrb2_cluster_bf16", "fv4_gsrb2_cluster.cu",
         "hpgmg_tpu/kernels/stencils.py:1726", t_bf16[S.GSRB2_MAX_DIM]["gsrb2_cluster"],
         bf["launches"]["fv4_gsrb2_cluster_bf16"]),
        ("restrict_cell_bf16", "restrict.cu", "hpgmg_tpu/kernels/restrict.py:77",
         t_bf16[512]["restrict"], bf["launches"]["restrict_cell_bf16"]),
        ("tail_down_bf16", "tail.cu", "hpgmg_tpu/kernels/tail.py:273",
         t_bf16["tail"]["tail_down"], bf["launches"]["tail_down_bf16"]),
        ("tail_up_bf16", "tail.cu", "hpgmg_tpu/kernels/tail.py:298",
         t_bf16["tail"]["tail_up"], bf["launches"]["tail_up_bf16"]),
        ("fv4_stencil_bf16c", "fv4_stream.cu", "hpgmg_tpu/kernels/stencils.py:594",
         bf16c[512]["bf16c"], bf16c["fcycle"]["bf16c_launches"]),
        # the radius-1 and periodic bf16 instantiations: launches in phase
        # 19b's bf16 F-cycles, times at the size each runs at (19a)
        ("r1_stencil_var7_bf16", "r1_var7_stream.cu", "hpgmg_tpu/kernels/stencils_r1.py:364",
         t19["var7"]["gsrb"], bf19["fv7pt"]["launches"]["r1_stencil_bf16"]),
        ("r1_stencil_27pt_bf16", "r1_stream.cu", "hpgmg_tpu/kernels/stencils_r1.py:364",
         t19["27pt"]["apply"], bf19["27pt"]["launches"]["r1_stream_bf16"]),
        ("r1_gsrb2_bf16", "r1_gsrb2.cu", "hpgmg_tpu/kernels/stencils_r1.py:783",
         t19["var7"]["gsrb2"], bf19["fv7pt"]["launches"]["r1_gsrb2_bf16"]),
        ("fv4_stencil_periodic_bf16", "fv4_stream.cu", "hpgmg_tpu/kernels/stencils.py:1106",
         t19["fv4 periodic"]["gsrb"],
         bf19["fv4 periodic"]["launches"]["fv4_stencil_periodic_bf16"]),
        ("r1_stencil_periodic_var7_bf16", "r1_var7_stream.cu",
         "hpgmg_tpu/kernels/stencils_r1.py:517", t19["var7 periodic"]["gsrb"],
         bf19["fv7pt periodic"]["launches"]["r1_stencil_periodic_bf16"]),
        ("r1_stencil_periodic_27pt_bf16", "r1_stream.cu",
         "hpgmg_tpu/kernels/stencils_r1.py:517", t19["27pt periodic"]["apply"],
         bf19["27pt periodic"]["launches"]["r1_stream_periodic_bf16"]),
    ]
    kernels = [{"name": name, "route": "cuda",
                "source": f"hpgmg_tpu_torch/kernels/csrc/{src}", "replaces": rep,
                "launches": launches, **t}
               for name, src, rep, t, launches in rows]
    kernels[[k["name"] for k in kernels].index("fv4_gsrb2")].update(
        launches_from="phase 4e: the headline with K2 forced on 512^3-128^3",
        shipped_path_launches=counts["fv4_gsrb2"])
    # the cluster kernels' registers and spills (f32), beside their shared
    # memory a block (smem_bytes, dynamic: ptxas does not see it)
    regs = dict(ptxas)
    for k in kernels:
        if k["name"] in ("fv4_gsrb2_cluster", "tail_down", "tail_up", "tail_v"):
            k["ptxas"] = regs.get(f"{k['name']}_kernel<float, float>")
        if k["name"] in ("fv4_gsrb2_cluster_bf16", "tail_down_bf16", "tail_up_bf16",
                         "restrict_cell_bf16"):
            k["ptxas"] = regs.get(f"{k['name'][:-5]}_kernel<bf16, float>")
        if k["name"] == "fv4_subtile_bf16":
            k["ptxas"] = {m: regs.get(f"fv4_subtile_kernel<bf16, {i}, float>")
                          for i, m in enumerate(("apply", "residual", "gsrb"))}
        if k["name"] == "fv4_stencil_bf16":
            k["ptxas"] = {m: regs.get(f"fv4_stream_kernel<bf16, bf16, {i}, float>")
                          for i, m in enumerate(("apply", "residual", "gsrb", "fres"))}
            k["modes"] = {m: t_bf16[512][m] for m in ("apply", "residual", "fres")}
            k["gsrb_by_size"] = {m: {key: r["gsrb"][key] for key in ("ms", "bound_ms")}
                                 for m, r in t_bf16.items() if isinstance(m, int)}
        if k["name"] == "fv4_stencil_bf16c":
            k["ptxas"] = regs.get("fv4_stream_kernel<float, bf16, 2, float>")
            k["at_256"] = bf16c[256]["bf16c"]
    # the phase 19 rows: their other modes and their registers and spills
    p19 = {"r1_stencil_var7_bf16": ("var7", "r1_v7_kernel<bf16, {i}, 1, 0, 0, float>"),
           "r1_stencil_27pt_bf16": ("27pt", "r1_stream_kernel<bf16, {i}, float>"),
           "fv4_stencil_periodic_bf16": ("fv4 periodic",
                                         "fv4_stream_kernel<bf16, bf16, {i}, float>"),
           "r1_stencil_periodic_var7_bf16": ("var7 periodic",
                                             "r1_v7_kernel<bf16, {i}, 1, 0, 0, float>"),
           "r1_stencil_periodic_27pt_bf16": ("27pt periodic",
                                             "r1_stream_kernel<bf16, {i}, float>")}
    for k in kernels:
        if k["name"] in p19:
            key, pattern = p19[k["name"]]
            k["modes"] = {m: {f: t19[key][m][f] for f in ("ms", "plain_ms", "bound_ms",
                                                          "max_abs_err")}
                          for m in ("apply", "residual", "gsrb", "fres")}
            k["ptxas"] = {m: regs.get(pattern.format(i=i))
                          for i, m in enumerate(("apply", "residual", "gsrb", "fres"))}
        if k["name"] == "r1_gsrb2_bf16":
            k["ptxas"] = {body: regs.get(f"r1_gsrb2_kernel<bf16, {v}, 0, 0, float>")
                          for body, v in (("var7", 1), ("27pt", 0))}
    # the 27pt body's other modes at 512^3 (the row's own numbers are its
    # apply's) and its registers and spills by mode (f32)
    for name, modes in (("r1_stencil_27pt", {m: r1_times[512][f"27pt {m}"]
                                             for m in ("residual", "gsrb", "fres")}),
                        ("r1_stencil_periodic_27pt", {m: p_times["27pt"][512][m]
                                                      for m in ("residual", "gsrb", "fres")})):
        k = kernels[[k["name"] for k in kernels].index(name)]
        k["modes"] = {m: {key: t[key] for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                      for m, t in modes.items()}
        k["ptxas"] = {m: regs.get(f"r1_stream_kernel<float, {i}, float>")
                      for i, m in enumerate(("apply", "residual", "gsrb", "fres"))}
    # K8a's other modes at the 2x2 grid's finest block and its three modes on
    # one n^3 block in turns with K1; its registers and spills by mode and
    # pass (f32; pass 0 K8a, 1 and 2 K8b's interior and edge passes)
    keys = ("ms", "plain_ms", "bound_ms", "max_abs_err")
    for k in kernels:
        if k["name"] == "fv4_slab":
            k["launches_by_block"] = dec["fv4"]["slab_launches_by_block"]
            k["modes"] = {m: {key: s_times[f"fv4_slab {m}"].get(key) for key in keys}
                          for m in ("apply", "residual")}
            k["one_block"] = {m: {key: s_times[f"K8a {m} one block"].get(key)
                                  for key in ("ms", "plain_ms", "bound_ms", "single_rank")}
                              for m in ("apply", "residual", "gsrb")}
        if k["name"].startswith("fv4_slab") or k["name"].startswith("fv4_overlap"):
            pass_ = {"fv4_slab": 0, "fv4_overlap_interior": 1,
                     "fv4_overlap_edge": 2}[k["name"]]
            k["ptxas"] = {m: regs.get(f"fv4_slab_kernel<float, {i}, {pass_}, 0>")
                          for i, m in enumerate(("apply", "residual", "gsrb"))}
            k["ptxas_kslab"] = {m: {dt: regs.get(f"fv4_slab_kernel<{dt}, {i}, {pass_}, 1>")
                                    for dt in ("float", "double")}
                                for i, m in enumerate(("apply", "residual", "gsrb"))}
    # the var7 body of K5 and K7b: its other modes at 512^3 and its gsrb at
    # every size of phase 3b, its launches by level (phase 7b's counted
    # fv7pt F-cycles), its registers and spills by mode (f32); K8c's
    # launches by block (rank 0 of phase 13's fv7pt run) and registers
    per_size = {"r1_stencil_var7": {m: r1_times[m]["var7 gsrb"] for m in r1_times},
                "r1_stencil_periodic_var7": {m: r["gsrb"] for m, r in p_times["var7"].items()}}
    var7_modes = {"r1_stencil_var7": {m: r1_times[512][f"var7 {m}"]
                                      for m in ("apply", "residual", "fres")},
                  "r1_stencil_periodic_var7": {m: p_times["var7"][512][m]
                                               for m in ("apply", "residual", "fres")}}
    for k in kernels:
        name = k["name"]
        if name in per_size:
            k["modes"] = {m: {key: t[key] for key in keys}
                          for m, t in var7_modes[name].items()}
            k["gsrb_by_size"] = {m: {key: t[key] for key in ("ms", "bound_ms")}
                                 for m, t in per_size[name].items()}
            k["launches_by_level"] = per_cycle[
                "fv7pt" if name == "r1_stencil_var7" else "fv7pt periodic"][
                "r1_stencil_by_level"]
        if name in ("r1_stencil_var7", "r1_stencil_periodic_var7", "r1_slab"):
            k["ptxas"] = {m: regs.get(f"r1_v7_kernel<float, {i}, 1, "
                                      f"{int(name == 'r1_slab')}, 0, float>")
                          for i, m in enumerate(("apply", "residual", "gsrb", "fres"))}
        if name == "r1_slab":
            k["ptxas_kslab"] = {m: {f"{dt} {body}": regs.get(
                f"r1_v7_kernel<{dt}, {i}, {v}, 1, 1, {dt}>")
                                    for dt in ("float", "double")
                                    for body, v in (("var7", 1), ("27pt", 0))}
                                for i, m in enumerate(("apply", "residual", "gsrb", "fres"))}
        if name == "r1_slab":
            k["launches_by_block"] = {b: v for b, v in
                                      dec["fv7pt"]["slab_launches_by_block"].items()
                                      if b.startswith("K8c")}
    # K6's launches by level (phase 7b's fv7pt F-cycle) and K8d's by block
    # (rank 0 of phase 13's fv7pt run), each with its registers and spills
    # by body (f32)
    for k in kernels:
        if k["name"] == "r1_gsrb2":
            k["launches_by_level"] = per_cycle["fv7pt"]["r1_gsrb2_by_level"]
        if k["name"] == "r1_gsrb2_slab":
            k["launches_by_block"] = {b: v for b, v in
                                      dec["fv7pt"]["slab_launches_by_block"].items()
                                      if b.startswith("K8d")}
        if k["name"] in ("r1_gsrb2", "r1_gsrb2_slab"):
            slab = int(k["name"] == "r1_gsrb2_slab")
            k["ptxas"] = {body: regs.get(f"r1_gsrb2_kernel<float, {v}, {slab}, 0, float>")
                          for body, v in (("var7", 1), ("27pt", 0))}
            if slab:
                k["ptxas_kslab"] = {f"{dt} {body}": regs.get(
                    f"r1_gsrb2_kernel<{dt}, {v}, 1, 1, {dt}>")
                                    for dt in ("float", "double")
                                    for body, v in (("var7", 1), ("27pt", 0))}
    # phase 16: the k-split launches of the (2,2,2) F-cycles (K8b's in the
    # run with OVERLAP on), by block, and the k-split times at the (2,2,2)
    # grid's blocks in turns with the k-whole blocks of the same extent
    dec3 = g3["decomposed"]
    for k in kernels:
        if k["name"] in ("fv4_slab", "fv4_overlap_interior", "fv4_overlap_edge", "r1_slab",
                         "r1_gsrb2_slab"):
            run = dec3["fv4" if k["name"] == "fv4_slab" else
                       "fv4_f64" if k["name"].startswith("fv4") else "fv7pt"]
            k["kslab_launches"] = run["launches"][f"{k['name']}_kslab"]
            prefix = {"fv4_slab": "K8a ", "fv4_overlap_interior": "K8b interior ",
                      "fv4_overlap_edge": "K8b edge ", "r1_slab": "K8c ",
                      "r1_gsrb2_slab": "K8d "}[k["name"]]
            k["kslab_launches_by_block"] = {b: v for b, v in
                                            run["slab_launches_by_block"].items()
                                            if b.startswith(prefix) and b.endswith("k-split")}
            k["kslab"] = {blk: row[k["name"]] for blk, row in g3["times"].items()
                          if k["name"] in row}
    print(f"  worst relative errors over the checks: {worst}")
    print(json.dumps({"headline": {
        "dof_per_s": res.dof_per_second, "rel_residual": res.rel_residual,
        "richardson_order": res.richardson_order,
        "bicgstab_dof_per_s": res_b.dof_per_second,
        "tail_one_launch": T.TAIL_ONE_LAUNCH,
        "other_tail_dof_per_s": res_alt.dof_per_second,
        "other_tail_rel_residual": res_alt.rel_residual,
        "other_tail_richardson_order": res_alt.richardson_order,
        "f64_256_order": res64.richardson_order,
        "f64_256_dof_per_s": res64.dof_per_second,
        "f64_256_other_tail_order": res64_alt.richardson_order,
        "subtile": S.SUBTILE,
        "k2_on_dof_per_s": res_k2.dof_per_second,
        "k2_on_rel_residual": res_k2.rel_residual,
        "k2_on_richardson_order": res_k2.richardson_order,
        "f64_256_k2_on_order": res64_k2.richardson_order,
        "other_subtile_dof_per_s": res_st.dof_per_second,
        "other_subtile_rel_residual": res_st.rel_residual,
        "other_subtile_richardson_order": res_st.richardson_order,
        "f64_256_other_subtile_order": res64_st.richardson_order,
        **{f"{tag.replace(' ', '_')}_{key}": getattr(r, attr) for tag, r in options.items()
           for key, attr in (("dof_per_s", "dof_per_second"),
                             ("rel_residual", "rel_residual"),
                             ("richardson_order", "richardson_order"))},
        **{f"{tag.replace(' ', '_')}_{key}": r[key] for tag, r in drv.items()
           for key in ("iterations", "rel_residual", "seconds", "dof_per_second")},
        **{f"{op}_{key}": getattr(r[0], attr) for op, r in r1.items()
           for key, attr in (("dof_per_s", "dof_per_second"),
                             ("rel_residual", "rel_residual"),
                             ("richardson_order", "richardson_order"))},
        **{f"{op}_f64_{r.n}_order": r.richardson_order for op, r in r1_64.items()},
        **{f"{op}_periodic_{r[0].n}_{key}": getattr(r[0], attr) for op, r in per.items()
           for key, attr in (("dof_per_s", "dof_per_second"),
                             ("rel_residual", "rel_residual"),
                             ("richardson_order", "richardson_order"))},
        "fv4_periodic_bicgstab_dof_per_s": res_pb.dof_per_second,
        "fv4_periodic_bicgstab_rel_residual": res_pb.rel_residual,
        **{f"{op}_periodic_f64_{r.n}_order": r.richardson_order
           for op, r in per64.items()},
        **{f"decomposed_2x2_{tag}_{key}": r["res"][key] for tag, r in dec.items()
           for key in ("seconds_per_solve", "rel_residual", "richardson_order")},
        **{f"decomposed_2x2_{tag}_u_vs_one_rank": r["serial_u_rel_diff"]
           for tag, r in dec.items()},
        **{f"decomposed_2x2x2_{tag}_{key}": r["res"][key] for tag, r in dec3.items()
           for key in ("seconds_per_solve", "rel_residual", "richardson_order")},
        **{f"decomposed_2x2x2_{tag}_u_vs_one_rank": r["serial_u_rel_diff"]
           for tag, r in dec3.items()},
        "phase16_wall_seconds": g3["wall_seconds"]}}))
    print(json.dumps({"fcycle_launches": per_cycle}))
    print(json.dumps({"fe": fe}))
    print(json.dumps({"tooling": tools}))
    print(json.dumps({"fe_grid": fe_grid}))
    print(json.dumps({"bf16": {"cli_ladder_f32": ladder, "bf16_fcycle": bf,
                               "bf16c": bf16c, "r1_periodic_fcycles": bf19,
                               "r1_periodic_launches_per_fcycle": bf19_cycle}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
