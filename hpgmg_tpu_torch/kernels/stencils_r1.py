"""K5, K7b and K6: the radius-1 stencil in four modes, with Dirichlet (K5)
or periodic (K7b) ghosts, and the fused red+black GSRB sweep of the fv7pt,
fv2 and 27pt suites (counterparts of hpgmg_tpu/kernels/stencils_r1.py:
_r1_kernel, entered through _r1_call for Dirichlet levels and through
r1_call_ext for periodic ones, from
r1_{apply,residual,gsrb_sweep,restrict_residual}_pallas; and
_r1_gsrb2_kernel, entered through r1_gsrb2_pallas).

Two bodies: ``var7`` (fv7pt, fv2), the 7-point variable-coefficient flux
on the level's natural face arrays with an optional a*alpha*x term, and
``27pt``, the constant-coefficient Mehrstellen stencil plus cfg.a * x (the
27pt suite always adds it, whatever ``cfg.helmholtz`` says). The Dirichlet
ghosts are ``t1 * x1 + t2 * x2`` of the two cells nearest the face, per
suite (``TAPS``), and their tensor product at edges and corners; the
periodic ghosts (K7b) are the wrapped cells, on each axis crossed.

Each entry dispatches on the device of ``x``: CUDA tensors launch the
kernels of ``csrc/`` (``r1_stream.cu`` for the 27pt body,
``r1_var7_stream.cu`` for var7 and for K8c, ``r1_gsrb2.cu`` for K6 and
K8d), CPU tensors take the plain version. K5's
modes are K1's (kernels/stencils.py): apply, residual, gsrb (out of
place, ``x + kdinv * (rhs - A x)``, with the sweep's ``parity``, the
colour kdinv carries) and fres (``restrict_cell(rhs - A x)``). K7b is
K5's launch with its periodic flag set. K6 is one streaming launch per
full sweep (red one plane ahead of black in shared memory), equal to two
K5 gsrb calls (kdinv[0], then kdinv[1]) to rounding; it takes Dirichlet
levels only: a periodic fused sweep would need the opposite face's red
iterate (hpgmg_tpu/kernels/stencils_r1.py:196-205).

Each kernel takes float32, float64 and bfloat16 levels: a bf16 level's
kernels widen every operand to float32 and round each output to bf16
once (``csrc/storage.cuh``; K6 rounds its red half too, as a stored red
iterate is), and the plain versions compute alike (``compute_dtype``,
``widened``). The wrappers count bf16 launches apart (``bf16_launches``,
``periodic_bf16_launches``). The slab kernels (K8c, K8d) have no bf16
instantiation.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels.restrict import restrict_cell_plain
from hpgmg_tpu_torch.kernels.stencils import (DTYPES, MODES, _ptr, _stream, build_slabs,
                                              check_dirichlet, compute_dtype, count_launch,
                                              count_slab_launch, extend_slabs,
                                              local_exchange, widened)
from hpgmg_tpu_torch.ops.bc import _wrap_axis, ghost_fill_linear, ghost_fill_quadratic_fd
from hpgmg_tpu_torch.ops.bc_fv import ghost_fill_fv

# Dirichlet ghost taps g = t1*x1 + t2*x2 per BC family
# (hpgmg_tpu/kernels/stencils_r1.py:_TAPS)
TAPS = {
    "p1": (-1.0, 0.0),  # linear odd reflection (boundary_fd.c:6-92)
    "v2": (-2.5, 0.5),  # quadratic volume-averaged (boundary_fv.c:101)
    "27pt": (-2.0, 1.0 / 3.0),  # quadratic cell-centered (boundary_fd.c:130)
}

# 27pt weights (operators.27pt.c:48-92): center, face, edge, corner
C0 = -128.0 / 30.0
C1 = 14.0 / 30.0
C2 = 3.0 / 30.0
C3 = 1.0 / 30.0

# K6 smooths the levels with dim <= GSRB2_MAX_DIM (pairs of K5 half-sweeps
# above it), for the var7 body only, as the JAX package's default
# (GSRB2_VAR7_ONLY). Measured on an H100 (bench/profile.py --ab, one
# smoother call, ms by CUDA events, K6 against K5 half-sweeps, in turns;
# fv7pt / fv2): 512^3 3.82-3.84 / 5.69-5.72 against 5.94-5.95 / 8.87-8.91,
# 256^3 0.49-0.50 / 0.73-0.74 against 0.78-0.79 / 1.16-1.17, 128^3
# 0.10-0.11 / 0.12 against 0.18-0.21 / 0.22, 16^3-64^3 0.06-0.11 against
# 0.11-0.22 (launch-bound: half the launches). The 27pt body stays on K5:
# its half-sweeps (csrc/r1_stream.cu) beat K6 from 64^3 up (device ms, f32
# 256^3 0.19-0.23 against 0.26-0.28; bench/stencil_times.py --r1).
GSRB2_VAR7_ONLY = True
GSRB2_MAX_DIM = 512


def use_gsrb2(dim: int, var7: bool, bc: BC) -> bool:
    """Whether full GSRB sweeps on a level of ``dim`` go through K6: never
    under periodic BCs."""
    return (bc == BC.DIRICHLET and dim <= GSRB2_MAX_DIM
            and (var7 or not GSRB2_VAR7_ONLY))


def _check(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
           taps: str, var7: bool, rhs: Optional[torch.Tensor], kdinv=(),
           parity: Optional[int] = 0):
    """Validate everything the kernels read; raise on what they do not
    take. ``kdinv`` holds the dinv operands the mode reads; a half-sweep
    (gsrb) needs its ``parity``, 0 or 1."""
    if mode not in MODES:
        raise ValueError(f"unknown radius-1 stencil mode {mode!r}")
    if mode == "gsrb" and parity not in (0, 1):
        raise ValueError(f"a radius-1 gsrb needs the sweep's parity (0 or 1), "
                         f"got {parity!r}")
    if taps not in TAPS:
        raise ValueError(f"unknown ghost taps {taps!r}; have {sorted(TAPS)}")
    if cfg.bc not in (BC.DIRICHLET, BC.PERIODIC):
        raise NotImplementedError(f"the radius-1 stencil does not take {cfg.bc}")
    n = level.dim
    if n < 2 or (mode == "fres" and n % 2):
        raise ValueError(f"radius-1 stencil mode {mode!r} cannot take n={n}")
    cube, dt = (n, n, n), level.dtype
    need = {"x": (x, cube)}
    if var7:
        need.update(beta_i=(level.beta_i, (n + 1, n, n)),
                    beta_j=(level.beta_j, (n, n + 1, n)),
                    beta_k=(level.beta_k, (n, n, n + 1)))
        if cfg.helmholtz:
            need["alpha"] = (level.alpha, cube)
    if mode != "apply":
        need["rhs"] = (rhs, cube)
    for p, kd in enumerate(kdinv):
        need["kdinv" if len(kdinv) == 1 else f"kdinv[{p}]"] = (kd, cube)
    for name, (t, shape) in need.items():
        if t is None:
            raise ValueError(f"radius-1 stencil mode {mode!r} needs {name}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != dt or dt not in DTYPES:
            raise TypeError(f"{name} is {t.dtype}; the level is {dt}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _coefs(level: Level, cfg: SolverConfig, var7: bool):
    """(alpha operand, a coefficient) of the body: var7 takes a*alpha*x
    under ``cfg.helmholtz``; 27pt always adds the constant cfg.a * x."""
    if not var7:
        return None, float(cfg.a)
    if cfg.helmholtz:
        return level.alpha, float(cfg.a)
    return None, 0.0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def ghost_fill_taps(x: torch.Tensor, taps: str, bc: BC) -> torch.Tensor:
    """x with one ghost layer, filled the way the suite's XLA path fills
    it: p1 by odd reflection (ops/bc.py), v2 by the quadratic
    volume-averaged extension (ops/bc_fv.py), 27pt by the quadratic
    cell-centered one (ops/bc.py); all three wrap under periodic BCs."""
    if taps == "p1":
        return ghost_fill_linear(x, bc, radius=1)
    if taps == "v2":
        return ghost_fill_fv(x, bc, order=2, radius=1)
    return ghost_fill_quadratic_fd(x, bc, radius=1)


def beta_laplacian(level: Level, xg: torch.Tensor) -> torch.Tensor:
    """Sum of the six variable-coefficient flux differences
    (hpgmg_tpu/ops/fv7pt.py:beta_laplacian). ``xg`` is the solution with
    one ghost layer; ``beta_*`` are face arrays (beta_i: (n+1, n, n),
    entry [i] = low-i face of cell i)."""
    c = xg[1:-1, 1:-1, 1:-1]
    bi, bj, bk = level.beta_i, level.beta_j, level.beta_k
    return (
        bi[1:, :, :] * (xg[2:, 1:-1, 1:-1] - c)
        + bi[:-1, :, :] * (xg[:-2, 1:-1, 1:-1] - c)
        + bj[:, 1:, :] * (xg[1:-1, 2:, 1:-1] - c)
        + bj[:, :-1, :] * (xg[1:-1, :-2, 1:-1] - c)
        + bk[:, :, 1:] * (xg[1:-1, 1:-1, 2:] - c)
        + bk[:, :, :-1] * (xg[1:-1, 1:-1, :-2] - c)
    )


def laplacian_27pt(xg: torch.Tensor) -> torch.Tensor:
    """C0 x + C1 (6 faces) + C2 (12 edges) + C3 (8 corners) over the
    interior of the one-ghost-layer ``xg`` (hpgmg_tpu/ops/const27pt.py),
    summed as C1 (faces - x) + C2 (edges - x) + C3 (corners - x): the same
    operator, since C0 = -(6 C1 + 12 C2 + 8 C3). The JAX package's order
    of summation adds terms ~4|x| that cancel to ~h^2 |lap x|, which at
    512^3 in float32 leaves Ax with ~1e-3 relative rounding (PERF.md);
    the differences keep it at a few ulps."""
    ni, nj, nk = (m - 2 for m in xg.shape)

    def sh(di, dj, dk):
        return xg[1 + di:1 + di + ni, 1 + dj:1 + dj + nj, 1 + dk:1 + dk + nk]

    c = sh(0, 0, 0)
    sums = {1: None, 2: None, 3: None}
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                m = abs(di) + abs(dj) + abs(dk)
                if m:
                    t = sh(di, dj, dk) - c
                    sums[m] = t if sums[m] is None else sums[m] + t
    return C1 * sums[1] + C2 * sums[2] + C3 * sums[3]


def ax_ext_plain(level, xg: torch.Tensor, cfg: SolverConfig,
                 var7: bool) -> torch.Tensor:
    """A x on the block inside ``xg`` (the block with one ghost layer on
    every axis), ``level``'s face coefficients (and alpha) cut to the block:
    the arithmetic of the JAX suites' XLA paths (fv7pt/fv2 ``apply_op``,
    const27pt ``apply_op``)."""
    x = xg[1:-1, 1:-1, 1:-1]
    if not var7:
        return cfg.a * x - cfg.b * level.h2inv * laplacian_27pt(xg)
    ax = -cfg.b * level.h2inv * beta_laplacian(level, xg)
    if cfg.helmholtz:
        ax = cfg.a * level.alpha * x + ax
    return ax


def apply_plain(level: Level, x: torch.Tensor, cfg: SolverConfig, taps: str,
                var7: bool) -> torch.Tensor:
    """A x by ghost fill and shifted slices."""
    return ax_ext_plain(level, ghost_fill_taps(x, taps, cfg.bc), cfg, var7)


def r1_stencil_plain(level: Level, x: torch.Tensor, cfg: SolverConfig,
                     mode: str, taps: str, var7: bool,
                     rhs: Optional[torch.Tensor] = None,
                     kdinv: Optional[torch.Tensor] = None,
                     parity: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of K5. A gsrb takes and checks the
    kernels' ``parity``; its arithmetic reads the colour from kdinv alone
    (``x + 0 * r`` at the other cells). A bf16 level computes as the
    kernels do: every operand widened to float32 (``compute_dtype``), the
    result rounded to bf16 once."""
    _check(level, x, cfg, mode, taps, var7, rhs,
           (kdinv,) if mode == "gsrb" else (), parity)
    r1_stencil_plain.calls += 1
    ct = compute_dtype(x.dtype)
    xc = x.to(ct)
    ax = apply_plain(widened(level, ct), xc, cfg, taps, var7)
    return _modes(ax, xc, mode, rhs, kdinv).to(x.dtype)


def _modes(ax, x, mode: str, rhs, kdinv):
    """The mode's result from A x, in ax's type (operands widened to it)."""
    if mode == "apply":
        return ax
    if mode == "residual":
        return rhs.to(ax.dtype) - ax
    if mode == "gsrb":
        return x + kdinv.to(ax.dtype) * (rhs.to(ax.dtype) - ax)
    return restrict_cell_plain(rhs.to(ax.dtype) - ax)


r1_stencil_plain.calls = 0


def r1_gsrb2_plain(level: Level, x: torch.Tensor, rhs: torch.Tensor,
                   cfg: SolverConfig, taps: str, var7: bool) -> torch.Tensor:
    """The plain version of K6: K5's plain red half-sweep, then its black
    one, each from a fresh ghost fill."""
    check_dirichlet(cfg, "the fused radius-1 sweep (K6)")
    _check(level, x, cfg, "gsrb", taps, var7, rhs, level.kdinv or (None, None))
    r1_gsrb2_plain.calls += 1
    x = r1_stencil_plain(level, x, cfg, "gsrb", taps, var7, rhs=rhs,
                         kdinv=level.kdinv[0], parity=0)
    return r1_stencil_plain(level, x, cfg, "gsrb", taps, var7, rhs=rhs,
                            kdinv=level.kdinv[1], parity=1)


r1_gsrb2_plain.calls = 0


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _betas(level: Level, var7: bool):
    if not var7:
        return None, None, None
    return level.beta_i.data_ptr(), level.beta_j.data_ptr(), level.beta_k.data_ptr()


def r1_stencil_cuda(level: Level, x: torch.Tensor, cfg: SolverConfig,
                    mode: str, taps: str, var7: bool,
                    rhs: Optional[torch.Tensor] = None,
                    kdinv: Optional[torch.Tensor] = None,
                    parity: Optional[int] = None, chunk: int = 0) -> torch.Tensor:
    """Launch K5 (K7b on a periodic level) on CUDA tensors into a newly
    allocated output: the 27pt body through ``r1_stream_cuda``, the var7
    body on its streaming kernel (``csrc/r1_var7_stream.cu``, one launch a
    call), whose launches count in ``launches`` (K5) and
    ``periodic_launches`` (K7b). A gsrb needs ``parity``, the colour
    ``kdinv`` carries: the kernel computes A x at that colour's cells only
    and copies x at the others. ``chunk``: i-planes a block marches (0: the
    launcher's rule, as the solver calls it; any chunk gives the same
    bits). A bf16 level's launches count in ``bf16_launches`` and
    ``periodic_bf16_launches``."""
    from hpgmg_tpu_torch.kernels.build import library

    if not var7:
        return r1_stream_cuda(level, x, cfg, mode, taps, rhs, kdinv, parity, chunk)
    _check(level, x, cfg, mode, taps, var7, rhs,
           (kdinv,) if mode == "gsrb" else (), parity)
    if not x.is_cuda:
        raise ValueError(f"r1_stencil_cuda wants CUDA tensors, got {x.device}")
    if chunk < 0:
        raise ValueError(f"chunk must be >= 0, got {chunk}")
    n = level.dim
    m = n // 2 if mode == "fres" else n
    out = torch.empty((m, m, m), dtype=x.dtype, device=x.device)
    alpha, a_coef = _coefs(level, cfg, var7)
    periodic = cfg.bc == BC.PERIODIC
    dt = DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        rc = getattr(library(), f"hpgmg_r1_var7_{dt}")(
            x.data_ptr(), *_betas(level, var7), _ptr(alpha), _ptr(rhs), _ptr(kdinv),
            out.data_ptr(), n, MODES[mode], int(periodic), parity or 0, chunk,
            cfg.b * level.h2inv, a_coef, *TAPS[taps], _stream(x))
    if rc != 0:
        raise RuntimeError(f"radius-1 stencil kernel launch failed: CUDA error {rc}")
    count_launch(r1_stencil_cuda, periodic, dt)
    return out


r1_stencil_cuda.launches = 0
r1_stencil_cuda.periodic_launches = 0
r1_stencil_cuda.bf16_launches = 0
r1_stencil_cuda.periodic_bf16_launches = 0


def r1_stream_cuda(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
                   taps: str, rhs: Optional[torch.Tensor] = None,
                   kdinv: Optional[torch.Tensor] = None,
                   parity: Optional[int] = None, chunk: int = 0) -> torch.Tensor:
    """Launch the 27pt body of K5 (K7b on a periodic level),
    ``csrc/r1_stream.cu``, on CUDA tensors into a newly allocated output:
    one launch a call, planes streamed through a shared-memory ring. A gsrb
    needs ``parity``, the colour ``kdinv`` carries: the kernel computes A x
    at that colour's cells only and copies x at the others. ``chunk``:
    i-planes a block marches (0: the launcher's rule, as the solver calls
    it; other values time the rule). Launches count in ``launches`` (K5)
    and ``periodic_launches`` (K7b), a bf16 level's in ``bf16_launches``
    and ``periodic_bf16_launches``."""
    from hpgmg_tpu_torch.kernels.build import library

    _check(level, x, cfg, mode, taps, False, rhs,
           (kdinv,) if mode == "gsrb" else (), parity)
    if not x.is_cuda:
        raise ValueError(f"r1_stream_cuda wants CUDA tensors, got {x.device}")
    if chunk < 0:
        raise ValueError(f"chunk must be >= 0, got {chunk}")
    n = level.dim
    m = n // 2 if mode == "fres" else n
    out = torch.empty((m, m, m), dtype=x.dtype, device=x.device)
    periodic = cfg.bc == BC.PERIODIC
    dt = DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        rc = getattr(library(), f"hpgmg_r1_stream_{dt}")(
            x.data_ptr(), _ptr(rhs), _ptr(kdinv), out.data_ptr(), n, MODES[mode],
            int(periodic), parity or 0, chunk, cfg.b * level.h2inv, float(cfg.a),
            *TAPS[taps], _stream(x))
    if rc != 0:
        raise RuntimeError(f"27pt stream kernel launch failed: CUDA error {rc}")
    count_launch(r1_stream_cuda, periodic, dt)
    return out


r1_stream_cuda.launches = 0
r1_stream_cuda.periodic_launches = 0
r1_stream_cuda.bf16_launches = 0
r1_stream_cuda.periodic_bf16_launches = 0


def _sweep_entry(name: str, x: torch.Tensor, chunk: int):
    """The C entry of K6 or K8d (``name``) for x's dtype: the launcher's
    chunk rule, or (``chunk`` > 0) the ``_chunk`` entry, whose arguments
    take the chunk of i-planes after var7."""
    from hpgmg_tpu_torch.kernels.build import library

    if chunk < 0:
        raise ValueError(f"chunk must be >= 0, got {chunk}")
    dt = DTYPES[x.dtype]
    fn = getattr(library(), f"{name}_chunk_{dt}" if chunk else f"{name}_{dt}")
    return (lambda *a: fn(*a[:-5], chunk, *a[-5:])) if chunk else fn


def r1_gsrb2_cuda(level: Level, x: torch.Tensor, rhs: torch.Tensor,
                  cfg: SolverConfig, taps: str, var7: bool,
                  chunk: int = 0) -> torch.Tensor:
    """Launch K6 (one full red+black sweep, ``csrc/r1_gsrb2.cu``) into a
    newly allocated output. Each half evaluates the stencil at its parity's
    cells only, so the level's kdinv pair must vanish off its parity, as
    ``RadiusOneSuite.fold_kdinv`` builds it. ``chunk``: i-planes a block
    marches (0: the launcher's rule, as the solver calls it; any chunk
    gives the same bits). A bf16 level's launches count in
    ``bf16_launches``."""
    check_dirichlet(cfg, "the fused radius-1 sweep (K6)")
    _check(level, x, cfg, "gsrb", taps, var7, rhs, level.kdinv or (None, None))
    if not x.is_cuda:
        raise ValueError(f"r1_gsrb2_cuda wants CUDA tensors, got {x.device}")
    fn = _sweep_entry("hpgmg_r1_gsrb2", x, chunk)
    out = torch.empty_like(x)
    alpha, a_coef = _coefs(level, cfg, var7)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), *_betas(level, var7), _ptr(alpha), rhs.data_ptr(),
                level.kdinv[0].data_ptr(), level.kdinv[1].data_ptr(),
                out.data_ptr(), level.dim, int(var7), cfg.b * level.h2inv,
                a_coef, *TAPS[taps], _stream(x))
    if rc != 0:
        raise RuntimeError(f"radius-1 gsrb2 kernel launch failed: CUDA error {rc}")
    count_launch(r1_gsrb2_cuda, False, DTYPES[x.dtype])
    return out


r1_gsrb2_cuda.launches = 0
r1_gsrb2_cuda.bf16_launches = 0


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------

def r1_stencil(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
               taps: str, var7: bool, rhs: Optional[torch.Tensor] = None,
               kdinv: Optional[torch.Tensor] = None,
               parity: Optional[int] = None) -> torch.Tensor:
    """K5 (K7b on a periodic level) on ``level``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. A gsrb half-sweep needs
    ``parity``, the colour ``kdinv`` carries."""
    if x.is_cuda:
        return r1_stencil_cuda(level, x, cfg, mode, taps, var7, rhs, kdinv, parity)
    if x.device.type == "cpu":
        return r1_stencil_plain(level, x, cfg, mode, taps, var7, rhs, kdinv, parity)
    raise ValueError(f"radius-1 stencil has no kernel for device {x.device}")


def r1_gsrb2(level: Level, x: torch.Tensor, rhs: torch.Tensor,
             cfg: SolverConfig, taps: str, var7: bool) -> torch.Tensor:
    """K6 on ``level``: one full GSRB sweep (parity 0, then 1) with the
    level's ``kdinv`` pair; the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return r1_gsrb2_cuda(level, x, rhs, cfg, taps, var7)
    if x.device.type == "cpu":
        return r1_gsrb2_plain(level, x, rhs, cfg, taps, var7)
    raise ValueError(f"radius-1 gsrb2 has no kernel for device {x.device}")


# ---------------------------------------------------------------------------
# K8c, K8d: the radius-1 stencils on one rank's local block of a
# decomposed level
# ---------------------------------------------------------------------------

def taps_ghost(taps: str):
    """``ghost(src, axis, lo)`` of ``stencils.build_slabs`` for the 2-tap
    Dirichlet rule: the 1-deep slab t1 * x1 + t2 * x2."""
    t1, t2 = TAPS[taps]

    def ghost(src, axis, lo):
        m = src.shape[axis]
        x1 = src.narrow(axis, 0 if lo else m - 1, 1)
        x2 = src.narrow(axis, 1 if lo else m - 2, 1)
        return t1 * x1 + t2 * x2
    return ghost


def taps_ghost2(taps: str):
    """The 2-deep slab of K8d at a domain face: the 2-tap ghost twice. The
    far row is read only by red at ghost positions, which K8d rebuilds
    (counterpart of shard_kernels.py:slabs2_for_kernel_r1's bc_pair)."""
    one = taps_ghost(taps)

    def ghost(src, axis, lo):
        g = one(src, axis, lo)
        return torch.cat([g, g], dim=axis)
    return ghost


def single_chip_slabs_r1(x: torch.Tensor, bc: BC, taps: str):
    """K8c's slabs for one block that is the whole domain (counterpart of
    hpgmg_tpu/kernels/stencils_r1.py:single_chip_slabs_r1, without its j
    padding to 8 rows): the 2-tap Dirichlet ghosts, or the wrap."""
    return build_slabs(x, 1, 2, taps_ghost(taps), local_exchange(bc))


def single_chip_slabs2_r1(x: torch.Tensor, taps: str):
    """K8d's 2-deep slabs for one block that is the whole (Dirichlet)
    domain."""
    return build_slabs(x, 2, 2, taps_ghost2(taps), local_exchange(BC.DIRICHLET))


def _k_ghosts(xe: torch.Tensor, bc: BC, taps: str) -> torch.Tensor:
    """``xe`` with its 1-deep k ghosts: wrapped, or the 2-tap Dirichlet
    rule."""
    if bc == BC.PERIODIC:
        return _wrap_axis(xe, 2, 1)
    g = taps_ghost(taps)
    return torch.cat([g(xe, 2, True), xe, g(xe, 2, False)], dim=2)


def extend_for_kernel_r1(x: torch.Tensor, slabs, bc: BC, taps: str) -> torch.Tensor:
    """The (ni+2, nj+2, nk+2) extended block K8c's plain version applies the
    stencil to: the slabs in i and j, then the k ghosts: the k slabs where
    there are six (a block split along k), else made (``_k_ghosts``)."""
    if len(slabs) == 6:
        return extend_slabs(x, slabs)
    return _k_ghosts(extend_slabs(x, slabs), bc, taps)


def ring_cut(a: torch.Tensor, oi: int, oj: int, ni: int, nj: int,
             face_axis: Optional[int] = None, ok: int = 0,
             nk: Optional[int] = None) -> torch.Tensor:
    """The cells [oi-1, oi+ni+1) x [oj-1, oj+nj+1) of the global array
    ``a`` (one more face along ``face_axis``), zeros outside the domain,
    and with ``nk`` (a block split along k) the cells [ok-1, ok+nk+1) along
    k too (else the whole k extent): one of K8d's ring views."""
    kring = nk is not None
    ap = torch.nn.functional.pad(a, (1, 1, 1, 1, 1, 1) if kring else (0, 0, 1, 1, 1, 1))
    ei = ni + 2 + (face_axis == 0)
    ej = nj + 2 + (face_axis == 1)
    if not kring:
        return ap[oi:oi + ei, oj:oj + ej].contiguous()
    ek = nk + 2 + (face_axis == 2)
    return ap[oi:oi + ei, oj:oj + ej, ok:ok + ek].contiguous()


def ring_views(level: Level, cfg: SolverConfig, var7: bool, oi: int = 0,
               oj: int = 0, ni: Optional[int] = None, nj: Optional[int] = None,
               ok: int = 0, nk: Optional[int] = None):
    """K8d's ring views of the block [oi, oi+ni) x [oj, oj+nj) x [ok,
    ok+nk) of the global ``level``: (kdinv0, alpha, beta_i, beta_j,
    beta_k), each with its 1-cell ring in i and j, and in k too where the
    block is split along k (``nk`` below the level's extent) (counterpart of
    shard_kernels.py:build_sharded_k2_r1); alpha and the faces None where
    the body reads none."""
    ni = level.dim if ni is None else ni
    nj = level.dim if nj is None else nj
    kw = dict(ok=ok, nk=nk) if nk is not None and nk < level.dim else {}
    kd0 = ring_cut(level.kdinv[0], oi, oj, ni, nj, **kw)
    if not var7:
        return kd0, None, None, None, None
    alpha = ring_cut(level.alpha, oi, oj, ni, nj, **kw) if cfg.helmholtz else None
    return (kd0, alpha, ring_cut(level.beta_i, oi, oj, ni, nj, 0, **kw),
            ring_cut(level.beta_j, oi, oj, ni, nj, 1, **kw),
            ring_cut(level.beta_k, oi, oj, ni, nj, 2 if kw else None, **kw))


def _check_block(x: torch.Tensor, need: dict, what: str):
    """Validate x and the operands ``need`` maps to their shapes; raise on
    what ``what`` does not take."""
    if x.dim() != 3:
        raise ValueError(f"x must be a 3-D block, got {tuple(x.shape)}")
    if x.dtype == torch.bfloat16:
        raise NotImplementedError(f"{what} has no bfloat16 instantiation (ROADMAP.md "
                                  f"Queue 1, item 1.2)")
    ni, nj, nk = x.shape
    if min(ni, nj, nk) < 2:
        raise ValueError(f"{what} takes extents >= 2, got {tuple(x.shape)}")
    need = {"x": (x, (ni, nj, nk)), **need}
    for name, (t, shape) in need.items():
        if t is None:
            raise ValueError(f"{what} needs {name}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != x.dtype or x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} is {t.dtype}; x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_slab(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                mode: str, taps: str, var7: bool, rhs, kdinv):
    if mode not in MODES:
        raise ValueError(f"unknown radius-1 stencil mode {mode!r}")
    if taps not in TAPS:
        raise ValueError(f"unknown ghost taps {taps!r}; have {sorted(TAPS)}")
    if cfg.bc not in (BC.DIRICHLET, BC.PERIODIC):
        raise NotImplementedError(f"the radius-1 slab kernel does not take {cfg.bc}")
    ni, nj, nk = x.shape if x.dim() == 3 else (0, 0, 0)
    if mode == "fres" and (ni % 2 or nj % 2 or nk % 2):
        raise ValueError(f"fres needs even extents, got {tuple(x.shape)}")
    blk = (ni, nj, nk)
    if len(slabs) not in (4, 6):
        raise ValueError(f"K8c takes 4 slabs, or 6 on a block split along k, "
                         f"got {len(slabs)}")
    need = dict(zip(("ilo", "ihi", "jlo", "jhi", "klo", "khi"),
                    zip(slabs, ((1, nj, nk),) * 2 + ((ni + 2, 1, nk),) * 2
                        + ((ni + 2, nj + 2, 1),) * 2)))
    if var7:
        need.update(beta_i=(level.beta_i, (ni + 1, nj, nk)),
                    beta_j=(level.beta_j, (ni, nj + 1, nk)),
                    beta_k=(level.beta_k, (ni, nj, nk + 1)))
        if cfg.helmholtz:
            need["alpha"] = (level.alpha, blk)
    if mode != "apply":
        need["rhs"] = (rhs, blk)
    if mode == "gsrb":
        need["kdinv"] = (kdinv, blk)
    _check_block(x, need, "the radius-1 slab kernel (K8c)")


def r1_slab_plain(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                  mode: str, taps: str, var7: bool,
                  rhs: Optional[torch.Tensor] = None,
                  kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of K8c: the extended block assembled from x and the
    slabs, then K5's plain arithmetic."""
    _check_slab(level, x, slabs, cfg, mode, taps, var7, rhs, kdinv)
    r1_slab_plain.calls += 1
    xg = extend_for_kernel_r1(x, slabs, cfg.bc, taps)
    return _modes(ax_ext_plain(level, xg, cfg, var7), x, mode, rhs, kdinv)


r1_slab_plain.calls = 0


def r1_slab_cuda(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                 mode: str, taps: str, var7: bool,
                 rhs: Optional[torch.Tensor] = None,
                 kdinv: Optional[torch.Tensor] = None,
                 parity: Optional[int] = None, chunk: int = 0) -> torch.Tensor:
    """Launch K8c (``csrc/r1_var7_stream.cu``, K5's var7 kernel with the
    slabs as its halo's sources, both bodies) on CUDA tensors into a newly
    allocated output. A gsrb needs ``parity``, the colour
    ``kdinv`` carries (local parity is global: block offsets are even);
    ``chunk`` as ``r1_stencil_cuda``'s. Six slabs (a block split along k):
    the k ghosts are the k slabs' cells (``kslab_launches`` counts these
    launches), else made or wrapped."""
    from hpgmg_tpu_torch.kernels.build import library

    _check_slab(level, x, slabs, cfg, mode, taps, var7, rhs, kdinv)
    if not x.is_cuda:
        raise ValueError(f"r1_slab_cuda wants CUDA tensors, got {x.device}")
    if mode == "gsrb" and parity not in (0, 1):
        raise ValueError(f"the radius-1 slab gsrb needs the sweep's parity (0 or 1), "
                         f"got {parity!r}")
    if chunk < 0:
        raise ValueError(f"chunk must be >= 0, got {chunk}")
    ni, nj, nk = x.shape
    shape = (ni // 2, nj // 2, nk // 2) if mode == "fres" else (ni, nj, nk)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    alpha, a_coef = _coefs(level, cfg, var7)
    ksplit = len(slabs) == 6
    fn = getattr(library(), "hpgmg_r1_slab_" + ("f32" if x.dtype == torch.float32 else "f64"))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), *(_ptr(t) for t in tuple(slabs) + (None,) * (6 - len(slabs))),
                *_betas(level, var7), _ptr(alpha), _ptr(rhs), _ptr(kdinv), out.data_ptr(),
                ni, nj, nk, MODES[mode], int(var7), int(cfg.bc == BC.PERIODIC), parity or 0,
                chunk, cfg.b * level.h2inv, a_coef, *TAPS[taps], _stream(x))
    if rc != 0:
        raise RuntimeError(f"radius-1 slab kernel launch failed: CUDA error {rc}")
    r1_slab_cuda.launches += 1
    r1_slab_cuda.kslab_launches += ksplit
    count_slab_launch(f"K8c {mode} {(ni, nj, nk)}", ksplit)
    return out


r1_slab_cuda.launches = 0
r1_slab_cuda.kslab_launches = 0


def _check_gsrb2_slab(level: Level, x: torch.Tensor, slabs, edges, rhs2,
                      cfg: SolverConfig, taps: str, var7: bool):
    check_dirichlet(cfg, "the fused radius-1 slab sweep (K8d)")
    if taps not in TAPS:
        raise ValueError(f"unknown ghost taps {taps!r}; have {sorted(TAPS)}")
    if len(slabs) not in (4, 6):
        raise ValueError(f"K8d takes 4 slabs, or 6 on a block split along k, "
                         f"got {len(slabs)}")
    ksplit = len(slabs) == 6
    if len(edges) not in (4, 6) or (ksplit and len(edges) != 6) or (
            not ksplit and len(edges) == 6 and not (edges[4] and edges[5])):
        raise ValueError(f"K8d wants 4 edge flags (6 on a block split along k; a "
                         f"block whole along k has both k sides on domain faces), "
                         f"got {edges}")
    if level.ring is None or level.kdinv is None:
        raise ValueError("K8d needs the level's ring views and kdinv")
    ni, nj, nk = x.shape if x.dim() == 3 else (0, 0, 0)
    if ni % 2 or nj % 2 or (ksplit and nk % 2):
        raise ValueError(f"K8d needs even local extents, got {tuple(x.shape)}")
    kd0, alpha, rbi, rbj, rbk = level.ring
    kr = nk + 2 if ksplit else nk
    ring = (ni + 2, nj + 2, kr)
    need = dict(zip(("ilo", "ihi", "jlo", "jhi", "klo", "khi"),
                    zip(slabs, ((2, nj, nk),) * 2 + ((ni + 4, 2, nk),) * 2
                        + ((ni + 4, nj + 4, 2),) * 2)))
    need.update(rhs2=(rhs2, ring), kdinv0_ring=(kd0, ring),
                kdinv1=(level.kdinv[1], (ni, nj, nk)))
    if var7:
        need.update(beta_i_ring=(rbi, (ni + 3, nj + 2, kr)),
                    beta_j_ring=(rbj, (ni + 2, nj + 3, kr)),
                    beta_k_ring=(rbk, (ni + 2, nj + 2, kr + 1)))
        if cfg.helmholtz:
            need["alpha_ring"] = (alpha, ring)
    _check_block(x, need, "the fused radius-1 slab sweep (K8d)")


def r1_gsrb2_slab_plain(level: Level, x: torch.Tensor, slabs, edges, rhs2,
                        cfg: SolverConfig, taps: str, var7: bool) -> torch.Tensor:
    """The plain version of K8d: red on the block and its 1-cell ring (in i
    and j, and in k on a block split along k: six slabs) from the 2-deep
    extended block (ring coefficients from ``level.ring``), the red
    iterate's ghosts rebuilt on the sides ``edges`` flags (i, then j, then
    k; a block whole along k has its k ghosts made), then black on the
    block."""
    _check_gsrb2_slab(level, x, slabs, edges, rhs2, cfg, taps, var7)
    r1_gsrb2_slab_plain.calls += 1
    ksplit = len(slabs) == 6
    kd0, alpha, rbi, rbj, rbk = level.ring
    ring = SimpleNamespace(h2inv=level.h2inv, beta_i=rbi, beta_j=rbj, beta_k=rbk,
                           alpha=alpha)
    xe = extend_slabs(x, slabs)
    xg = xe if ksplit else _k_ghosts(xe, BC.DIRICHLET, taps)
    red = xg[1:-1, 1:-1, 1:-1] + kd0 * (rhs2 - ax_ext_plain(ring, xg, cfg, var7))
    t1, t2 = TAPS[taps]
    for axis, (lo, hi) in enumerate((edges[:2], edges[2:4], edges[4:6])[:2 + ksplit]):
        m = red.shape[axis]
        for flag, g, a, b in ((lo, 0, 1, 2), (hi, m - 1, m - 2, m - 3)):
            if flag:
                red.select(axis, g).copy_(t1 * red.select(axis, a)
                                          + t2 * red.select(axis, b))
    inner = (slice(1, -1),) * (3 if ksplit else 2)
    tile = SimpleNamespace(h2inv=level.h2inv, **{
        name: None if t is None else t[inner]
        for name, t in zip(("beta_i", "beta_j", "beta_k", "alpha"), (rbi, rbj, rbk, alpha))})
    rg = red if ksplit else _k_ghosts(red, BC.DIRICHLET, taps)
    return red[inner] + level.kdinv[1] * (rhs2[inner] - ax_ext_plain(tile, rg, cfg, var7))


r1_gsrb2_slab_plain.calls = 0


def r1_gsrb2_slab_cuda(level: Level, x: torch.Tensor, slabs, edges, rhs2,
                       cfg: SolverConfig, taps: str, var7: bool,
                       chunk: int = 0) -> torch.Tensor:
    """Launch K8d (one full red+black sweep of the block, K6's kernel with
    the slabs as its halo's sources) into a newly allocated output.
    ``chunk`` as ``r1_gsrb2_cuda``'s. Six slabs (a block split along k):
    red also runs on the k ring, its x from the k slabs (``kslab_launches``
    counts these launches)."""
    _check_gsrb2_slab(level, x, slabs, edges, rhs2, cfg, taps, var7)
    if not x.is_cuda:
        raise ValueError(f"r1_gsrb2_slab_cuda wants CUDA tensors, got {x.device}")
    fn = _sweep_entry("hpgmg_r1_gsrb2_slab", x, chunk)
    ni, nj, nk = x.shape
    out = torch.empty_like(x)
    kd0, alpha, rbi, rbj, rbk = level.ring
    _, a_coef = _coefs(level, cfg, var7)
    ksplit = len(slabs) == 6
    edges = tuple(edges) + (True, True) * (len(edges) == 4)
    bits = sum(int(bool(e)) << k for k, e in enumerate(edges))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), *(_ptr(t) for t in tuple(slabs) + (None,) * (6 - len(slabs))),
                _ptr(rbi), _ptr(rbj), _ptr(rbk), _ptr(alpha), rhs2.data_ptr(),
                kd0.data_ptr(), level.kdinv[1].data_ptr(), out.data_ptr(), ni, nj, nk, bits,
                int(var7), cfg.b * level.h2inv, a_coef, *TAPS[taps], _stream(x))
    if rc != 0:
        raise RuntimeError(f"radius-1 gsrb2 slab kernel launch failed: CUDA error {rc}")
    r1_gsrb2_slab_cuda.launches += 1
    r1_gsrb2_slab_cuda.kslab_launches += ksplit
    count_slab_launch(f"K8d sweep {(ni, nj, nk)}", ksplit)
    return out


r1_gsrb2_slab_cuda.launches = 0
r1_gsrb2_slab_cuda.kslab_launches = 0


def r1_slab(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig, mode: str,
            taps: str, var7: bool, rhs: Optional[torch.Tensor] = None,
            kdinv: Optional[torch.Tensor] = None,
            parity: Optional[int] = None) -> torch.Tensor:
    """K8c on a local block: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. A gsrb half-sweep on the card needs
    ``parity``, the colour ``kdinv`` carries; the plain version reads the
    colour from kdinv alone."""
    if x.is_cuda:
        return r1_slab_cuda(level, x, slabs, cfg, mode, taps, var7, rhs, kdinv, parity)
    if x.device.type == "cpu":
        return r1_slab_plain(level, x, slabs, cfg, mode, taps, var7, rhs, kdinv)
    raise ValueError(f"radius-1 slab kernel has no kernel for device {x.device}")


def r1_gsrb2_slab(level: Level, x: torch.Tensor, slabs, edges, rhs2,
                  cfg: SolverConfig, taps: str, var7: bool) -> torch.Tensor:
    """K8d on a local block: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return r1_gsrb2_slab_cuda(level, x, slabs, edges, rhs2, cfg, taps, var7)
    if x.device.type == "cpu":
        return r1_gsrb2_slab_plain(level, x, slabs, edges, rhs2, cfg, taps, var7)
    raise ValueError(f"radius-1 gsrb2 slab has no kernel for device {x.device}")


def r1_gsrb2_one_block(level: Level, x: torch.Tensor, rhs: torch.Tensor,
                       cfg: SolverConfig, taps: str, var7: bool) -> torch.Tensor:
    """K8d driven on one block that is the whole domain: the Dirichlet
    slabs, every edge flag set, the ring views and rhs ring cut from the
    level (zeros outside the domain). Equal to K6 to rounding."""
    import dataclasses

    lv = dataclasses.replace(level, ring=ring_views(level, cfg, var7))
    n = level.dim
    return r1_gsrb2_slab(lv, x, single_chip_slabs2_r1(x, taps), (True,) * 4,
                         ring_cut(rhs, 0, 0, n, n), cfg, taps, var7)
