"""K5 and K6: the radius-1 stencil in four modes and the fused red+black
GSRB sweep of the fv7pt, fv2 and 27pt suites (counterparts of
hpgmg_tpu/kernels/stencils_r1.py:_r1_kernel, entered through
r1_{apply,residual,gsrb_sweep,restrict_residual}_pallas, and
_r1_gsrb2_kernel, entered through r1_gsrb2_pallas).

Two bodies: ``var7`` (fv7pt, fv2), the 7-point variable-coefficient flux
on the level's natural face arrays with an optional a*alpha*x term, and
``27pt``, the constant-coefficient Mehrstellen stencil plus cfg.a * x (the
27pt suite always adds it, whatever ``cfg.helmholtz`` says). The Dirichlet
ghosts are ``t1 * x1 + t2 * x2`` of the two cells nearest the face, per
suite (``TAPS``), and their tensor product at edges and corners.

Each entry dispatches on the device of ``x``: CUDA tensors launch the
kernels of ``csrc/`` (``r1_stencil.cu``, ``r1_gsrb2.cu``), CPU tensors take
the plain version. K5's modes are K1's (kernels/stencils.py): apply,
residual, gsrb (out of place, ``x + kdinv * (rhs - A x)``) and fres
(``restrict_cell(rhs - A x)``). K6 is one launch per full sweep, equal to
two K5 gsrb calls (kdinv[0], then kdinv[1]).
"""

from __future__ import annotations

from typing import Optional

import torch

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels.restrict import restrict_cell_plain
from hpgmg_tpu_torch.kernels.stencils import MODES, _ptr, _stream
from hpgmg_tpu_torch.ops.bc import ghost_fill_linear, ghost_fill_quadratic_fd
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
# smoother call, device ms, K6 against K5 half-sweeps; fv7pt / fv2):
# 16^3-64^3 0.12 / 0.16 against 0.23-0.27 / 0.31-0.32 (launch-bound),
# 128^3 0.14 / 0.21 against 0.20 / 0.32, 256^3 0.78-0.80 / 1.18-1.19 against
# 0.79 / 1.18-1.19 (a tie, in half the launches), 512^3 6.70 / 10.04-10.12
# against 6.00-6.05 / 9.04-9.12.
GSRB2_VAR7_ONLY = True
GSRB2_MAX_DIM = 256


def use_gsrb2(dim: int, var7: bool) -> bool:
    """Whether full GSRB sweeps on a level of ``dim`` go through K6."""
    return dim <= GSRB2_MAX_DIM and (var7 or not GSRB2_VAR7_ONLY)


def _check(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
           taps: str, var7: bool, rhs: Optional[torch.Tensor], kdinv=()):
    """Validate everything the kernels read; raise on what they do not
    take. ``kdinv`` holds the dinv operands the mode reads."""
    if mode not in MODES:
        raise ValueError(f"unknown radius-1 stencil mode {mode!r}")
    if taps not in TAPS:
        raise ValueError(f"unknown ghost taps {taps!r}; have {sorted(TAPS)}")
    if cfg.bc != BC.DIRICHLET:
        raise NotImplementedError("the radius-1 stencil supports Dirichlet "
                                  "BCs only")
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
        if t.dtype != dt or dt not in (torch.float32, torch.float64):
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
    cell-centered one (ops/bc.py)."""
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
    n = xg.shape[0] - 2

    def sh(di, dj, dk):
        return xg[1 + di:1 + di + n, 1 + dj:1 + dj + n, 1 + dk:1 + dk + n]

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


def apply_plain(level: Level, x: torch.Tensor, cfg: SolverConfig, taps: str,
                var7: bool) -> torch.Tensor:
    """A x by ghost fill and shifted slices, the arithmetic of the JAX
    suites' XLA paths (fv7pt/fv2 ``apply_op``, const27pt ``apply_op``)."""
    xg = ghost_fill_taps(x, taps, cfg.bc)
    if not var7:
        return cfg.a * x - cfg.b * level.h2inv * laplacian_27pt(xg)
    ax = -cfg.b * level.h2inv * beta_laplacian(level, xg)
    if cfg.helmholtz:
        ax = cfg.a * level.alpha * x + ax
    return ax


def r1_stencil_plain(level: Level, x: torch.Tensor, cfg: SolverConfig,
                     mode: str, taps: str, var7: bool,
                     rhs: Optional[torch.Tensor] = None,
                     kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of K5."""
    _check(level, x, cfg, mode, taps, var7, rhs,
           (kdinv,) if mode == "gsrb" else ())
    r1_stencil_plain.calls += 1
    ax = apply_plain(level, x, cfg, taps, var7)
    if mode == "apply":
        return ax
    if mode == "residual":
        return rhs - ax
    if mode == "gsrb":
        return x + kdinv * (rhs - ax)
    return restrict_cell_plain(rhs - ax)


r1_stencil_plain.calls = 0


def r1_gsrb2_plain(level: Level, x: torch.Tensor, rhs: torch.Tensor,
                   cfg: SolverConfig, taps: str, var7: bool) -> torch.Tensor:
    """The plain version of K6: K5's plain red half-sweep, then its black
    one, each from a fresh ghost fill."""
    _check(level, x, cfg, "gsrb", taps, var7, rhs, level.kdinv or (None, None))
    r1_gsrb2_plain.calls += 1
    x = r1_stencil_plain(level, x, cfg, "gsrb", taps, var7, rhs=rhs,
                         kdinv=level.kdinv[0])
    return r1_stencil_plain(level, x, cfg, "gsrb", taps, var7, rhs=rhs,
                            kdinv=level.kdinv[1])


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
                    kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K5 on CUDA tensors into a newly allocated output."""
    from hpgmg_tpu_torch.kernels.build import library

    _check(level, x, cfg, mode, taps, var7, rhs,
           (kdinv,) if mode == "gsrb" else ())
    if not x.is_cuda:
        raise ValueError(f"r1_stencil_cuda wants CUDA tensors, got {x.device}")
    n = level.dim
    m = n // 2 if mode == "fres" else n
    out = torch.empty((m, m, m), dtype=x.dtype, device=x.device)
    alpha, a_coef = _coefs(level, cfg, var7)
    lib = library()
    fn = (lib.hpgmg_r1_stencil_f32 if x.dtype == torch.float32
          else lib.hpgmg_r1_stencil_f64)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), *_betas(level, var7), _ptr(alpha), _ptr(rhs),
                _ptr(kdinv), out.data_ptr(), n, MODES[mode], int(var7),
                cfg.b * level.h2inv, a_coef, *TAPS[taps], _stream(x))
    if rc != 0:
        raise RuntimeError(f"radius-1 stencil kernel launch failed: CUDA error {rc}")
    r1_stencil_cuda.launches += 1
    return out


r1_stencil_cuda.launches = 0


def r1_gsrb2_cuda(level: Level, x: torch.Tensor, rhs: torch.Tensor,
                  cfg: SolverConfig, taps: str, var7: bool) -> torch.Tensor:
    """Launch K6 (one full red+black sweep) into a newly allocated output.
    Each half evaluates the stencil at its parity's cells only, so the
    level's kdinv pair must vanish off its parity, as
    ``RadiusOneSuite.fold_kdinv`` builds it."""
    from hpgmg_tpu_torch.kernels.build import library

    _check(level, x, cfg, "gsrb", taps, var7, rhs, level.kdinv or (None, None))
    if not x.is_cuda:
        raise ValueError(f"r1_gsrb2_cuda wants CUDA tensors, got {x.device}")
    out = torch.empty_like(x)
    alpha, a_coef = _coefs(level, cfg, var7)
    lib = library()
    fn = (lib.hpgmg_r1_gsrb2_f32 if x.dtype == torch.float32
          else lib.hpgmg_r1_gsrb2_f64)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), *_betas(level, var7), _ptr(alpha), rhs.data_ptr(),
                level.kdinv[0].data_ptr(), level.kdinv[1].data_ptr(),
                out.data_ptr(), level.dim, int(var7), cfg.b * level.h2inv,
                a_coef, *TAPS[taps], _stream(x))
    if rc != 0:
        raise RuntimeError(f"radius-1 gsrb2 kernel launch failed: CUDA error {rc}")
    r1_gsrb2_cuda.launches += 1
    return out


r1_gsrb2_cuda.launches = 0


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------

def r1_stencil(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
               taps: str, var7: bool, rhs: Optional[torch.Tensor] = None,
               kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5 on ``level``: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.is_cuda:
        return r1_stencil_cuda(level, x, cfg, mode, taps, var7, rhs, kdinv)
    if x.device.type == "cpu":
        return r1_stencil_plain(level, x, cfg, mode, taps, var7, rhs, kdinv)
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
