"""K1, K7a and K2: the fv4 stencil in four modes, with Dirichlet (K1) or
periodic (K7a) ghosts, and the fused red+black GSRB sweep (counterparts of
hpgmg_tpu/kernels/stencils.py:_fv4_kernel, entered through _fv4_call for
Dirichlet levels and through fv4_call_ext for periodic ones, from
fv4_{apply,residual,gsrb_sweep,restrict_residual}_pallas; and
_fv4_gsrb2_kernel, entered through fv4_gsrb2_pallas).

Each entry dispatches on the device of ``x``: CUDA tensors launch the
kernels of ``csrc/``, CPU tensors take the plain version. K1's modes:

* ``apply``: A x
* ``residual``: rhs - A x
* ``gsrb``: x + kdinv * (rhs - A x), kdinv being dinv with one red/black
  parity folded in; out of place, the result is a new tensor
* ``fres``: restrict_cell(rhs - A x), an (n/2)^3 tensor

On CUDA, K1 is two launches: the ghost fill of x into an (n+4)^3 buffer
(``fv4_ghost_fill_cuda``, counted on its own) and the stencil. K7a is the
same stencil launch after the periodic wrap fill
(``fv4_ghost_fill_periodic_cuda``, counted on its own); its face
coefficients are wrapped tangentially at build time
(``extend_beta_tangential``). K2 is one launch per full sweep
(``fv4_gsrb2``): the red half-sweep with kdinv[0], then the black one with
kdinv[1], equal to two K1 gsrb calls. It takes Dirichlet levels only, as
the JAX package fuses no periodic sweep (hpgmg_tpu/ops/fv4.py:172-174).
"""

from __future__ import annotations

from typing import Optional

import torch

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels.restrict import restrict_cell_plain
from hpgmg_tpu_torch.ops.bc_fv import ghost_fill_fv

MODES = {"apply": 0, "residual": 1, "gsrb": 2, "fres": 3}
TWELFTH = 1.0 / 12.0

# Full GSRB sweeps on levels with dim <= GSRB2_MAX_DIM go through K2 (one
# launch) instead of two K1 half-sweeps (0: never). Measured on an H100
# (bench/profile.py --ab, one smoother call of 6 half-sweeps): K2 wins at
# 64^3, where launches dominate (0.21-0.43 against 0.48-0.59 ms), and
# loses from 128^3 up (0.54 against 0.43 ms; 512^3: 23.0 against 19.9 ms).
GSRB2_MAX_DIM = 64


def _check(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
           rhs: Optional[torch.Tensor], kdinv=()):
    """Validate everything the kernels read; raise on what they do not
    take. ``kdinv`` holds the dinv operands the mode reads."""
    if mode not in MODES:
        raise ValueError(f"unknown fv4 stencil mode {mode!r}")
    if cfg.bc not in (BC.DIRICHLET, BC.PERIODIC):
        raise NotImplementedError(f"the fv4 stencil does not take {cfg.bc}")
    n = level.dim
    if n < 4 or (mode == "fres" and n % 2):
        raise ValueError(f"fv4 stencil mode {mode!r} cannot take n={n}")
    cube, dt = (n, n, n), level.dtype
    need = {"x": (x, cube),
            "beta_i": (level.beta_i, (n + 1, n + 2, n + 2)),
            "beta_j": (level.beta_j, (n + 2, n + 1, n + 2)),
            "beta_k": (level.beta_k, (n + 2, n + 2, n + 1))}
    if mode != "apply":
        need["rhs"] = (rhs, cube)
    for p, kd in enumerate(kdinv):
        need["kdinv" if len(kdinv) == 1 else f"kdinv[{p}]"] = (kd, cube)
    if cfg.helmholtz:
        need["alpha"] = (level.alpha, cube)
    for name, (t, shape) in need.items():
        if t is None:
            raise ValueError(f"fv4 stencil mode {mode!r} needs {name}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != dt or dt not in (torch.float32, torch.float64):
            raise TypeError(f"{name} is {t.dtype}; the level is {dt}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_dirichlet(cfg: SolverConfig, what: str):
    """Raise unless the BC is Dirichlet: the fused kernels (K2, K4, K6)
    read no periodic ghost from the opposite face."""
    if cfg.bc != BC.DIRICHLET:
        raise NotImplementedError(f"{what} takes Dirichlet BCs only, got {cfg.bc}")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _tang(axis, t):
    """Offsets for the face accessors: the two tangential axes in
    ascending axis order."""
    others = [ax for ax in range(3) if ax != axis]
    off = [0, 0]
    off[others.index(t)] = 1
    return off


def stencil_ax(sh, bi, bj, bk):
    """The fv4 stencil combination (operators.fv4.c:87-114) in terms of
    accessor callables:

    * ``sh(di, dj, dk)``: solution shifted view (cell-sized)
    * ``bi(f, dj=0, dk=0)`` etc: face coefficient views, f in {0 (low),
      1 (high)}, with tangential shifts

    Returns TWELFTH*main + 0.25*TWELFTH*mixed (the caller applies -b*h2inv).
    """
    c = sh(0, 0, 0)
    main = (
        bi(0) * (15.0 * (sh(-1, 0, 0) - c) - (sh(-2, 0, 0) - sh(+1, 0, 0)))
        + bi(1) * (15.0 * (sh(+1, 0, 0) - c) - (sh(+2, 0, 0) - sh(-1, 0, 0)))
        + bj(0) * (15.0 * (sh(0, -1, 0) - c) - (sh(0, -2, 0) - sh(0, +1, 0)))
        + bj(1) * (15.0 * (sh(0, +1, 0) - c) - (sh(0, +2, 0) - sh(0, -1, 0)))
        + bk(0) * (15.0 * (sh(0, 0, -1) - c) - (sh(0, 0, -2) - sh(0, 0, +1)))
        + bk(1) * (15.0 * (sh(0, 0, +1) - c) - (sh(0, 0, +2) - sh(0, 0, -1)))
    )

    def cross(face_fn, axis, f, t):
        s = 2 * f - 1
        ea = [0, 0, 0]
        ea[axis] = s
        et = [0, 0, 0]
        et[t] = 1
        off = _tang(axis, t)
        dbeta = face_fn(f, *off) - face_fn(f, *[-v for v in off])
        return dbeta * (
            sh(ea[0] + et[0], ea[1] + et[1], ea[2] + et[2])
            - sh(*et)
            - sh(ea[0] - et[0], ea[1] - et[1], ea[2] - et[2])
            + sh(-et[0], -et[1], -et[2])
        )

    mixed = 0.0
    for axis, face_fn in ((0, bi), (1, bj), (2, bk)):
        for f in (0, 1):
            for t in [ax for ax in range(3) if ax != axis]:
                mixed = mixed + cross(face_fn, axis, f, t)

    return TWELFTH * main + 0.25 * TWELFTH * mixed


def apply_plain(level: Level, x: torch.Tensor,
                cfg: SolverConfig) -> torch.Tensor:
    """A x by ghost fill and shifted slices: the arithmetic of K1's plain
    version. At 512^3 it makes ~25 full-size temporaries, so the solver
    never runs it on the card."""
    n = level.dim
    xg = ghost_fill_fv(x, cfg.bc, order=4, radius=2)

    def sh(di=0, dj=0, dk=0):
        return xg[2 + di:2 + di + n, 2 + dj:2 + dj + n, 2 + dk:2 + dk + n]

    # level.beta_* are tangentially extended by one ghost (rebuild_operator),
    # so [1:...] on tangential axes is the domain and +-1 shifts stay inside
    bie, bje, bke = level.beta_i, level.beta_j, level.beta_k

    def bi(f, dj=0, dk=0):
        return bie[f:f + n, 1 + dj:1 + dj + n, 1 + dk:1 + dk + n]

    def bj(f, di=0, dk=0):
        return bje[1 + di:1 + di + n, f:f + n, 1 + dk:1 + dk + n]

    def bk(f, di=0, dj=0):
        return bke[1 + di:1 + di + n, 1 + dj:1 + dj + n, f:f + n]

    ax = -cfg.b * level.h2inv * stencil_ax(sh, bi, bj, bk)
    if cfg.helmholtz:
        ax = cfg.a * level.alpha * sh() + ax
    return ax


def fv4_stencil_plain(level: Level, x: torch.Tensor, cfg: SolverConfig,
                      mode: str, rhs: Optional[torch.Tensor] = None,
                      kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of K1 (ghost fill, shifted slices)."""
    _check(level, x, cfg, mode, rhs, (kdinv,) if mode == "gsrb" else ())
    fv4_stencil_plain.calls += 1
    ax = apply_plain(level, x, cfg)
    if mode == "apply":
        return ax
    if mode == "residual":
        return rhs - ax
    if mode == "gsrb":
        return x + kdinv * (rhs - ax)
    return restrict_cell_plain(rhs - ax)


fv4_stencil_plain.calls = 0


def fv4_gsrb2_plain(level: Level, x: torch.Tensor, rhs: torch.Tensor,
                    cfg: SolverConfig) -> torch.Tensor:
    """The plain version of K2: the red and the black half-sweep of K1's
    plain version, each from a fresh ghost fill."""
    check_dirichlet(cfg, "the fused fv4 sweep (K2)")
    _check(level, x, cfg, "gsrb", rhs, level.kdinv or (None, None))
    fv4_gsrb2_plain.calls += 1
    x = fv4_stencil_plain(level, x, cfg, "gsrb", rhs=rhs, kdinv=level.kdinv[0])
    return fv4_stencil_plain(level, x, cfg, "gsrb", rhs=rhs, kdinv=level.kdinv[1])


fv4_gsrb2_plain.calls = 0


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _ghost_pass(x: torch.Tensor, entry: str) -> torch.Tensor:
    """Launch the ghost pass ``hpgmg_<entry>_{f32,f64}`` of x into a new
    (n+4)^3 buffer."""
    from hpgmg_tpu_torch.kernels.build import library

    if not x.is_cuda:
        raise ValueError(f"{entry} wants a CUDA tensor, got {x.device}")
    n = x.shape[0]
    if (x.dim() != 3 or len(set(x.shape)) != 1 or n < 4 or not x.is_contiguous()
            or x.dtype not in (torch.float32, torch.float64)):
        raise ValueError(f"fv4 ghost fill wants a contiguous float cube, got "
                         f"{tuple(x.shape)} {x.dtype}")
    xp = torch.empty((n + 4,) * 3, dtype=x.dtype, device=x.device)
    dt = "f32" if x.dtype == torch.float32 else "f64"
    with torch.cuda.device(x.device):
        rc = getattr(library(), f"hpgmg_{entry}_{dt}")(x.data_ptr(), xp.data_ptr(),
                                                       n, _stream(x))
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return xp


def fv4_ghost_fill_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K1's ghost pass: the (n+4)^3 tensor of x with its 2-deep
    quartic Dirichlet ghost shell (plain version:
    ``ops/bc_fv.py:ghost_fill_fv(x, BC.DIRICHLET, 4, 2)``)."""
    xp = _ghost_pass(x, "fv4_ghost_fill")
    fv4_ghost_fill_cuda.launches += 1
    return xp


fv4_ghost_fill_cuda.launches = 0


def fv4_ghost_fill_periodic_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K7a's ghost pass: the (n+4)^3 tensor of x with its 2-deep
    periodic shell, edges and corners wrapped on each axis (plain version:
    ``ops/bc_fv.py:ghost_fill_fv(x, BC.PERIODIC, 4, 2)``)."""
    xp = _ghost_pass(x, "fv4_ghost_fill_periodic")
    fv4_ghost_fill_periodic_cuda.launches += 1
    return xp


fv4_ghost_fill_periodic_cuda.launches = 0


def fv4_stencil_cuda(level: Level, x: torch.Tensor, cfg: SolverConfig,
                     mode: str, rhs: Optional[torch.Tensor] = None,
                     kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 (Dirichlet) or K7a (periodic): the ghost pass of the
    level's BC, then the stencil, on CUDA tensors into a newly allocated
    output. The stencil launches of K1 count in ``launches``, those of K7a
    in ``periodic_launches``."""
    from hpgmg_tpu_torch.kernels.build import library

    _check(level, x, cfg, mode, rhs, (kdinv,) if mode == "gsrb" else ())
    if not x.is_cuda:
        raise ValueError(f"fv4_stencil_cuda wants CUDA tensors, got {x.device}")
    n = level.dim
    m = n // 2 if mode == "fres" else n
    periodic = cfg.bc == BC.PERIODIC
    xp = fv4_ghost_fill_periodic_cuda(x) if periodic else fv4_ghost_fill_cuda(x)
    out = torch.empty((m, m, m), dtype=x.dtype, device=x.device)
    alpha = level.alpha if cfg.helmholtz else None
    lib = library()
    fn = (lib.hpgmg_fv4_stencil_f32 if x.dtype == torch.float32
          else lib.hpgmg_fv4_stencil_f64)
    with torch.cuda.device(x.device):
        rc = fn(xp.data_ptr(), level.beta_i.data_ptr(), level.beta_j.data_ptr(),
                level.beta_k.data_ptr(), _ptr(alpha), _ptr(rhs), _ptr(kdinv),
                out.data_ptr(), n, MODES[mode], -cfg.b * level.h2inv,
                float(cfg.a), _stream(x))
    if rc != 0:
        raise RuntimeError(f"fv4 stencil kernel launch failed: CUDA error {rc}")
    if periodic:
        fv4_stencil_cuda.periodic_launches += 1
    else:
        fv4_stencil_cuda.launches += 1
    return out


fv4_stencil_cuda.launches = 0
fv4_stencil_cuda.periodic_launches = 0


def fv4_gsrb2_cuda(level: Level, x: torch.Tensor, rhs: torch.Tensor,
                   cfg: SolverConfig) -> torch.Tensor:
    """Launch K2 (one full red+black sweep) into a newly allocated output."""
    from hpgmg_tpu_torch.kernels.build import library

    check_dirichlet(cfg, "the fused fv4 sweep (K2)")
    _check(level, x, cfg, "gsrb", rhs, level.kdinv or (None, None))
    if not x.is_cuda:
        raise ValueError(f"fv4_gsrb2_cuda wants CUDA tensors, got {x.device}")
    n = level.dim
    if n > 1200:
        raise ValueError(f"fv4 gsrb2 kernel takes n <= 1200, got {n}")
    xp = torch.empty((2,) + (n + 4,) * 3, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    alpha = level.alpha if cfg.helmholtz else None
    lib = library()
    fn = (lib.hpgmg_fv4_gsrb2_f32 if x.dtype == torch.float32
          else lib.hpgmg_fv4_gsrb2_f64)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), level.beta_i.data_ptr(), level.beta_j.data_ptr(),
                level.beta_k.data_ptr(), _ptr(alpha), rhs.data_ptr(),
                level.kdinv[0].data_ptr(), level.kdinv[1].data_ptr(),
                xp[0].data_ptr(), xp[1].data_ptr(), out.data_ptr(), n,
                -cfg.b * level.h2inv, float(cfg.a), _stream(x))
    if rc != 0:
        raise RuntimeError(f"fv4 gsrb2 kernel launch failed: CUDA error {rc}")
    fv4_gsrb2_cuda.launches += 1
    return out


fv4_gsrb2_cuda.launches = 0


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------

def fv4_stencil(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
                rhs: Optional[torch.Tensor] = None,
                kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 (K7a on a periodic level) on ``level``: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return fv4_stencil_cuda(level, x, cfg, mode, rhs, kdinv)
    if x.device.type == "cpu":
        return fv4_stencil_plain(level, x, cfg, mode, rhs, kdinv)
    raise ValueError(f"fv4 stencil has no kernel for device {x.device}")


def fv4_gsrb2(level: Level, x: torch.Tensor, rhs: torch.Tensor,
              cfg: SolverConfig) -> torch.Tensor:
    """K2 on ``level``: one full GSRB sweep (parity 0, then 1) with the
    level's ``kdinv`` pair; the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return fv4_gsrb2_cuda(level, x, rhs, cfg)
    if x.device.type == "cpu":
        return fv4_gsrb2_plain(level, x, rhs, cfg)
    raise ValueError(f"fv4 gsrb2 has no kernel for device {x.device}")
