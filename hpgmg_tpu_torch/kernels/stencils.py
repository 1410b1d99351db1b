"""K1, K7a, K1s and K2: the fv4 stencil in four modes, with Dirichlet (K1)
or periodic (K7a) ghosts; its one-pass sub-tiled form (K1s); and the fused
red+black GSRB sweep (counterparts of hpgmg_tpu/kernels/stencils.py:
_fv4_kernel, entered through _fv4_call for Dirichlet levels and through
fv4_call_ext for periodic ones, from
fv4_{apply,residual,gsrb_sweep,restrict_residual}_pallas;
_fv4_kernel_subtile, entered through _fv4_call_subtile under SUBTILE; and
_fv4_gsrb2_kernel, entered through fv4_gsrb2_pallas).

Each entry dispatches on the device of ``x``: CUDA tensors launch the
kernels of ``csrc/``, CPU tensors take the plain version. K1's modes:

* ``apply``: A x
* ``residual``: rhs - A x
* ``gsrb``: x + kdinv * (rhs - A x), kdinv being dinv with one red/black
  parity folded in; out of place, the result is a new tensor
* ``fres``: restrict_cell(rhs - A x), an (n/2)^3 tensor

On CUDA, K1 and K7a are one launch a call (``fv4_stencil_cuda``,
``csrc/fv4_stream.cu``): blocks stream x and the face coefficients plane
by plane through shared memory, making x's quartic Dirichlet ghosts (K1)
or wrapped ones (K7a) as its planes arrive, and a gsrb half-sweep computes
A x at the cells of its ``parity`` only. K7a's face coefficients are
wrapped tangentially at build time (``extend_beta_tangential``); its
launches count in ``periodic_launches``. A full sweep (the red half-sweep
with kdinv[0], then the black one with kdinv[1]) has two kernels: K2c, one
launch of thread-block clusters, each a slab of i-planes whose blocks
share their red planes through distributed shared memory
(``fv4_gsrb2_cluster_cuda``, ``csrc/fv4_gsrb2_cluster.cu``), which the
suite's ``fv4_gsrb2`` launches on the levels up to ``GSRB2_MAX_DIM``; and
K2, one ordinary launch that
streams the red half-sweep two planes ahead of the black one through
shared memory (``fv4_gsrb2_cuda``, ``csrc/fv4_gsrb2.cu``), equal to two K1
gsrb calls bit for bit, which no level takes (see the gate). Both take
Dirichlet levels only, as the JAX package fuses no periodic sweep
(hpgmg_tpu/ops/fv4.py:172-174).

K1s (``fv4_subtile``) computes K1's apply, residual and gsrb in one launch
on a Dirichlet level, its ghosts synthesized in the kernel
(``csrc/fv4_subtile.cu``); it has no fres mode and refuses periodic
levels. The fv4 suite routes a level to it where ``use_subtile`` admits
it (``SUBTILE`` on, Dirichlet, dim <= ``SUBTILE_MAX_DIM``).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels.restrict import restrict_cell_plain
from hpgmg_tpu_torch.ops.bc import _wrap_axis
from hpgmg_tpu_torch.ops.bc_fv import _extend_axis_v4, ghost_fill_fv

MODES = {"apply": 0, "residual": 1, "gsrb": 2, "fres": 3}
TWELFTH = 1.0 / 12.0

# Full GSRB sweeps on the Dirichlet levels of one rank with dim <=
# GSRB2_MAX_DIM go through K2c (``fv4_gsrb2``, the cluster kernel) instead
# of two K1 half-sweeps (0: never); it must not exceed GSRB2_CLUSTER_MAX_N.
# K2 (``fv4_gsrb2_cuda``, the streaming kernel) smooths no level: it won at
# no size. Measured on an H100 (700 W) in turns with the tree before K2's
# redesign (bench/stencil_times.py, ms per smoother call of 6 half-sweeps;
# PERF.md), f32 then f64:
#   64^3   the cooperative K2c 0.119-0.197 over 4 runs, its kernels'
#          device time 0.091-0.093; K2 0.158-0.160 (device 0.155-0.156),
#          K1 0.304-0.307; f64 K2c 0.130-0.204 (0.115-0.127), K2
#          0.188-0.189, K1 0.383
#   128^3  K2 0.383-0.384, K1 0.367-0.369; f64 0.7291-0.7292 against
#          0.7296-0.7300 (even)
#   256^3  K2 2.176-2.196, K1 1.979-1.991; f64 4.298-4.300, 4.059-4.065
#   512^3  K2 13.37-13.51, K1 13.20-13.27; f64 29.81-29.82, 28.50-28.73
# K1 wins from 128^3 up in both types, and the cluster K2c takes no level
# above 64^3. The 16^3 and 32^3 levels are the tail's.
GSRB2_MAX_DIM = 64
# K2c's largest n (csrc/fv4_gsrb2_cluster.cu:kGsrb2ClusterMaxN): a block
# holds six padded planes, 222 KB of f64 at 64^3.
GSRB2_CLUSTER_MAX_N = 64

# K1s instead of K1 on the Dirichlet levels with dim <= SUBTILE_MAX_DIM
# (the JAX package's switch, hpgmg_tpu/kernels/stencils.py:870, whose
# default False is a TPU measurement). Measured on an H100 against the
# two-launch K1 that fv4_stream.cu replaced (bench/profile.py --subtile,
# residual per level): K1s won at 16^3-64^3, where launches dominate
# (0.05-0.08 against 0.07-0.15 ms), was even at 128^3 and lost from 256^3
# up (512^3: 3.65-3.73 against 3.26-3.30 ms). Off by default: the fv4 512^3
# chain with K1s up to 64^3 ran 79.4-86.9 ms per solve against 82.7-82.8
# without, no gain beyond its noise.
SUBTILE = False
SUBTILE_MAX_DIM = 64
SUBTILE_MODES = ("apply", "residual", "gsrb")


def use_subtile(level: Level, cfg: SolverConfig) -> bool:
    """Whether the fv4 suite sends ``level``'s applies, residuals and
    half-sweeps to K1s: ``SUBTILE`` on, a Dirichlet level, dim <=
    ``SUBTILE_MAX_DIM``; larger levels and periodic ones take K1 (K7a)."""
    return (SUBTILE and cfg.bc == BC.DIRICHLET
            and level.dim <= SUBTILE_MAX_DIM)


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


def apply_ext_plain(level: Level, xg: torch.Tensor,
                    cfg: SolverConfig) -> torch.Tensor:
    """A x on a block of ni x nj x nk cells from ``xg``, the block with its
    2-deep ghosts on every axis, and ``level``'s face coefficients cut to
    the block (beta_i (ni+1, nj+2, nk+2) and so on, tangentially extended
    by one ghost, as rebuild_operator leaves them: [1:...] on a tangential
    axis is the block and the +-1 shifts stay inside)."""
    ni, nj, nk = (m - 4 for m in xg.shape)

    def sh(di=0, dj=0, dk=0):
        return xg[2 + di:2 + di + ni, 2 + dj:2 + dj + nj, 2 + dk:2 + dk + nk]

    bie, bje, bke = level.beta_i, level.beta_j, level.beta_k

    def bi(f, dj=0, dk=0):
        return bie[f:f + ni, 1 + dj:1 + dj + nj, 1 + dk:1 + dk + nk]

    def bj(f, di=0, dk=0):
        return bje[1 + di:1 + di + ni, f:f + nj, 1 + dk:1 + dk + nk]

    def bk(f, di=0, dj=0):
        return bke[1 + di:1 + di + ni, 1 + dj:1 + dj + nj, f:f + nk]

    ax = -cfg.b * level.h2inv * stencil_ax(sh, bi, bj, bk)
    if cfg.helmholtz:
        ax = cfg.a * level.alpha * sh() + ax
    return ax


def apply_plain(level: Level, x: torch.Tensor,
                cfg: SolverConfig) -> torch.Tensor:
    """A x by ghost fill and shifted slices: the arithmetic of K1's plain
    version. At 512^3 it makes ~25 full-size temporaries, so the solver
    never runs it on the card."""
    return apply_ext_plain(level, ghost_fill_fv(x, cfg.bc, order=4, radius=2), cfg)


def _modes_plain(level: Level, x, cfg: SolverConfig, mode: str, rhs, kdinv,
                 ax=None):
    if ax is None:
        ax = apply_plain(level, x, cfg)
    if mode == "apply":
        return ax
    if mode == "residual":
        return rhs - ax
    if mode == "gsrb":
        return x + kdinv * (rhs - ax)
    return restrict_cell_plain(rhs - ax)


def fv4_stencil_plain(level: Level, x: torch.Tensor, cfg: SolverConfig,
                      mode: str, rhs: Optional[torch.Tensor] = None,
                      kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of K1 (ghost fill, shifted slices)."""
    _check(level, x, cfg, mode, rhs, (kdinv,) if mode == "gsrb" else ())
    fv4_stencil_plain.calls += 1
    return _modes_plain(level, x, cfg, mode, rhs, kdinv)


fv4_stencil_plain.calls = 0


def _check_subtile(level: Level, x, cfg: SolverConfig, mode: str, rhs, kdinv):
    if mode not in SUBTILE_MODES:
        raise ValueError(f"the sub-tiled fv4 stencil (K1s) has no mode {mode!r}")
    check_dirichlet(cfg, "the sub-tiled fv4 stencil (K1s)")
    _check(level, x, cfg, mode, rhs, (kdinv,) if mode == "gsrb" else ())


def fv4_subtile_plain(level: Level, x: torch.Tensor, cfg: SolverConfig,
                      mode: str, rhs: Optional[torch.Tensor] = None,
                      kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of K1s: K1's plain arithmetic in K1s's modes
    (apply, residual, gsrb), Dirichlet levels only."""
    _check_subtile(level, x, cfg, mode, rhs, kdinv)
    fv4_subtile_plain.calls += 1
    return _modes_plain(level, x, cfg, mode, rhs, kdinv)


fv4_subtile_plain.calls = 0


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

def fv4_subtile_cuda(level: Level, x: torch.Tensor, cfg: SolverConfig,
                     mode: str, rhs: Optional[torch.Tensor] = None,
                     kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1s (one pass, ghosts in the kernel) on CUDA tensors into a
    newly allocated output. It takes any Dirichlet level with n >= 4; the
    suite's gate (``use_subtile``) only chooses which levels it gets."""
    from hpgmg_tpu_torch.kernels.build import library

    _check_subtile(level, x, cfg, mode, rhs, kdinv)
    if not x.is_cuda:
        raise ValueError(f"fv4_subtile_cuda wants CUDA tensors, got {x.device}")
    n = level.dim
    out = torch.empty((n, n, n), dtype=x.dtype, device=x.device)
    alpha = level.alpha if cfg.helmholtz else None
    dt = "f32" if x.dtype == torch.float32 else "f64"
    with torch.cuda.device(x.device):
        rc = getattr(library(), f"hpgmg_fv4_subtile_{dt}")(
            x.data_ptr(), level.beta_i.data_ptr(), level.beta_j.data_ptr(),
            level.beta_k.data_ptr(), _ptr(alpha), _ptr(rhs), _ptr(kdinv),
            out.data_ptr(), n, MODES[mode], -cfg.b * level.h2inv, float(cfg.a),
            _stream(x))
    if rc != 0:
        raise RuntimeError(f"fv4_subtile kernel launch failed: CUDA error {rc}")
    fv4_subtile_cuda.launches += 1
    return out


fv4_subtile_cuda.launches = 0


def fv4_stencil_cuda(level: Level, x: torch.Tensor, cfg: SolverConfig,
                     mode: str, rhs: Optional[torch.Tensor] = None,
                     kdinv: Optional[torch.Tensor] = None,
                     parity: Optional[int] = None, chunk: int = 0) -> torch.Tensor:
    """Launch K1 (Dirichlet) or K7a (periodic), ``csrc/fv4_stream.cu``: one
    launch on CUDA tensors into a newly allocated output, no ghost buffer.
    gsrb needs ``parity``, the colour that ``kdinv`` carries: the kernel
    computes A x at that colour's cells only and copies x at the others.
    ``chunk``: i-planes a block marches (0: the launcher's rule, as the
    solver calls it; other values time the rule). The launches of K1 count
    in ``launches``, those of K7a in ``periodic_launches``."""
    from hpgmg_tpu_torch.kernels.build import library

    _check(level, x, cfg, mode, rhs, (kdinv,) if mode == "gsrb" else ())
    if not x.is_cuda:
        raise ValueError(f"fv4_stencil_cuda wants CUDA tensors, got {x.device}")
    if mode == "gsrb" and parity not in (0, 1):
        raise ValueError(f"fv4 gsrb needs the sweep's parity (0 or 1), got {parity!r}")
    n = level.dim
    m = n // 2 if mode == "fres" else n
    out = torch.empty((m, m, m), dtype=x.dtype, device=x.device)
    alpha = level.alpha if cfg.helmholtz else None
    periodic = cfg.bc == BC.PERIODIC
    dt = "f32" if x.dtype == torch.float32 else "f64"
    with torch.cuda.device(x.device):
        rc = getattr(library(), f"hpgmg_fv4_stream_{dt}")(
            x.data_ptr(), level.beta_i.data_ptr(), level.beta_j.data_ptr(),
            level.beta_k.data_ptr(), _ptr(alpha), _ptr(rhs), _ptr(kdinv),
            out.data_ptr(), n, MODES[mode], int(periodic), parity or 0, chunk,
            -cfg.b * level.h2inv, float(cfg.a), _stream(x))
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
                   cfg: SolverConfig, chunk: int = 0) -> torch.Tensor:
    """Launch K2 (one full red+black sweep, ``csrc/fv4_gsrb2.cu``) into a
    newly allocated output: one ordinary launch, no scratch; ``kdinv[0]``
    is read at the red cells, ``kdinv[1]`` at the black ones. ``chunk``:
    i-planes a block marches (0: the launcher's rule, as the solver calls
    it; other values time the rule)."""
    from hpgmg_tpu_torch.kernels.build import library

    check_dirichlet(cfg, "the fused fv4 sweep (K2)")
    _check(level, x, cfg, "gsrb", rhs, level.kdinv or (None, None))
    if not x.is_cuda:
        raise ValueError(f"fv4_gsrb2_cuda wants CUDA tensors, got {x.device}")
    kd0, kd1 = level.kdinv
    n = level.dim
    out = torch.empty_like(x)
    alpha = level.alpha if cfg.helmholtz else None
    dt = "f32" if x.dtype == torch.float32 else "f64"
    with torch.cuda.device(x.device):
        rc = getattr(library(), f"hpgmg_fv4_gsrb2_{dt}")(
            x.data_ptr(), level.beta_i.data_ptr(), level.beta_j.data_ptr(),
            level.beta_k.data_ptr(), _ptr(alpha), rhs.data_ptr(), kd0.data_ptr(),
            kd1.data_ptr(), out.data_ptr(), n, chunk, -cfg.b * level.h2inv,
            float(cfg.a), _stream(x))
    if rc != 0:
        raise RuntimeError(f"fv4 gsrb2 kernel launch failed: CUDA error {rc}")
    fv4_gsrb2_cuda.launches += 1
    return out


fv4_gsrb2_cuda.launches = 0


def cluster_error(rc: int, what: str, smem: int) -> RuntimeError:
    """The error of a refused cluster launch (csrc/cluster.cuh:cluster_launch
    returns -2 when the card cannot hold one of the kernel's clusters)."""
    if rc == -2:
        return RuntimeError(f"{what}: the card cannot schedule its cluster with "
                            f"{smem} bytes of shared memory a block")
    return RuntimeError(f"{what} launch failed: CUDA error {rc}")


def gsrb2_cluster_smem(n: int, itemsize: int) -> int:
    """Bytes of shared memory a K2c block takes at n^3: six planes of
    (n+4)^2 values, each rounded up to 4 values."""
    return 6 * ((((n + 4) ** 2) + 3) & ~3) * itemsize


def _gsrb2_plan(level: Level, cfg: SolverConfig) -> SimpleNamespace:
    """K2c's unchanging operands on ``level``, checked (checking the
    level's seven arrays on every call cost about as much host time as
    the 64^3 sweep's device time)."""
    check_dirichlet(cfg, "the fused fv4 sweep (K2c)")
    if level.kdinv is None:
        raise ValueError(f"K2c needs the {level.dim}^3 level's kdinv pair")
    _check(level, level.kdinv[0], cfg, "gsrb", level.kdinv[0], level.kdinv)
    n = level.dim
    if n > GSRB2_CLUSTER_MAX_N:
        raise ValueError(f"K2c takes n <= {GSRB2_CLUSTER_MAX_N}, got {n}")
    alpha = level.alpha if cfg.helmholtz else None
    return SimpleNamespace(
        cfg=cfg, smem=gsrb2_cluster_smem(n, level.kdinv[0].element_size()),
        name=f"hpgmg_fv4_gsrb2_cluster_{'f32' if level.dtype == torch.float32 else 'f64'}",
        coefs=(level.beta_i.data_ptr(), level.beta_j.data_ptr(), level.beta_k.data_ptr(),
               _ptr(alpha)),
        kd=(level.kdinv[0].data_ptr(), level.kdinv[1].data_ptr()),
        scalars=(n, -cfg.b * level.h2inv, float(cfg.a)))


def fv4_gsrb2_cluster_cuda(level: Level, x: torch.Tensor, rhs: torch.Tensor,
                           cfg: SolverConfig) -> torch.Tensor:
    """Launch K2c (K2's full sweep in one launch of thread-block clusters,
    ``csrc/fv4_gsrb2_cluster.cu``) into a newly allocated output; no
    scratch. Raises on n > ``GSRB2_CLUSTER_MAX_N`` and on a cluster the
    card cannot schedule."""
    from hpgmg_tpu_torch.kernels.build import library

    plan = level.plan(("k2c", id(cfg)), lambda: _gsrb2_plan(level, cfg))
    probe = level.kdinv[0]
    for name, t in (("x", x), ("rhs", rhs)):
        if t is None or t.shape != probe.shape or t.dtype != probe.dtype \
                or t.device != probe.device or not t.is_contiguous():
            raise ValueError(f"K2c wants {name} contiguous, {tuple(probe.shape)} "
                             f"{probe.dtype} on {probe.device}")
    if not x.is_cuda:
        raise ValueError(f"fv4_gsrb2_cluster_cuda wants CUDA tensors, got {x.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = getattr(library(), plan.name)(x.data_ptr(), *plan.coefs, rhs.data_ptr(),
                                           *plan.kd, out.data_ptr(), *plan.scalars,
                                           _stream(x))
    if rc != 0:
        raise cluster_error(rc, "the fv4 gsrb2 cluster kernel (K2c)", plan.smem)
    fv4_gsrb2_cluster_cuda.launches += 1
    return out


fv4_gsrb2_cluster_cuda.launches = 0


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------

def fv4_stencil(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
                rhs: Optional[torch.Tensor] = None,
                kdinv: Optional[torch.Tensor] = None,
                parity: Optional[int] = None) -> torch.Tensor:
    """K1 (K7a on a periodic level) on ``level``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. A gsrb half-sweep on the
    card needs ``parity``, the colour ``kdinv`` carries; the plain version
    reads the colour from kdinv alone."""
    if x.is_cuda:
        return fv4_stencil_cuda(level, x, cfg, mode, rhs, kdinv, parity)
    if x.device.type == "cpu":
        return fv4_stencil_plain(level, x, cfg, mode, rhs, kdinv)
    raise ValueError(f"fv4 stencil has no kernel for device {x.device}")


def fv4_subtile(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
                rhs: Optional[torch.Tensor] = None,
                kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1s on ``level``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return fv4_subtile_cuda(level, x, cfg, mode, rhs, kdinv)
    if x.device.type == "cpu":
        return fv4_subtile_plain(level, x, cfg, mode, rhs, kdinv)
    raise ValueError(f"fv4 subtile has no kernel for device {x.device}")


def fv4_gsrb2(level: Level, x: torch.Tensor, rhs: torch.Tensor,
              cfg: SolverConfig) -> torch.Tensor:
    """One full GSRB sweep (parity 0, then 1) on ``level`` with the
    level's ``kdinv`` pair: K2c for CUDA tensors, the plain version for
    CPU tensors."""
    if x.is_cuda:
        return fv4_gsrb2_cluster_cuda(level, x, rhs, cfg)
    if x.device.type == "cpu":
        return fv4_gsrb2_plain(level, x, rhs, cfg)
    raise ValueError(f"fv4 gsrb2 has no kernel for device {x.device}")


# ---------------------------------------------------------------------------
# K8a, K8b: the stencil on one rank's local block of a decomposed level
# ---------------------------------------------------------------------------

SLAB_MODES = ("apply", "residual", "gsrb")

# K8a's column tile along j (csrc/fv4_slab.cu TJ): K8b's interior pass
# takes the column tiles 1 .. ntj-2 in j, whose halo rows lie in the block
SLAB_TJ = 16


def v4_slab(src: torch.Tensor, axis: int, lo: bool) -> torch.Tensor:
    """The 2-deep quartic Dirichlet ghost slab of ``src`` along ``axis``
    (apply_BCs_v4, boundary_fv.c:334-341), in ascending index order: the
    low side's [far, near], the high side's [near, far]."""
    m = src.shape[axis]
    x1, x2, x3, x4 = (src.narrow(axis, i if lo else m - 1 - i, 1) for i in range(4))
    near = TWELFTH * (-77.0 * x1 + 43.0 * x2 - 17.0 * x3 + 3.0 * x4)
    far = TWELFTH * (-505.0 * x1 + 335.0 * x2 - 145.0 * x3 + 27.0 * x4)
    return torch.cat([far, near] if lo else [near, far], dim=axis)


def build_slabs(x: torch.Tensor, depth: int, width: int, ghost, exchange):
    """The four halo slabs of the local block ``x`` (ni, nj, nk), ``depth``
    cells deep: ilo, ihi (depth, nj, nk) first, by ``exchange(0, lo_face,
    hi_face)``, then jlo, jhi (ni + 2 depth, depth, nk), the i-extended
    strips, by ``exchange(1, ...)``, so the (i, j) edge ghosts arrive in
    the i-then-j order of the separable fills. ``exchange`` returns the
    neighbours' faces, None on a side that has none (a Dirichlet domain
    face); there the slab is ``ghost(src, axis, lo)`` of the ``width``
    cells nearest the face."""
    ni, nj = x.shape[0], x.shape[1]
    ilo, ihi = exchange(0, x[:depth], x[ni - depth:])
    ilo = ghost(x[:width], 0, True) if ilo is None else ilo
    ihi = ghost(x[ni - width:], 0, False) if ihi is None else ihi

    def strip(j0, j1):
        return torch.cat([ilo[:, j0:j1], x[:, j0:j1], ihi[:, j0:j1]], dim=0)

    jlo, jhi = exchange(1, strip(0, depth), strip(nj - depth, nj))
    jlo = ghost(strip(0, width), 1, True) if jlo is None else jlo
    jhi = ghost(strip(nj - width, nj), 1, False) if jhi is None else jhi
    return tuple(t.contiguous() for t in (ilo, ihi, jlo, jhi))


def local_exchange(bc: BC):
    """The ``exchange`` of ``build_slabs`` for a block that is the whole
    domain in i and j: the periodic wrap, or no neighbour."""
    def exchange(axis, lo_face, hi_face):
        return (hi_face, lo_face) if bc == BC.PERIODIC else (None, None)
    return exchange


def single_chip_slabs(x: torch.Tensor, bc: BC):
    """K8a's slabs for one block that is the whole domain (counterpart of
    hpgmg_tpu/kernels/stencils.py:single_chip_slabs, without its j padding
    to 8 rows): the quartic Dirichlet fill, or the wrap."""
    return build_slabs(x, 2, 4, v4_slab, local_exchange(bc))


def extend_slabs(x: torch.Tensor, slabs) -> torch.Tensor:
    """(ni, nj, nk) block + its four d-deep slabs -> the (ni+2d, nj+2d, nk)
    block with its i and j ghosts (the jlo/jhi strips are i-extended)."""
    ilo, ihi, jlo, jhi = slabs
    return torch.cat([jlo, torch.cat([ilo, x, ihi], dim=0), jhi], dim=1)


def extend_for_kernel(x: torch.Tensor, slabs, bc: BC) -> torch.Tensor:
    """The (ni+4, nj+4, nk+4) extended block K8a's plain version applies
    the stencil to: the slabs in i and j, then the k ghosts of the result
    (quartic Dirichlet, or wrapped; k is never split)."""
    xe = extend_slabs(x, slabs)
    if bc == BC.PERIODIC:
        return _wrap_axis(xe, 2, 2)
    return _extend_axis_v4(xe, 2, 2)


def overlap_grid_shape(ni: int, nj: int):
    """(ni, ntj): the block's i-planes and K8a's column tiles along j, where
    K8b's split applies: at least 3 column tiles (the interior pass takes
    the inner ones) and 6 planes (it takes planes 2 .. ni-3); else None
    (counterpart of stencils.py:overlap_grid_shape)."""
    ntj = -(-nj // SLAB_TJ)
    return (ni, ntj) if ntj >= 3 and ni >= 6 else None


def _check_slab(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                mode: str, rhs, kdinv, overlap: bool = False):
    """Validate everything K8a/K8b read; raise on what they do not take."""
    if mode not in SLAB_MODES:
        raise ValueError(f"the fv4 slab kernel has no mode {mode!r}")
    if cfg.bc not in (BC.DIRICHLET, BC.PERIODIC):
        raise NotImplementedError(f"the fv4 slab kernel does not take {cfg.bc}")
    if x.dim() != 3:
        raise ValueError(f"x must be a 3-D block, got {tuple(x.shape)}")
    ni, nj, nk = x.shape
    if min(ni, nj, nk) < 4 or ni % 2 or nj % 2 or nk % 2:
        raise ValueError(f"the fv4 slab kernel takes even ni, nj, nk >= 4, "
                         f"got {tuple(x.shape)}")
    if overlap and overlap_grid_shape(ni, nj) is None:
        raise ValueError(f"K8b needs >= 3 column tiles of {SLAB_TJ} along j and >= 6 "
                         f"i-planes, got {ni} x {nj}")
    blk, dt = (ni, nj, nk), level.dtype
    need = {"x": (x, blk),
            "beta_i": (level.beta_i, (ni + 1, nj + 2, nk + 2)),
            "beta_j": (level.beta_j, (ni + 2, nj + 1, nk + 2)),
            "beta_k": (level.beta_k, (ni + 2, nj + 2, nk + 1))}
    if slabs is not None:
        for name, t, shape in zip(("ilo", "ihi", "jlo", "jhi"), slabs,
                                  ((2, nj, nk),) * 2 + ((ni + 4, 2, nk),) * 2):
            need[name] = (t, shape)
    if mode != "apply":
        need["rhs"] = (rhs, blk)
    if mode == "gsrb":
        need["kdinv"] = (kdinv, blk)
    if cfg.helmholtz:
        need["alpha"] = (level.alpha, blk)
    for name, (t, shape) in need.items():
        if t is None:
            raise ValueError(f"fv4 slab kernel mode {mode!r} needs {name}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != dt or dt not in (torch.float32, torch.float64):
            raise TypeError(f"{name} is {t.dtype}; the level is {dt}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fv4_slab_plain(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                   mode: str, rhs: Optional[torch.Tensor] = None,
                   kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of K8a: the extended block assembled from x and the
    slabs (``extend_for_kernel``), then K1's plain arithmetic."""
    _check_slab(level, x, slabs, cfg, mode, rhs, kdinv)
    fv4_slab_plain.calls += 1
    return _slab_modes_plain(level, x, slabs, cfg, mode, rhs, kdinv)


def _slab_modes_plain(level: Level, x, slabs, cfg: SolverConfig, mode: str, rhs,
                      kdinv):
    ax = apply_ext_plain(level, extend_for_kernel(x, slabs, cfg.bc), cfg)
    return _modes_plain(level, x, cfg, mode, rhs, kdinv, ax=ax)


fv4_slab_plain.calls = 0


def _interior_region(x: torch.Tensor):
    """K8b's interior part as (i0, i1, j0, j1): the i-planes 2 .. ni-3 of
    the column tiles 1 .. ntj-2 along j, whose stencils read the block
    alone (nj is even, so the last column tile holds >= 2 rows)."""
    ni, ntj = overlap_grid_shape(x.shape[0], x.shape[1])
    return 2, ni - 2, SLAB_TJ, (ntj - 1) * SLAB_TJ


def fv4_overlap_interior_plain(level: Level, x: torch.Tensor, cfg: SolverConfig,
                               mode: str, rhs: Optional[torch.Tensor] = None,
                               kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of K8b's interior pass: the interior part of the
    output (``_interior_region``) from the block alone (no slab); zeros
    elsewhere."""
    _check_slab(level, x, None, cfg, mode, rhs, kdinv, overlap=True)
    fv4_overlap_interior_plain.calls += 1
    i0, i1, j0, j1 = _interior_region(x)
    sub = x[i0 - 2:i1 + 2, j0 - 2:j1 + 2]
    xe = _wrap_axis(sub, 2, 2) if cfg.bc == BC.PERIODIC else _extend_axis_v4(sub, 2, 2)
    # the fields the plain stencil reads, cut to the interior part (the
    # face arrays with their tangential margins)
    cut = SimpleNamespace(h2inv=level.h2inv, beta_i=level.beta_i[i0:i1 + 1, j0:j1 + 2],
                          beta_j=level.beta_j[i0:i1 + 2, j0:j1 + 1],
                          beta_k=level.beta_k[i0:i1 + 2, j0:j1 + 2],
                          alpha=None if level.alpha is None else level.alpha[i0:i1, j0:j1])
    ax = apply_ext_plain(cut, xe, cfg)
    part = (slice(i0, i1), slice(j0, j1))
    out = torch.zeros_like(x)
    out[part] = _modes_plain(cut, x[part], cfg, mode,
                             None if rhs is None else rhs[part],
                             None if kdinv is None else kdinv[part], ax=ax)
    return out


fv4_overlap_interior_plain.calls = 0


def fv4_overlap_edge_plain(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                           mode: str, out: torch.Tensor,
                           rhs: Optional[torch.Tensor] = None,
                           kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of K8b's edge pass: ``out`` (the interior pass's
    result) with every cell outside the interior part set from K8a's plain
    version; returns ``out``."""
    _check_slab(level, x, slabs, cfg, mode, rhs, kdinv, overlap=True)
    fv4_overlap_edge_plain.calls += 1
    full = _slab_modes_plain(level, x, slabs, cfg, mode, rhs, kdinv)
    i0, i1, j0, j1 = _interior_region(x)
    keep = out[i0:i1, j0:j1].clone()
    out.copy_(full)
    out[i0:i1, j0:j1] = keep
    return out


fv4_overlap_edge_plain.calls = 0


# K8a's and K8b's launches by pass, mode and local block shape, keyed
# "<pass> <mode> (ni, nj, nk)", and K8d's (stencils_r1.r1_gsrb2_slab_cuda),
# keyed "K8d sweep (ni, nj, nk)" (bench/weak.py reads them for the counted
# F-cycle)
SLAB_PASSES = ("K8a", "K8b interior", "K8b edge")
slab_launches_by_block = {}


def _launch_slab(level: Level, x, slabs, cfg: SolverConfig, mode: str, rhs,
                 kdinv, out, pass_: int, parity: Optional[int], chunk: int):
    from hpgmg_tpu_torch.kernels.build import library

    if mode == "gsrb" and parity not in (0, 1):
        raise ValueError(f"the fv4 slab gsrb needs the sweep's parity (0 or 1), "
                         f"got {parity!r}")
    if chunk < 0:
        raise ValueError(f"chunk must be >= 0 (0: the launcher's rule), got {chunk}")
    ni, nj, nk = x.shape
    alpha = level.alpha if cfg.helmholtz else None
    ilo, ihi, jlo, jhi = slabs if slabs is not None else (None,) * 4
    dt = "f32" if x.dtype == torch.float32 else "f64"
    with torch.cuda.device(x.device):
        rc = getattr(library(), f"hpgmg_fv4_slab_{dt}")(
            x.data_ptr(), _ptr(ilo), _ptr(ihi), _ptr(jlo), _ptr(jhi),
            level.beta_i.data_ptr(), level.beta_j.data_ptr(), level.beta_k.data_ptr(),
            _ptr(alpha), _ptr(rhs), _ptr(kdinv), out.data_ptr(), ni, nj, nk,
            MODES[mode], int(cfg.bc == BC.PERIODIC), parity or 0, chunk,
            -cfg.b * level.h2inv, float(cfg.a), pass_, _stream(x))
    if rc != 0:
        raise RuntimeError(f"fv4 slab kernel launch failed: CUDA error {rc}")
    key = f"{SLAB_PASSES[pass_]} {mode} {tuple(x.shape)}"
    slab_launches_by_block[key] = slab_launches_by_block.get(key, 0) + 1
    return out


def _cuda_only(x: torch.Tensor, what: str):
    if not x.is_cuda:
        raise ValueError(f"{what} wants CUDA tensors, got {x.device}")


def fv4_slab_cuda(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                  mode: str, rhs: Optional[torch.Tensor] = None,
                  kdinv: Optional[torch.Tensor] = None, parity: Optional[int] = None,
                  chunk: int = 0) -> torch.Tensor:
    """Launch K8a (``csrc/fv4_slab.cu``, one streaming launch) on CUDA
    tensors into a newly allocated output. gsrb needs ``parity``, the
    colour ``kdinv`` carries: the kernel computes A x at that colour's
    cells only and copies x at the others. ``chunk``: i-planes a block
    marches (0: the launcher's rule, as the solver calls it)."""
    _check_slab(level, x, slabs, cfg, mode, rhs, kdinv)
    _cuda_only(x, "fv4_slab_cuda")
    out = _launch_slab(level, x, slabs, cfg, mode, rhs, kdinv, torch.empty_like(x), 0,
                       parity, chunk)
    fv4_slab_cuda.launches += 1
    return out


fv4_slab_cuda.launches = 0


def fv4_overlap_interior_cuda(level: Level, x: torch.Tensor, cfg: SolverConfig,
                              mode: str, rhs: Optional[torch.Tensor] = None,
                              kdinv: Optional[torch.Tensor] = None,
                              parity: Optional[int] = None, chunk: int = 0) -> torch.Tensor:
    """Launch K8b's interior pass into a newly allocated output (the rest
    is left for ``fv4_overlap_edge_cuda``)."""
    _check_slab(level, x, None, cfg, mode, rhs, kdinv, overlap=True)
    _cuda_only(x, "fv4_overlap_interior_cuda")
    out = _launch_slab(level, x, None, cfg, mode, rhs, kdinv, torch.empty_like(x), 1,
                       parity, chunk)
    fv4_overlap_interior_cuda.launches += 1
    return out


fv4_overlap_interior_cuda.launches = 0


def fv4_overlap_edge_cuda(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                          mode: str, out: torch.Tensor,
                          rhs: Optional[torch.Tensor] = None,
                          kdinv: Optional[torch.Tensor] = None,
                          parity: Optional[int] = None, chunk: int = 0) -> torch.Tensor:
    """Launch K8b's edge pass, writing the rest of ``out``."""
    _check_slab(level, x, slabs, cfg, mode, rhs, kdinv, overlap=True)
    _cuda_only(x, "fv4_overlap_edge_cuda")
    if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device \
            or not out.is_contiguous():
        raise ValueError("out must be the interior pass's output")
    _launch_slab(level, x, slabs, cfg, mode, rhs, kdinv, out, 2, parity, chunk)
    fv4_overlap_edge_cuda.launches += 1
    return out


fv4_overlap_edge_cuda.launches = 0


def fv4_slab(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig, mode: str,
             rhs: Optional[torch.Tensor] = None,
             kdinv: Optional[torch.Tensor] = None,
             parity: Optional[int] = None) -> torch.Tensor:
    """K8a on a local block: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. A gsrb half-sweep on the card needs
    ``parity``, the colour ``kdinv`` carries; the plain version reads the
    colour from kdinv alone."""
    if x.is_cuda:
        return fv4_slab_cuda(level, x, slabs, cfg, mode, rhs, kdinv, parity)
    if x.device.type == "cpu":
        return fv4_slab_plain(level, x, slabs, cfg, mode, rhs, kdinv)
    raise ValueError(f"fv4 slab kernel has no kernel for device {x.device}")


def fv4_overlap_interior(level: Level, x: torch.Tensor, cfg: SolverConfig,
                         mode: str, rhs: Optional[torch.Tensor] = None,
                         kdinv: Optional[torch.Tensor] = None,
                         parity: Optional[int] = None) -> torch.Tensor:
    """K8b's interior pass (no slab read; queued before the exchange)."""
    if x.is_cuda:
        return fv4_overlap_interior_cuda(level, x, cfg, mode, rhs, kdinv, parity)
    if x.device.type == "cpu":
        return fv4_overlap_interior_plain(level, x, cfg, mode, rhs, kdinv)
    raise ValueError(f"fv4 overlap has no kernel for device {x.device}")


def fv4_overlap_edge(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                     mode: str, out: torch.Tensor,
                     rhs: Optional[torch.Tensor] = None,
                     kdinv: Optional[torch.Tensor] = None,
                     parity: Optional[int] = None) -> torch.Tensor:
    """K8b's edge pass into the interior pass's ``out``."""
    if x.is_cuda:
        return fv4_overlap_edge_cuda(level, x, slabs, cfg, mode, out, rhs, kdinv, parity)
    if x.device.type == "cpu":
        return fv4_overlap_edge_plain(level, x, slabs, cfg, mode, out, rhs, kdinv)
    raise ValueError(f"fv4 overlap has no kernel for device {x.device}")


def fv4_overlap(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig, mode: str,
                rhs: Optional[torch.Tensor] = None,
                kdinv: Optional[torch.Tensor] = None,
                parity: Optional[int] = None) -> torch.Tensor:
    """K8b, both passes in order: equal to K8a bit for bit."""
    out = fv4_overlap_interior(level, x, cfg, mode, rhs, kdinv, parity)
    return fv4_overlap_edge(level, x, slabs, cfg, mode, out, rhs, kdinv, parity)
