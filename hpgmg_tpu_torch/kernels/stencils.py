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
on a Dirichlet level (``csrc/fv4_subtile.cu``): short tiles along i, each
staged once into shared memory with its halo, its face coefficients and
its cells' operands, its ghosts made there, a gsrb half-sweep at its
``parity``'s cells only; it has no fres mode and refuses periodic levels.
The fv4 suite routes a level to it where ``use_subtile`` admits it
(``SUBTILE`` on, Dirichlet, dim <= ``SUBTILE_MAX_DIM``).

K1 (K7a), K1s, K2c and the slab kernels K8a/K8b take float32, float64
and bfloat16 levels: a bf16 level's kernels widen every operand to
float32 after its load and round each output to bf16 once
(``csrc/storage.cuh``), and the plain versions compute alike
(``compute_dtype``, ``widened``). K1 also takes a float32
gsrb with bf16 face arrays and kdinv (BF16C: ``kernel_views_bf16``,
``bf16c_view``).
No kernel takes a level below 4^3: the suite computes it by the plain
version on every device (``small_level``, ``fv4_small``).
"""

from __future__ import annotations

import dataclasses
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
# default False is a TPU measurement). Measured on an H100 (700 W) in turns
# with the tree before K1s's one-pass redesign (bench/stencil_times.py
# --subtile, device ms a call, f32 gsrb; PERF.md): K1s 0.0081 (16^3),
# 0.0090 (32^3), 0.0123-0.0124 (64^3), 0.0508-0.0514 (128^3), 0.3221-0.3224
# (256^3) against K1's 0.0654-0.0659, 0.0497-0.0501, 0.0495-0.0500,
# 0.0594-0.0601, 0.3291-0.3351; at 512^3 2.4499-2.4519 against
# 2.1631-2.2044. K1s wins every mode at every level up to 256^3 in f32 and
# f64 and loses every f32 mode at 512^3, so the gate is 256. On by
# default: the fv4 512^3 f32 chain ran 55.1306 and 55.6721 ms a solve with
# it against 56.0246 and 56.4585 without (bench/profile.py --subtile, in
# turns on, off, off, on).
SUBTILE = True
SUBTILE_MAX_DIM = 256
SUBTILE_MODES = ("apply", "residual", "gsrb")
# K1s's longest tile along i (csrc/fv4_subtile.cu:kMaxTI)
SUBTILE_MAX_TI = 8


def use_subtile(level: Level, cfg: SolverConfig) -> bool:
    """Whether the fv4 suite sends ``level``'s applies, residuals and
    half-sweeps to K1s: ``SUBTILE`` on, a Dirichlet level, dim <=
    ``SUBTILE_MAX_DIM``; larger levels and periodic ones take K1 (K7a)."""
    return (SUBTILE and cfg.bc == BC.DIRICHLET
            and level.dim <= SUBTILE_MAX_DIM)


# the storage types the fv4 kernels take, by the suffix of their C entries
DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def dtype_suffix(dtype: torch.dtype, what: str, allowed=tuple(DTYPES)) -> str:
    """The C entries' suffix of ``dtype``; raise where ``what`` has no
    instantiation for it."""
    if dtype not in allowed:
        raise TypeError(f"{what} takes {', '.join(map(str, allowed))}, got {dtype}")
    return DTYPES[dtype]


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the kernels and their plain versions compute in: float64
    for float64, float32 for float32 and bfloat16 (a bf16 operand is
    widened after its load, each output rounded to bf16 once)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def small_level(level: Level) -> bool:
    """Whether the fv4 suite computes ``level`` by the plain version on
    every device (``fv4_small``): a level below 4^3, where the quartic
    Dirichlet ghosts fall back to the quadratic ones (ops/bc_fv.py, as the
    JAX package's XLA ops do there; its Pallas kernels take no level below
    32^3). No kernel takes such a level."""
    return level.dim < 4


def check_kernel_dim(level: Level, what: str):
    """Raise on a level the fv4 kernels do not take (``small_level``)."""
    if small_level(level):
        raise ValueError(f"{what} takes n >= 4, got n={level.dim}: the fv4 suite "
                         f"computes such a level by its plain version (fv4_small)")


# BF16C: bfloat16 copies of the coefficient streams a K1 gsrb half-sweep
# of a float32 solve reads (the three face arrays and the parity-folded
# kdinv pair, ``Level.kb16``), widened to float32 after their loads; the
# apply, residual and fres modes keep the float32 arrays, which set the
# discretization (the JAX package's switch,
# hpgmg_tpu/kernels/stencils.py:336-376). Four of the gsrb's seven n^3
# streams are coefficients, so the half-sweep's bytes fall from 28 to 20
# a cell; but K1 is not held by its bytes. Measured on an H100 80GB HBM3
# at 700 W (chip_smoke.py phase 18, bench/stencil_times.py --bf16c; device
# ms in turns with the float32 K1 gsrb): 128^3 0.0735 against 0.0559,
# 256^3 0.4502-0.4513 against 0.3030-0.3058, 512^3 3.0149-3.0225 against
# 2.0296-2.0321: BF16C wins at no size, and the 512^3 float32 F-cycle with
# it on ends at rel_residual 8.1e-2, 81x the fv4 limit (the smoother's
# fixed point is the bf16-rounded operator's solution). So it stays off,
# as in the JAX package, and BF16C_MIN_DIM is the smallest level K1
# smooths under SUBTILE (the levels K1s takes have no BF16C path).
BF16C = False
BF16C_MIN_DIM = 512


def bf16c_active(dim: int, dtype: torch.dtype, bc: BC = BC.DIRICHLET) -> bool:
    """Whether a level of ``dim`` gets the BF16C views at build time: the
    flag on, a float32 solve, Dirichlet BCs, dim >= ``BF16C_MIN_DIM``, and a
    level K1 smooths (K1s, which takes the levels ``use_subtile`` admits,
    has no BF16C path, as the JAX package's K1s has none). A hierarchy cut
    for a process grid drops them (parallel/mesh.py)."""
    return (BF16C and dtype == torch.float32 and bc == BC.DIRICHLET
            and dim >= BF16C_MIN_DIM and not (SUBTILE and dim <= SUBTILE_MAX_DIM))


def kernel_views_bf16(level: Level, kdinv) -> tuple:
    """The BF16C views of ``level``: bfloat16 copies of its tangentially
    extended beta_i, beta_j, beta_k and of the parity-folded ``kdinv``
    pair, in that order; the port's own layout (no j padding)."""
    return tuple(t.to(torch.bfloat16).contiguous()
                 for t in (level.beta_i, level.beta_j, level.beta_k, *kdinv))


def bf16c_view(level: Level) -> Level:
    """``level`` with its BF16C face coefficients in place of the float32
    ones: the level a BF16C gsrb half-sweep reads (its kdinv is
    ``level.kb16[3 + parity]``)."""
    bi, bj, bk = level.kb16[:3]
    return dataclasses.replace(level, beta_i=bi, beta_j=bj, beta_k=bk)


def _check(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
           rhs: Optional[torch.Tensor], kdinv=()):
    """Validate everything the kernels read; raise on what they do not
    take. ``kdinv`` holds the dinv operands the mode reads. x, rhs and
    alpha are of one type, the face coefficients and kdinv of the level's
    (``level.dtype``): the same type, or bf16 coefficients under a float32
    x in a gsrb (K1's BF16C smoother streams, ``kernel_views_bf16``)."""
    if mode not in MODES:
        raise ValueError(f"unknown fv4 stencil mode {mode!r}")
    if cfg.bc not in (BC.DIRICHLET, BC.PERIODIC):
        raise NotImplementedError(f"the fv4 stencil does not take {cfg.bc}")
    n = level.dim
    if mode == "fres" and n % 2:
        raise ValueError(f"fv4 stencil mode {mode!r} cannot take n={n}")
    cube, dt, ct = (n, n, n), x.dtype, level.dtype
    if dt not in DTYPES:
        raise TypeError(f"x is {dt}; the fv4 stencil takes {', '.join(map(str, DTYPES))}")
    if ct != dt and not (mode == "gsrb" and dt == torch.float32 and ct == torch.bfloat16):
        raise TypeError(f"the level's coefficients are {ct}, x is {dt}: only a "
                        f"float32 gsrb takes bfloat16 coefficients (BF16C)")
    need = {"x": (x, cube, dt),
            "beta_i": (level.beta_i, (n + 1, n + 2, n + 2), ct),
            "beta_j": (level.beta_j, (n + 2, n + 1, n + 2), ct),
            "beta_k": (level.beta_k, (n + 2, n + 2, n + 1), ct)}
    if mode != "apply":
        need["rhs"] = (rhs, cube, dt)
    for p, kd in enumerate(kdinv):
        need["kdinv" if len(kdinv) == 1 else f"kdinv[{p}]"] = (kd, cube, ct)
    if cfg.helmholtz:
        need["alpha"] = (level.alpha, cube, dt)
    for name, (t, shape, want) in need.items():
        if t is None:
            raise ValueError(f"fv4 stencil mode {mode!r} needs {name}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}; want {want}")
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


def count_launch(fn, periodic: bool, dt: str):
    """One more launch of the wrapper ``fn``, counted under its BC and
    storage type: ``launches``, ``periodic_launches``, ``bf16_launches`` or
    ``periodic_bf16_launches``."""
    attr = ("periodic_" if periodic else "") + ("bf16_" if dt == "bf16" else "") + "launches"
    setattr(fn, attr, getattr(fn, attr) + 1)


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


def widened(level: Level, dtype: torch.dtype) -> Level:
    """``level`` with its face coefficients and alpha in ``dtype``: the
    plain versions widen bf16 operands so (the level itself where they
    already are)."""
    if all(t is None or t.dtype == dtype
           for t in (level.beta_i, level.beta_j, level.beta_k, level.alpha)):
        return level
    return dataclasses.replace(
        level, beta_i=level.beta_i.to(dtype), beta_j=level.beta_j.to(dtype),
        beta_k=level.beta_k.to(dtype),
        alpha=None if level.alpha is None else level.alpha.to(dtype))


def _modes_plain(level: Level, x, cfg: SolverConfig, mode: str, rhs, kdinv,
                 ax=None):
    """The mode's result from A x (``ax``, or computed here), in the
    kernels' arithmetic: every operand widened to ``compute_dtype`` (bf16
    to float32), the result rounded to x's type once."""
    ct = compute_dtype(x.dtype)
    xc = x.to(ct)
    if ax is None:
        ax = apply_plain(widened(level, ct), xc, cfg)
    if mode == "apply":
        out = ax
    elif mode == "residual":
        out = rhs.to(ct) - ax
    elif mode == "gsrb":
        out = xc + kdinv.to(ct) * (rhs.to(ct) - ax)
    else:
        out = restrict_cell_plain(rhs.to(ct) - ax)
    return out.to(x.dtype)


def fv4_stencil_plain(level: Level, x: torch.Tensor, cfg: SolverConfig,
                      mode: str, rhs: Optional[torch.Tensor] = None,
                      kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of K1 (ghost fill, shifted slices)."""
    _check(level, x, cfg, mode, rhs, (kdinv,) if mode == "gsrb" else ())
    fv4_stencil_plain.calls += 1
    return _modes_plain(level, x, cfg, mode, rhs, kdinv)


fv4_stencil_plain.calls = 0


def fv4_small(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
              rhs: Optional[torch.Tensor] = None,
              kdinv: Optional[torch.Tensor] = None,
              parity: Optional[int] = None) -> torch.Tensor:
    """The fv4 stencil on a level below 4^3 (``small_level``), on every
    device: K1's plain arithmetic, whose ghost fill takes the quadratic
    Dirichlet ghosts there, as the JAX package's XLA ops do. ``parity``
    is the sweep's colour, which kdinv carries. Its calls count in
    ``launches`` (kernels/counts.py: fv4_small), apart from the plain
    versions' calls: on the card it is the path, not a stand-in for a
    kernel."""
    _check(level, x, cfg, mode, rhs, (kdinv,) if mode == "gsrb" else ())
    if not small_level(level):
        raise ValueError(f"fv4_small takes levels below 4^3, got n={level.dim}")
    fv4_small.launches += 1
    return _modes_plain(level, x, cfg, mode, rhs, kdinv)


fv4_small.launches = 0


def _check_subtile(level: Level, x, cfg: SolverConfig, mode: str, rhs, kdinv,
                   parity):
    if mode not in SUBTILE_MODES:
        raise ValueError(f"the sub-tiled fv4 stencil (K1s) has no mode {mode!r}")
    if mode == "gsrb" and parity not in (0, 1):
        raise ValueError(f"a K1s gsrb needs the sweep's parity (0 or 1), got {parity!r}")
    check_dirichlet(cfg, "the sub-tiled fv4 stencil (K1s)")
    _check(level, x, cfg, mode, rhs, (kdinv,) if mode == "gsrb" else ())


def fv4_subtile_plain(level: Level, x: torch.Tensor, cfg: SolverConfig,
                      mode: str, rhs: Optional[torch.Tensor] = None,
                      kdinv: Optional[torch.Tensor] = None,
                      parity: Optional[int] = None) -> torch.Tensor:
    """The plain version of K1s: K1's plain arithmetic in K1s's modes
    (apply, residual, gsrb), Dirichlet levels only. A gsrb takes and checks
    the kernel's ``parity``; its arithmetic reads the colour from kdinv
    alone (``x + 0 * r`` at the other cells)."""
    _check_subtile(level, x, cfg, mode, rhs, kdinv, parity)
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
                     kdinv: Optional[torch.Tensor] = None,
                     parity: Optional[int] = None, ti: int = 0) -> torch.Tensor:
    """Launch K1s (one pass over tiles staged in shared memory, ghosts made
    there) on CUDA tensors into a newly allocated output. It takes any
    Dirichlet level with n >= 4; the suite's gate (``use_subtile``) only
    chooses which levels it gets. gsrb needs ``parity``, the colour that
    ``kdinv`` carries: the kernel computes A x at that colour's cells only
    and copies x at the others. ``ti``: the tile length along i, 1 to
    ``SUBTILE_MAX_TI`` (0: the launcher's rule, as the solver calls it;
    other values time the rule; any gives the same bits)."""
    from hpgmg_tpu_torch.kernels.build import library

    _check_subtile(level, x, cfg, mode, rhs, kdinv, parity)
    check_kernel_dim(level, "K1s")
    if not 0 <= ti <= SUBTILE_MAX_TI:
        raise ValueError(f"K1s takes a tile length of 0 to {SUBTILE_MAX_TI}, got {ti}")
    if not x.is_cuda:
        raise ValueError(f"fv4_subtile_cuda wants CUDA tensors, got {x.device}")
    n = level.dim
    out = torch.empty((n, n, n), dtype=x.dtype, device=x.device)
    alpha = level.alpha if cfg.helmholtz else None
    dt = dtype_suffix(level.dtype, "K1s")
    with torch.cuda.device(x.device):
        rc = getattr(library(), f"hpgmg_fv4_subtile_{dt}")(
            x.data_ptr(), level.beta_i.data_ptr(), level.beta_j.data_ptr(),
            level.beta_k.data_ptr(), _ptr(alpha), _ptr(rhs), _ptr(kdinv),
            out.data_ptr(), n, MODES[mode], parity or 0, ti, -cfg.b * level.h2inv,
            float(cfg.a), _stream(x))
    if rc != 0:
        raise RuntimeError(f"fv4_subtile kernel launch failed: CUDA error {rc}")
    if dt == "bf16":
        fv4_subtile_cuda.bf16_launches += 1
    else:
        fv4_subtile_cuda.launches += 1
    return out


fv4_subtile_cuda.launches = 0
fv4_subtile_cuda.bf16_launches = 0


def fv4_stencil_cuda(level: Level, x: torch.Tensor, cfg: SolverConfig,
                     mode: str, rhs: Optional[torch.Tensor] = None,
                     kdinv: Optional[torch.Tensor] = None,
                     parity: Optional[int] = None, chunk: int = 0) -> torch.Tensor:
    """Launch K1 (Dirichlet) or K7a (periodic), ``csrc/fv4_stream.cu``: one
    launch on CUDA tensors into a newly allocated output, no ghost buffer.
    gsrb needs ``parity``, the colour that ``kdinv`` carries: the kernel
    computes A x at that colour's cells only and copies x at the others.
    ``chunk``: i-planes a block marches (0: the launcher's rule, as the
    solver calls it; other values time the rule). Its instantiations: the
    level's type throughout (float32, float64, bfloat16: K1's bf16 launches
    count in ``bf16_launches``), or a float32 x with bfloat16 face
    coefficients and kdinv (a BF16C gsrb, ``bf16c_view``; Dirichlet, in
    ``bf16c_launches``). The float32 and float64 launches of K1 count in
    ``launches``, those of K7a in ``periodic_launches``, K7a's bf16 ones in
    ``periodic_bf16_launches``."""
    from hpgmg_tpu_torch.kernels.build import library

    _check(level, x, cfg, mode, rhs, (kdinv,) if mode == "gsrb" else ())
    check_kernel_dim(level, "K1")
    if not x.is_cuda:
        raise ValueError(f"fv4_stencil_cuda wants CUDA tensors, got {x.device}")
    if mode == "gsrb" and parity not in (0, 1):
        raise ValueError(f"fv4 gsrb needs the sweep's parity (0 or 1), got {parity!r}")
    periodic = cfg.bc == BC.PERIODIC
    dt = DTYPES[x.dtype]
    bf16c = level.dtype != x.dtype
    if bf16c and periodic:
        raise NotImplementedError("BF16C (bfloat16 coefficients under a float32 x) "
                                  "takes Dirichlet levels only")
    n = level.dim
    m = n // 2 if mode == "fres" else n
    out = torch.empty((m, m, m), dtype=x.dtype, device=x.device)
    alpha = level.alpha if cfg.helmholtz else None
    entry = "hpgmg_fv4_stream_f32_bf16" if bf16c else f"hpgmg_fv4_stream_{dt}"
    with torch.cuda.device(x.device):
        rc = getattr(library(), entry)(
            x.data_ptr(), level.beta_i.data_ptr(), level.beta_j.data_ptr(),
            level.beta_k.data_ptr(), _ptr(alpha), _ptr(rhs), _ptr(kdinv),
            out.data_ptr(), n, MODES[mode], int(periodic), parity or 0, chunk,
            -cfg.b * level.h2inv, float(cfg.a), _stream(x))
    if rc != 0:
        raise RuntimeError(f"fv4 stencil kernel launch failed: CUDA error {rc}")
    if bf16c:
        fv4_stencil_cuda.bf16c_launches += 1
    else:
        count_launch(fv4_stencil_cuda, periodic, dt)
    return out


fv4_stencil_cuda.launches = 0
fv4_stencil_cuda.periodic_launches = 0
fv4_stencil_cuda.bf16_launches = 0
fv4_stencil_cuda.periodic_bf16_launches = 0
fv4_stencil_cuda.bf16c_launches = 0


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
    check_kernel_dim(level, "K2")
    kd0, kd1 = level.kdinv
    n = level.dim
    out = torch.empty_like(x)
    alpha = level.alpha if cfg.helmholtz else None
    dt = dtype_suffix(x.dtype, "K2", (torch.float32, torch.float64))
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
    (n+4)^2 values, each rounded up to 4 values, of ``itemsize`` bytes: the
    compute type's (a bf16 level's planes hold float32, its operands
    widened after their loads)."""
    return 6 * ((((n + 4) ** 2) + 3) & ~3) * itemsize


def _gsrb2_plan(level: Level, cfg: SolverConfig) -> SimpleNamespace:
    """K2c's unchanging operands on ``level``, checked (checking the
    level's seven arrays on every call cost about as much host time as
    the 64^3 sweep's device time)."""
    check_dirichlet(cfg, "the fused fv4 sweep (K2c)")
    if level.kdinv is None:
        raise ValueError(f"K2c needs the {level.dim}^3 level's kdinv pair")
    _check(level, level.kdinv[0], cfg, "gsrb", level.kdinv[0], level.kdinv)
    check_kernel_dim(level, "K2c")
    n = level.dim
    if n > GSRB2_CLUSTER_MAX_N:
        raise ValueError(f"K2c takes n <= {GSRB2_CLUSTER_MAX_N}, got {n}")
    alpha = level.alpha if cfg.helmholtz else None
    dt = dtype_suffix(level.dtype, "K2c")
    return SimpleNamespace(
        cfg=cfg, smem=gsrb2_cluster_smem(n, compute_dtype(level.dtype).itemsize),
        name=f"hpgmg_fv4_gsrb2_cluster_{dt}", bf16=dt == "bf16",
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
    if plan.bf16:
        fv4_gsrb2_cluster_cuda.bf16_launches += 1
    else:
        fv4_gsrb2_cluster_cuda.launches += 1
    return out


fv4_gsrb2_cluster_cuda.launches = 0
fv4_gsrb2_cluster_cuda.bf16_launches = 0


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
                kdinv: Optional[torch.Tensor] = None,
                parity: Optional[int] = None) -> torch.Tensor:
    """K1s on ``level``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. A gsrb half-sweep needs ``parity``, the colour
    ``kdinv`` carries."""
    if x.is_cuda:
        return fv4_subtile_cuda(level, x, cfg, mode, rhs, kdinv, parity)
    if x.device.type == "cpu":
        return fv4_subtile_plain(level, x, cfg, mode, rhs, kdinv, parity)
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
# the slabs of a block, in the order the slab kernels take them
SLAB_NAMES = ("ilo", "ihi", "jlo", "jhi", "klo", "khi")

# K8a's column tile along j and k (csrc/fv4_slab.cuh TJ, TK): K8b's
# interior pass takes the column tiles 1 .. ntj-2 in j (and on a block
# split along k, 1 .. ntk-2 in k), whose halo rows lie in the block
SLAB_TJ = 16
SLAB_TK = 32


def v4_slab(src: torch.Tensor, axis: int, lo: bool) -> torch.Tensor:
    """The 2-deep quartic Dirichlet ghost slab of ``src`` along ``axis``
    (apply_BCs_v4, boundary_fv.c:334-341), in ascending index order: the
    low side's [far, near], the high side's [near, far]; in
    ``compute_dtype`` (a bf16 src's ghosts are float32, unrounded, as the
    kernels make them)."""
    m, ct = src.shape[axis], compute_dtype(src.dtype)
    x1, x2, x3, x4 = (src.narrow(axis, i if lo else m - 1 - i, 1).to(ct) for i in range(4))
    near = TWELFTH * (-77.0 * x1 + 43.0 * x2 - 17.0 * x3 + 3.0 * x4)
    far = TWELFTH * (-505.0 * x1 + 335.0 * x2 - 145.0 * x3 + 27.0 * x4)
    return torch.cat([far, near] if lo else [near, far], dim=axis)


def build_slabs(x: torch.Tensor, depth: int, width: int, ghost, exchange,
                kslabs: bool = False):
    """The halo slabs of the local block ``x`` (ni, nj, nk), ``depth``
    cells deep: ilo, ihi (depth, nj, nk) first, by ``exchange(0, lo_face,
    hi_face)``, then jlo, jhi (ni + 2 depth, depth, nk), the i-extended
    strips, by ``exchange(1, ...)``, and with ``kslabs`` (a block split
    along k) klo, khi (ni + 2 depth, nj + 2 depth, depth) last, cut from the
    i- and j-extended block, by ``exchange(2, ...)``; so the edge and
    corner ghosts arrive in the i-then-j-then-k order of the separable
    fills. ``exchange`` returns the neighbours' faces, None on a side that
    has none (a Dirichlet domain face); there the slab is ``ghost(src,
    axis, lo)`` of the ``width`` cells nearest the face. The slabs are in
    ``compute_dtype``: a bf16 block's are float32, its cells exact and a
    domain face's ghosts unrounded, so the slab kernels read what a whole
    level's kernels make (the strips and k slabs, which carry ghosts, go
    between the ranks as float32)."""
    ni, nj, ct = x.shape[0], x.shape[1], compute_dtype(x.dtype)
    ilo, ihi = exchange(0, x[:depth], x[ni - depth:])
    ilo = ghost(x[:width], 0, True) if ilo is None else ilo.to(ct)
    ihi = ghost(x[ni - width:], 0, False) if ihi is None else ihi.to(ct)

    def strip(j0, j1):
        return torch.cat([ilo[:, j0:j1], x[:, j0:j1].to(ct), ihi[:, j0:j1]], dim=0)

    jlo, jhi = exchange(1, strip(0, depth), strip(nj - depth, nj))
    jlo = ghost(strip(0, width), 1, True) if jlo is None else jlo
    jhi = ghost(strip(nj - width, nj), 1, False) if jhi is None else jhi
    slabs = (ilo, ihi, jlo, jhi)
    if kslabs:
        xe = extend_slabs(x.to(ct), slabs)
        nk = x.shape[2]
        klo, khi = exchange(2, xe[:, :, :depth], xe[:, :, nk - depth:])
        klo = ghost(xe[:, :, :width], 2, True) if klo is None else klo
        khi = ghost(xe[:, :, nk - width:], 2, False) if khi is None else khi
        slabs += (klo, khi)
    return tuple(t.contiguous() for t in slabs)


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
    block with its i and j ghosts (the jlo/jhi strips are i-extended); the
    (ni+2d, nj+2d, nk+2d) block with its k ghosts too where ``slabs``
    holds the two k slabs as well."""
    ilo, ihi, jlo, jhi = slabs[:4]
    xe = torch.cat([jlo, torch.cat([ilo, x, ihi], dim=0), jhi], dim=1)
    if len(slabs) == 6:
        xe = torch.cat([slabs[4], xe, slabs[5]], dim=2)
    return xe


def extend_for_kernel(x: torch.Tensor, slabs, bc: BC) -> torch.Tensor:
    """The (ni+4, nj+4, nk+4) extended block K8a's plain version applies
    the stencil to: the slabs in i and j, then the k ghosts of the result:
    the k slabs where there are six (a block split along k), else the
    quartic Dirichlet ones or the wrap."""
    xe = extend_slabs(x, slabs)
    if len(slabs) == 6:
        return xe
    if bc == BC.PERIODIC:
        return _wrap_axis(xe, 2, 2)
    return _extend_axis_v4(xe, 2, 2)


def overlap_grid_shape(ni: int, nj: int, nk: Optional[int] = None):
    """(ni, ntj): the block's i-planes and K8a's column tiles along j, where
    K8b's split applies: at least 3 column tiles (the interior pass takes
    the inner ones) and 6 planes (it takes planes 2 .. ni-3), and on a
    block split along k (``nk`` given) at least 3 column tiles along k too
    (the interior pass takes the inner ones, whose stencils read no k
    ghost); else None (counterpart of stencils.py:overlap_grid_shape)."""
    ntj = -(-nj // SLAB_TJ)
    if nk is not None and -(-nk // SLAB_TK) < 3:
        return None
    return (ni, ntj) if ntj >= 3 and ni >= 6 else None


def _check_slab(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                mode: str, rhs, kdinv, overlap: bool = False, ksplit: bool = False):
    """Validate everything K8a/K8b read; raise on what they do not take.
    ``slabs``: four, or six on a block split along k (``ksplit``; K8b's
    interior pass reads none)."""
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
    if slabs is not None:
        ksplit = len(slabs) == 6
        if len(slabs) not in (4, 6):
            raise ValueError(f"K8a takes 4 slabs, or 6 on a block split along k, "
                             f"got {len(slabs)}")
    if overlap and overlap_grid_shape(ni, nj, nk if ksplit else None) is None:
        raise ValueError(f"K8b needs >= 3 column tiles of {SLAB_TJ} along j (and of "
                         f"{SLAB_TK} along a split k) and >= 6 i-planes, got "
                         f"{tuple(x.shape)}")
    blk, dt = (ni, nj, nk), level.dtype
    need = {"x": (x, blk),
            "beta_i": (level.beta_i, (ni + 1, nj + 2, nk + 2)),
            "beta_j": (level.beta_j, (ni + 2, nj + 1, nk + 2)),
            "beta_k": (level.beta_k, (ni + 2, nj + 2, nk + 1))}
    if slabs is not None:
        for name, t, shape in zip(("ilo", "ihi", "jlo", "jhi", "klo", "khi"), slabs,
                                  ((2, nj, nk),) * 2 + ((ni + 4, 2, nk),) * 2
                                  + ((ni + 4, nj + 4, 2),) * 2):
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
        want = compute_dtype(dt) if name in SLAB_NAMES else dt
        if t.dtype != want or dt not in DTYPES:
            raise TypeError(f"{name} is {t.dtype}; the level is {dt}, so {name} must be "
                            f"{want}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fv4_slab_plain(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                   mode: str, rhs: Optional[torch.Tensor] = None,
                   kdinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of K8a: the extended block assembled from x and the
    slabs (``extend_for_kernel``), then K1's plain arithmetic; a bf16 block
    computes as the kernel does: x, the slabs and the level's fields
    widened to float32 (the k ghosts made from them), the result rounded
    to bf16 once."""
    _check_slab(level, x, slabs, cfg, mode, rhs, kdinv)
    fv4_slab_plain.calls += 1
    return _slab_modes_plain(level, x, slabs, cfg, mode, rhs, kdinv)


def _slab_modes_plain(level: Level, x, slabs, cfg: SolverConfig, mode: str, rhs,
                      kdinv):
    ct = compute_dtype(x.dtype)
    xe = extend_for_kernel(x.to(ct), tuple(t.to(ct) for t in slabs), cfg.bc)
    ax = apply_ext_plain(widened(level, ct), xe, cfg)
    return _modes_plain(level, x, cfg, mode, rhs, kdinv, ax=ax)


fv4_slab_plain.calls = 0


def _interior_region(x: torch.Tensor):
    """K8b's interior part as (i0, i1, j0, j1): the i-planes 2 .. ni-3 of
    the column tiles 1 .. ntj-2 along j, whose stencils read the block
    alone (nj is even, so the last column tile holds >= 2 rows)."""
    ni, ntj = overlap_grid_shape(x.shape[0], x.shape[1])
    return 2, ni - 2, SLAB_TJ, (ntj - 1) * SLAB_TJ


def _interior_box(x: torch.Tensor, ksplit: bool):
    """``_interior_region`` and (k0, k1): along k the whole block, or on a
    block split along k (``ksplit``) the column tiles 1 .. ntk-2, whose
    stencils read no k ghost."""
    nk = x.shape[2]
    if ksplit and overlap_grid_shape(*x.shape) is None:
        raise ValueError(f"K8b's split does not take the block {tuple(x.shape)}")
    k0, k1 = (SLAB_TK, (-(-nk // SLAB_TK) - 1) * SLAB_TK) if ksplit else (0, nk)
    return _interior_region(x) + (k0, k1)


def fv4_overlap_interior_plain(level: Level, x: torch.Tensor, cfg: SolverConfig,
                               mode: str, rhs: Optional[torch.Tensor] = None,
                               kdinv: Optional[torch.Tensor] = None,
                               ksplit: bool = False) -> torch.Tensor:
    """The plain version of K8b's interior pass: the interior part of the
    output (``_interior_region``) from the block alone (no slab); zeros
    elsewhere. ``ksplit``: the block is split along k (its k ghosts come
    in slabs, so the interior part keeps off the k ends too)."""
    _check_slab(level, x, None, cfg, mode, rhs, kdinv, overlap=True, ksplit=ksplit)
    fv4_overlap_interior_plain.calls += 1
    i0, i1, j0, j1, k0, k1 = _interior_box(x, ksplit)
    ct = compute_dtype(x.dtype)
    if ksplit:
        xe = x[i0 - 2:i1 + 2, j0 - 2:j1 + 2, k0 - 2:k1 + 2].to(ct)
    else:
        sub = x[i0 - 2:i1 + 2, j0 - 2:j1 + 2].to(ct)
        xe = _wrap_axis(sub, 2, 2) if cfg.bc == BC.PERIODIC else _extend_axis_v4(sub, 2, 2)
    # the fields the plain stencil reads, cut to the interior part (the
    # face arrays with their tangential margins), widened as K8a's are
    lw = widened(level, ct)
    cut = SimpleNamespace(h2inv=level.h2inv,
                          beta_i=lw.beta_i[i0:i1 + 1, j0:j1 + 2, k0:k1 + 2],
                          beta_j=lw.beta_j[i0:i1 + 2, j0:j1 + 1, k0:k1 + 2],
                          beta_k=lw.beta_k[i0:i1 + 2, j0:j1 + 2, k0:k1 + 1],
                          alpha=None if lw.alpha is None
                          else lw.alpha[i0:i1, j0:j1, k0:k1])
    ax = apply_ext_plain(cut, xe, cfg)
    part = (slice(i0, i1), slice(j0, j1), slice(k0, k1))
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
    i0, i1, j0, j1, k0, k1 = _interior_box(x, len(slabs) == 6)
    keep = out[i0:i1, j0:j1, k0:k1].clone()
    out.copy_(full)
    out[i0:i1, j0:j1, k0:k1] = keep
    return out


fv4_overlap_edge_plain.calls = 0


# K8a's and K8b's launches by pass, mode and local block shape, keyed
# "<pass> <mode> (ni, nj, nk)", K8c's (stencils_r1.r1_slab_cuda), keyed
# "K8c <mode> (ni, nj, nk)", and K8d's (stencils_r1.r1_gsrb2_slab_cuda),
# keyed "K8d sweep (ni, nj, nk)", each with " bf16" appended for a
# bfloat16 block and " k-split" on a block split along k (bench/weak.py
# reads them for the counted F-cycle)
SLAB_PASSES = ("K8a", "K8b interior", "K8b edge")
slab_launches_by_block = {}


def count_slab_launch(fn, key: str, ksplit: bool, dtype: torch.dtype):
    """One more launch of the slab wrapper ``fn``: in ``launches`` and, on
    a block split along k, ``kslab_launches``, or for a bfloat16 block in
    ``bf16_launches`` and ``kslab_bf16_launches``; and in
    ``slab_launches_by_block[key]`` (its bf16 and k-split entries)."""
    bf16 = dtype == torch.bfloat16
    tag = "bf16_" if bf16 else ""
    setattr(fn, f"{tag}launches", getattr(fn, f"{tag}launches") + 1)
    if ksplit:
        setattr(fn, f"kslab_{tag}launches", getattr(fn, f"kslab_{tag}launches") + 1)
    key += (" bf16" if bf16 else "") + (" k-split" if ksplit else "")
    slab_launches_by_block[key] = slab_launches_by_block.get(key, 0) + 1


def _launch_slab(fn, level: Level, x, slabs, cfg: SolverConfig, mode: str, rhs,
                 kdinv, out, pass_: int, parity: Optional[int], chunk: int,
                 ksplit: bool):
    """Launch pass ``pass_`` of the slab kernel (0: K8a, 1 and 2: K8b's
    interior and edge passes) through the C entry of x's dtype; count it
    on the wrapper ``fn``."""
    from hpgmg_tpu_torch.kernels.build import library

    if mode == "gsrb" and parity not in (0, 1):
        raise ValueError(f"the fv4 slab gsrb needs the sweep's parity (0 or 1), "
                         f"got {parity!r}")
    if chunk < 0:
        raise ValueError(f"chunk must be >= 0 (0: the launcher's rule), got {chunk}")
    ni, nj, nk = x.shape
    alpha = level.alpha if cfg.helmholtz else None
    slabs = tuple(slabs) + (None,) * (6 - len(slabs)) if slabs is not None else (None,) * 6
    dt = DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        rc = getattr(library(), f"hpgmg_fv4_slab_{dt}")(
            x.data_ptr(), *(_ptr(t) for t in slabs),
            level.beta_i.data_ptr(), level.beta_j.data_ptr(), level.beta_k.data_ptr(),
            _ptr(alpha), _ptr(rhs), _ptr(kdinv), out.data_ptr(), ni, nj, nk,
            MODES[mode], int(cfg.bc == BC.PERIODIC), int(ksplit), parity or 0, chunk,
            -cfg.b * level.h2inv, float(cfg.a), pass_, _stream(x))
    if rc != 0:
        raise RuntimeError(f"fv4 slab kernel launch failed: CUDA error {rc}")
    count_slab_launch(fn, f"{SLAB_PASSES[pass_]} {mode} {tuple(x.shape)}", ksplit, x.dtype)
    return out


def _cuda_only(x: torch.Tensor, what: str):
    if not x.is_cuda:
        raise ValueError(f"{what} wants CUDA tensors, got {x.device}")


def fv4_slab_cuda(level: Level, x: torch.Tensor, slabs, cfg: SolverConfig,
                  mode: str, rhs: Optional[torch.Tensor] = None,
                  kdinv: Optional[torch.Tensor] = None, parity: Optional[int] = None,
                  chunk: int = 0) -> torch.Tensor:
    """Launch K8a (``csrc/fv4_slab.cuh``, one streaming launch) on CUDA
    tensors into a newly allocated output. gsrb needs ``parity``, the
    colour ``kdinv`` carries: the kernel computes A x at that colour's
    cells only and copies x at the others. ``chunk``: i-planes a block
    marches (0: the launcher's rule, as the solver calls it). Six slabs
    (a block split along k): the k ghosts are copied from the k slabs,
    else made in the ring (Dirichlet) or wrapped; ``kslab_launches``
    counts the launches with k slabs. A bfloat16 block's launches count in
    ``bf16_launches`` and ``kslab_bf16_launches`` instead
    (``count_slab_launch``)."""
    _check_slab(level, x, slabs, cfg, mode, rhs, kdinv)
    _cuda_only(x, "fv4_slab_cuda")
    return _launch_slab(fv4_slab_cuda, level, x, slabs, cfg, mode, rhs, kdinv,
                        torch.empty_like(x), 0, parity, chunk, len(slabs) == 6)


fv4_slab_cuda.launches = 0
fv4_slab_cuda.kslab_launches = 0
fv4_slab_cuda.bf16_launches = 0
fv4_slab_cuda.kslab_bf16_launches = 0


def fv4_overlap_interior_cuda(level: Level, x: torch.Tensor, cfg: SolverConfig,
                              mode: str, rhs: Optional[torch.Tensor] = None,
                              kdinv: Optional[torch.Tensor] = None,
                              parity: Optional[int] = None, chunk: int = 0,
                              ksplit: bool = False) -> torch.Tensor:
    """Launch K8b's interior pass into a newly allocated output (the rest
    is left for ``fv4_overlap_edge_cuda``); ``ksplit``: the block is split
    along k, so the pass keeps off its first and last column tiles in k."""
    _check_slab(level, x, None, cfg, mode, rhs, kdinv, overlap=True, ksplit=ksplit)
    _cuda_only(x, "fv4_overlap_interior_cuda")
    return _launch_slab(fv4_overlap_interior_cuda, level, x, None, cfg, mode, rhs, kdinv,
                        torch.empty_like(x), 1, parity, chunk, ksplit)


fv4_overlap_interior_cuda.launches = 0
fv4_overlap_interior_cuda.kslab_launches = 0
fv4_overlap_interior_cuda.bf16_launches = 0
fv4_overlap_interior_cuda.kslab_bf16_launches = 0


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
    return _launch_slab(fv4_overlap_edge_cuda, level, x, slabs, cfg, mode, rhs, kdinv, out, 2,
                        parity, chunk, len(slabs) == 6)


fv4_overlap_edge_cuda.launches = 0
fv4_overlap_edge_cuda.kslab_launches = 0
fv4_overlap_edge_cuda.bf16_launches = 0
fv4_overlap_edge_cuda.kslab_bf16_launches = 0


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
                         parity: Optional[int] = None, ksplit: bool = False) -> torch.Tensor:
    """K8b's interior pass (no slab read; queued before the exchange);
    ``ksplit``: the block is split along k."""
    if x.is_cuda:
        return fv4_overlap_interior_cuda(level, x, cfg, mode, rhs, kdinv, parity,
                                         ksplit=ksplit)
    if x.device.type == "cpu":
        return fv4_overlap_interior_plain(level, x, cfg, mode, rhs, kdinv, ksplit)
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
    out = fv4_overlap_interior(level, x, cfg, mode, rhs, kdinv, parity, len(slabs) == 6)
    return fv4_overlap_edge(level, x, slabs, cfg, mode, out, rhs, kdinv, parity)
