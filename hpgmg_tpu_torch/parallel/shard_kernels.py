"""The stencils on a decomposed level: the halo slabs, the slab kernels
K8a-K8d on each rank's local block, and the per-rank cuts of a level's
fields (counterpart of hpgmg_tpu/parallel/shard_kernels.py).

The JAX package runs each kernel launch as a ``shard_map`` region that
ppermutes thin halo slabs, then runs the Pallas kernel on the unextended
local block; a level split along z it leaves to GSPMD
(hpgmg_tpu/parallel/shard_kernels.py:71). Here each rank is a process:
``slabs_for_kernel`` exchanges the four slabs of its block (i first, then
the i-extended j strips, so the (i, j) edge ghosts arrive in the
i-then-j order of the separable BC fills; a domain face gets the BC fill
or, periodic, the wrap from the ring neighbour), and on a block split
along k (the 3D grid of ``make_mesh``) two k slabs last, cut from the i-
and j-extended block, so the edges and corners arrive too; then the slab
kernel runs on the block, its k ghosts read from the k slabs.

Every decomposed level takes this path: K8a (fv4) and K8c (radius-1) on
the card, their plain versions on the CPU. The JAX package leaves
decomposed levels below 64^3 to GSPMD (``_AUTO_MIN_DIM``); the port has no
GSPMD, so its gate is only what the kernels need: even local extents
along every axis (global red/black parity on local indices, local
restriction), which the agglomeration floor makes >= 8. There is no ext path (the JAX fallback for
blocks its slab window refuses): K8a and K8c take every such block.

GSRB parity masks stay global: each rank's ``kdinv`` is its cut of the
global parity-folded dinv, and local offsets are even.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import stencils_r1 as K
from hpgmg_tpu_torch.parallel.halo import exchange_faces
from hpgmg_tpu_torch.parallel.mesh import Part

# Comm/compute overlap for the fv4 slab path: K8b's interior pass, which
# reads no slab, runs on a side stream while the slabs are exchanged, then
# its edge pass (exchange_boundary.c:48-56; the JAX switch,
# shard_kernels.py:54, off there too). Off: its gain cannot be measured
# with every rank on one card (PERF.md).
OVERLAP = False


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------

def sharded_kernel_eligible(part: Part, cfg: SolverConfig) -> bool:
    """Whether the fv4 slab kernel (K8a) takes this rank's block: a
    Dirichlet or periodic level with even local extents >= 4 (nk even too,
    so local parity stays global on a block split along k)."""
    return (cfg.bc in (BC.DIRICHLET, BC.PERIODIC)
            and all(e % 2 == 0 for e in part.extents) and min(part.extents) >= 4)


def sharded_r1_eligible(part: Part, cfg: SolverConfig, var7: bool) -> bool:
    """Whether the radius-1 slab kernel (K8c) takes this rank's block: even
    local extents >= 2 (either body)."""
    return (cfg.bc in (BC.DIRICHLET, BC.PERIODIC)
            and all(e % 2 == 0 for e in part.extents) and min(part.extents) >= 2)


def sharded_gsrb2_eligible(part: Part, cfg: SolverConfig, var7: bool) -> bool:
    """Whether full GSRB sweeps of the block go through K8d: the
    single-rank gate of K6 (``stencils_r1.use_gsrb2``: Dirichlet, the
    global dim <= GSRB2_MAX_DIM, var7 unless GSRB2_VAR7_ONLY is off), on a
    block K8c takes."""
    return (K.use_gsrb2(part.dim, var7, cfg.bc)
            and sharded_r1_eligible(part, cfg, var7))


# ---------------------------------------------------------------------------
# halo slabs (the exchange_boundary + apply_BCs pair)
# ---------------------------------------------------------------------------

def _exchange(part: Part, periodic: bool):
    """The ``exchange`` of ``stencils.build_slabs`` across the ranks."""
    def exchange(axis, lo_face, hi_face):
        return exchange_faces(part, axis, lo_face, hi_face, periodic)
    return exchange


def slabs_for_kernel(x: torch.Tensor, part: Part, bc: BC):
    """K8a's 2-deep slabs of this rank's block: ilo, ihi (2, nj, nk),
    jlo, jhi (ni+4, 2, nk), and on a block split along k klo, khi (ni+4,
    nj+4, 2); the quartic Dirichlet fill at a domain face, the ring
    neighbour's cells under periodic BCs."""
    return S.build_slabs(x, 2, 4, S.v4_slab, _exchange(part, bc == BC.PERIODIC),
                         part.axes[2])


def slabs_for_kernel_r1(x: torch.Tensor, part: Part, bc: BC, taps: str):
    """K8c's 1-deep slabs: ilo, ihi (1, nj, nk), jlo, jhi (ni+2, 1, nk),
    and on a block split along k klo, khi (ni+2, nj+2, 1); the suite's
    2-tap Dirichlet ghost at a domain face."""
    return S.build_slabs(x, 1, 2, K.taps_ghost(taps), _exchange(part, bc == BC.PERIODIC),
                         part.axes[2])


def slabs2_for_kernel_r1(x: torch.Tensor, part: Part, taps: str):
    """K8d's 2-deep slabs (Dirichlet; k slabs (ni+4, nj+4, 2) on a block
    split along k): ONE exchange serves a full red+black sweep; at a domain
    face both rows hold the 2-tap ghost (the far one is read only at ghost
    positions, which K8d rebuilds)."""
    return S.build_slabs(x, 2, 2, K.taps_ghost2(taps), _exchange(part, False),
                         part.axes[2])


def edge_flags(part: Part):
    """(i low, i high, j low, j high), and on a block split along k (k
    low, k high) too: whether each side of the block is a domain face (a
    block whole along k has both k sides there)."""
    flags = tuple(side for c, p in zip(part.coords, part.counts)
                  for side in (c == 0, c == p - 1))
    return flags if part.axes[2] else flags[:4]


# ---------------------------------------------------------------------------
# the stencils on a decomposed level
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


def fv4_sharded(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
                rhs: Optional[torch.Tensor] = None,
                kdinv: Optional[torch.Tensor] = None,
                parity: Optional[int] = None) -> torch.Tensor:
    """One fv4 apply / residual / GSRB half-sweep on this rank's block:
    the slab exchange, then K8a (a half-sweep with its ``parity``, which
    is global and local alike: block offsets are even). Under ``OVERLAP``
    (on blocks K8b's split takes) K8b instead: its interior pass first (on
    a side stream for CUDA tensors, so it runs while the exchange is in
    flight), then the edge pass once the slabs are in."""
    part = level.part
    ksplit = part.axes[2]
    if OVERLAP and S.overlap_grid_shape(part.ni, part.nj,
                                        part.nk if ksplit else None) is not None:
        if not x.is_cuda:
            out = S.fv4_overlap_interior(level, x, cfg, mode, rhs, kdinv, parity, ksplit)
            slabs = slabs_for_kernel(x, part, cfg.bc)
            return S.fv4_overlap_edge(level, x, slabs, cfg, mode, out, rhs, kdinv, parity)
        main, side = torch.cuda.current_stream(x.device), _side_stream(x.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = S.fv4_overlap_interior(level, x, cfg, mode, rhs, kdinv, parity, ksplit)
        slabs = slabs_for_kernel(x, part, cfg.bc)
        main.wait_stream(side)
        out.record_stream(main)
        return S.fv4_overlap_edge(level, x, slabs, cfg, mode, out, rhs, kdinv, parity)
    return S.fv4_slab(level, x, slabs_for_kernel(x, part, cfg.bc), cfg, mode, rhs, kdinv,
                      parity)


def r1_sharded(level: Level, x: torch.Tensor, cfg: SolverConfig, mode: str,
               taps: str, var7: bool, rhs: Optional[torch.Tensor] = None,
               kdinv: Optional[torch.Tensor] = None,
               parity: Optional[int] = None) -> torch.Tensor:
    """One radius-1 apply / residual / GSRB half-sweep / restricted
    residual on this rank's block: the 1-deep slab exchange, then K8c (a
    half-sweep with its ``parity``, global and local alike)."""
    slabs = slabs_for_kernel_r1(x, level.part, cfg.bc, taps)
    return K.r1_slab(level, x, slabs, cfg, mode, taps, var7, rhs, kdinv, parity)


def r1_gsrb2_rhs_sharded(part: Part, rhs: torch.Tensor) -> torch.Tensor:
    """K8d's ring-exchanged rhs, (ni+2, nj+2, nk) ((ni+2, nj+2, nk+2) on a
    block split along k): the block with its neighbours' 1-deep faces (i,
    then the i-extended j faces, then the i- and j-extended k faces, so the
    ring edges and corners are true values too), zeros at domain faces.
    Built once per smooth call and read by all its sweeps."""
    def ring(a, axis):
        n = a.shape[axis]
        glo, ghi = exchange_faces(part, axis, a.narrow(axis, 0, 1),
                                  a.narrow(axis, n - 1, 1), False)
        glo = torch.zeros_like(a.narrow(axis, 0, 1)) if glo is None else glo
        ghi = torch.zeros_like(a.narrow(axis, 0, 1)) if ghi is None else ghi
        return torch.cat([glo, a, ghi], dim=axis)

    out = ring(ring(rhs, 0), 1)
    return (ring(out, 2) if part.axes[2] else out).contiguous()


def r1_gsrb2_sharded(level: Level, x: torch.Tensor, rhs2: torch.Tensor,
                     cfg: SolverConfig, taps: str, var7: bool) -> torch.Tensor:
    """One full red+black GSRB sweep of this rank's block: ONE 2-deep slab
    exchange and one K8d launch (half the messages and launches of two
    half-sweeps). ``rhs2`` from ``r1_gsrb2_rhs_sharded``; the coefficient
    ring views are the level's (``build_sharded_k2_r1``)."""
    slabs = slabs2_for_kernel_r1(x, level.part, taps)
    return K.r1_gsrb2_slab(level, x, slabs, edge_flags(level.part), rhs2, cfg,
                           taps, var7)


# ---------------------------------------------------------------------------
# per-rank cuts of a level (made once, at shard_hierarchy time)
# ---------------------------------------------------------------------------

def _cut(t: Optional[torch.Tensor], i0: int, i1: int, j0: int, j1: int,
         k0: int = 0, k1: Optional[int] = None):
    if t is None:
        return None
    return t[i0:i1, j0:j1, k0:k1].clone(memory_format=torch.contiguous_format)


def build_sharded_views(part: Part, level: Level) -> dict:
    """The fv4 face coefficients of this rank's block: cuts of the globally
    tangentially-extended arrays with their margins (beta_i (ni+1, nj+2,
    nk+2) and so on), so interior margins hold the neighbours' true faces
    and only domain faces the extrapolated ghosts (counterpart of
    shard_kernels.py:build_sharded_views, in the port's layout)."""
    (oi, oj, ok), (ni, nj, nk) = part.offsets, part.extents
    return dict(beta_i=_cut(level.beta_i, oi, oi + ni + 1, oj, oj + nj + 2, ok, ok + nk + 2),
                beta_j=_cut(level.beta_j, oi, oi + ni + 2, oj, oj + nj + 1, ok, ok + nk + 2),
                beta_k=_cut(level.beta_k, oi, oi + ni + 2, oj, oj + nj + 2, ok, ok + nk + 1))


def build_sharded_views_r1(part: Part, level: Level) -> dict:
    """The radius-1 face coefficients of this rank's block: plain cuts of
    the natural face arrays (the radius-1 flux reads no tangential
    ghost)."""
    (oi, oj, ok), (ni, nj, nk) = part.offsets, part.extents
    return dict(beta_i=_cut(level.beta_i, oi, oi + ni + 1, oj, oj + nj, ok, ok + nk),
                beta_j=_cut(level.beta_j, oi, oi + ni, oj, oj + nj + 1, ok, ok + nk),
                beta_k=_cut(level.beta_k, oi, oi + ni, oj, oj + nj, ok, ok + nk + 1))


def build_sharded_k2_r1(part: Part, level: Level, cfg: SolverConfig, var7: bool):
    """K8d's ring views of this rank's block (kernels/stencils_r1.py:
    ring_views): the true neighbour coefficients in the ring, zeros at
    domain faces, so a sweep exchanges no coefficient."""
    (oi, oj, ok), (ni, nj, nk) = part.offsets, part.extents
    return K.ring_views(level, cfg, var7, oi, oj, ni, nj, ok, nk)


def shard_level(level: Level, part: Optional[Part], cfg: SolverConfig) -> Level:
    """``level`` (global) cut to this rank's ``part``; returned as it is
    where the level is replicated (part None)."""
    if part is None:
        return level
    var7 = cfg.op != "27pt"
    ok = (sharded_kernel_eligible(part, cfg) if cfg.op == "fv4"
          else sharded_r1_eligible(part, cfg, var7))
    if not ok:
        raise ValueError(f"the slab kernels do not take the "
                         f"{' x '.join(map(str, part.extents))} blocks of the "
                         f"{level.dim}^3 level (even extents needed)")
    (oi, oj, ok), (ni, nj, nk) = part.offsets, part.extents
    box = (oi, oi + ni, oj, oj + nj, ok, ok + nk)
    kw = (build_sharded_views(part, level) if cfg.op == "fv4"
          else build_sharded_views_r1(part, level))
    for name in ("alpha", "dinv", "l1inv"):
        kw[name] = _cut(getattr(level, name), *box)
    if level.kdinv is not None:
        kw["kdinv"] = tuple(_cut(d, *box) for d in level.kdinv)
        if cfg.op != "fv4" and sharded_gsrb2_eligible(part, cfg, var7):
            kw["ring"] = build_sharded_k2_r1(part, level, cfg, var7)
    return dataclasses.replace(level, part=part, **kw)
