"""FE distribution: each rank's block of a level over the 3D process grid
(counterpart of hpgmg_tpu/fe/mesh.py).

The reference FE distributes an element range per rank on a Z-ordered
process grid and coarsens the process set by keeping every 8th Z-rank
(grid.c:106-220); halos and injections are PetscSF graphs. The JAX package
shards the element-batch axes (Mx, My, Mz) over its device mesh and lets
GSPMD emit the exchanges. PyTorch has no GSPMD, so the port writes them
out over the ``torch.distributed`` ranks of ``parallel/mesh.py:make_mesh``:

* A level is split along an axis where the grid has more than one rank on
  it and each rank keeps >= ``MIN_ELEMS_PER_CHIP`` elements (``_axis_spec``,
  the JAX rule); a level split on no axis is replicated: every rank holds
  the whole level and runs it redundantly (the every-8th-rank comm-split of
  grid.c:208-220 as "every rank owns the coarse grid", as in the FV path).
* A rank's block (``FEPart``) holds its elements and their nodes,
  *both* boundary planes included (p*m + 1 nodes along a split axis, p the
  degree, m its elements): a node plane at an internal face lives on the
  two ranks beside it and is kept equal there. The element gather,
  injection and interpolation are then local; only sums cross ranks:
  assembly adds the neighbour's partial sums on each shared plane
  (``FEPart.sum_shared``, axis by axis, whole planes, so edges and
  corners add up), and a reduction counts each node once, on the block
  that owns it (``FEPart.node_sum``: the lower plane of each shared pair
  belongs to the block above it).

The operator sees a block through ``FEPart.block``, a ``fe/grid.py:
BlockGrid`` (its elements, the domain's lengths, domain faces zeroed
only, the transfers to a coarse level split alike or replicated).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from hpgmg_tpu_torch.fe.grid import BlockGrid, FEGrid
from hpgmg_tpu_torch.parallel.mesh import MESH_AXES, Mesh
from hpgmg_tpu_torch.utils.profiler import scope

# Replicate a level along an axis where a rank would hold fewer elements
# than this (the cmax=192-local-elements rationale, fmg.c:43-53, scaled to
# per-axis form).
MIN_ELEMS_PER_CHIP = 2


def _axis_spec(mesh, M) -> tuple:
    """Mesh axis names for the three element-batch dims, None where the
    level is replicated along that axis (hpgmg_tpu/fe/mesh.py:_axis_spec).
    ``mesh`` is a Mesh or its shape."""
    shape = mesh.shape if isinstance(mesh, Mesh) else tuple(mesh)
    spec = []
    for ax, name in enumerate(MESH_AXES):
        size = shape[ax]
        if size > 1 and M[ax] % size == 0 and M[ax] // size >= MIN_ELEMS_PER_CHIP:
            spec.append(name)
        else:
            spec.append(None)
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class FEPart:
    """This rank's block of the level ``grid`` (the whole level's FEGrid),
    split along the axes where ``split`` holds. Along an unsplit axis the
    block is the whole extent; ranks that differ only along unsplit axes
    hold the same block, and the one at coordinate 0 there owns it (for
    reductions)."""

    mesh: Mesh
    split: Tuple[bool, bool, bool]
    grid: FEGrid

    @property
    def counts(self) -> Tuple[int, int, int]:
        """Blocks along each axis."""
        return tuple(self.mesh.shape[a] if self.split[a] else 1 for a in range(3))

    @property
    def coords(self) -> Tuple[int, int, int]:
        c = self.mesh.coords
        return tuple(c[a] if self.split[a] else 0 for a in range(3))

    @property
    def elems(self) -> Tuple[int, int, int]:
        """The block's elements along each axis."""
        return tuple(m // c for m, c in zip(self.grid.M, self.counts))

    @property
    def elem_offsets(self) -> Tuple[int, int, int]:
        return tuple(c * m for c, m in zip(self.coords, self.elems))

    @property
    def nodes(self) -> Tuple[int, int, int]:
        """The block's nodes along each axis, both boundary planes included."""
        return tuple(self.grid.degree * m + 1 for m in self.elems)

    @property
    def node_offsets(self) -> Tuple[int, int, int]:
        """The global index of the block's first node along each axis."""
        return tuple(self.grid.degree * o for o in self.elem_offsets)

    @property
    def domain_faces(self) -> Tuple[Tuple[bool, bool], ...]:
        """(low, high) per axis: whether the block's face is a face of the
        domain (else a neighbour holds the plane too)."""
        return tuple((c == 0, c == n - 1) for c, n in zip(self.coords, self.counts))

    @property
    def owned(self) -> Tuple[int, int, int]:
        """The nodes this block owns from its first along each axis: all
        but the high plane where a neighbour lies above."""
        return tuple(n - (0 if hi else 1)
                     for n, (_, hi) in zip(self.nodes, self.domain_faces))

    @property
    def owner(self) -> bool:
        c = self.mesh.coords
        return all(self.split[a] or c[a] == 0 for a in range(3))

    @functools.cached_property
    def block(self) -> BlockGrid:
        """The block as the operator sees it (fe/grid.py:BlockGrid)."""
        g = self.grid
        return BlockGrid(M=self.elems, degree=g.degree, L=g.L,
                         addquadpts=g.addquadpts, part=self)

    def neighbor(self, axis: int, step: int, periodic: bool = False) -> Optional[int]:
        """The rank holding the block ``step`` (+-1) along the split
        ``axis``, None past a domain face (FE levels have no periodic
        case; ``periodic`` is the signature parallel/halo.py calls)."""
        c = list(self.mesh.coords)
        c[axis] += step
        if not 0 <= c[axis] < self.mesh.shape[axis]:
            return None
        return self.mesh.rank_at(*c)

    def of_rank(self, rank: int) -> "FEPart":
        """The same placement seen from ``rank``."""
        return dataclasses.replace(self, mesh=dataclasses.replace(self.mesh, rank=rank))

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole level's node field ``x`` (its
        trailing three axes; a copy)."""
        sl = tuple(slice(o, o + n) for o, n in zip(self.node_offsets, self.nodes))
        return x[(Ellipsis,) + sl].clone(memory_format=torch.contiguous_format)

    def cut_elements(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's elements of an element field (element batch in the
        trailing three axes; a copy)."""
        sl = tuple(slice(o, o + m) for o, m in zip(self.elem_offsets, self.elems))
        return x[(Ellipsis,) + sl].clone(memory_format=torch.contiguous_format)

    def sum_shared(self, x: torch.Tensor) -> torch.Tensor:
        """Complete the partial sums ``x`` (this block's nodes) on the
        shared planes, in place: along each split axis, x then y then z,
        add the neighbour's whole plane to each plane it shares, so the
        edges and corners take every block's part. Both sides add the same
        two values, so the plane stays equal on both."""
        from hpgmg_tpu_torch.parallel.halo import exchange_faces

        for a in range(3):
            if not self.split[a]:
                continue
            lo, hi = x.select(a, 0), x.select(a, x.shape[a] - 1)
            with scope("fe.sum_shared"):
                glo, ghi = exchange_faces(self, a, lo, hi, periodic=False)
            if glo is not None:
                lo.add_(glo)
            if ghi is not None:
                hi.add_(ghi)
        return x

    def node_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the whole level's node field of which ``x`` is this
        block: each node counted once, on the block that owns it, the sums
        all-reduced (every rank gets the same value)."""
        from hpgmg_tpu_torch.core.blas import sum_over

        ox, oy, oz = self.owned
        return sum_over(torch.sum(x[:ox, :oy, :oz]), self)

    def all_gather(self, piece: torch.Tensor, offset: Callable[["FEPart"], tuple],
                   shape) -> torch.Tensor:
        """The field of ``shape`` made of every rank's ``piece`` (all of one
        shape), rank r's placed at ``offset(self.of_rank(r))``; pieces that
        overlap hold the same values there. On ``piece``'s device; the
        transport follows the group's backend."""
        host = self.mesh.backend == "gloo"
        src = piece.contiguous().cpu() if host else piece.contiguous()
        bufs = [torch.empty_like(src) for _ in range(self.mesh.size)]
        with scope("fe.all_gather"):
            dist.all_gather(bufs, src)
        out = torch.empty(tuple(shape), dtype=src.dtype, device=src.device)
        for r, b in enumerate(bufs):
            sl = tuple(slice(o, o + n) for o, n in zip(offset(self.of_rank(r)), b.shape))
            out[sl] = b
        return out.to(piece.device) if host else out


def fe_level_part(mesh: Optional[Mesh], grid: FEGrid) -> Optional[FEPart]:
    """This rank's FEPart of the level ``grid`` on ``mesh``; None where the
    level is replicated (no mesh, or ``_axis_spec`` splits no axis)."""
    if mesh is None:
        return None
    spec = _axis_spec(mesh, grid.M)
    if all(s is None for s in spec):
        return None
    return FEPart(mesh, tuple(s is not None for s in spec), grid)


def gather_fe_field(part: Optional[FEPart], x: torch.Tensor) -> torch.Tensor:
    """The whole level's node field from every rank's block ``x``; ``x``
    itself where the level is replicated (``part`` None)."""
    if part is None:
        return x
    return part.all_gather(x, lambda p: p.node_offsets, part.grid.nodes)


def shard_fe_levels(mesh: Optional[Mesh], levels: List) -> List:
    """Cut every level built whole (fe/fas.py:build_fe_levels without a
    mesh) to this rank: split levels keep this rank's block of coords,
    dinv and the element metric (the affine metric, one value for all
    elements, stays), replicated levels stay as they are
    (hpgmg_tpu/fe/mesh.py:shard_fe_levels). ``build_fe_levels(...,
    mesh=)`` builds each block directly instead."""
    if mesh is None:
        return levels
    out = []
    for lv in levels:
        part = fe_level_part(mesh, lv.grid)
        if part is None:
            out.append(lv)
            continue

        def metric(a):
            return part.cut_elements(a) if tuple(a.shape[-3:]) == tuple(lv.grid.M) else a

        out.append(dataclasses.replace(
            lv, coords=part.cut(lv.coords), dinv=part.cut(lv.dinv),
            metric_a=metric(lv.metric_a), metric_w=metric(lv.metric_w), part=part))
    return out


def shard_fe_field(mesh: Optional[Mesh], level, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the whole-level node field ``x`` (e.g. the
    forcing) of ``level``; ``x`` where the level is replicated."""
    part = fe_level_part(mesh, level.grid)
    return x if part is None else part.cut(x)
