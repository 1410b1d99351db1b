"""Process grid + level placement (counterpart of hpgmg_tpu/parallel/mesh.py,
its ``make_mesh_ij`` path).

The reference distributes boxes over MPI ranks and re-agglomerates coarse
levels onto fewer ranks (mg.c:894-997). The JAX package runs one SPMD
program whose levels carry a sharding; PyTorch has no GSPMD, so the port
decomposes explicitly: one process per rank in a ``torch.distributed``
group, laid out as an (sx, sy, 1) grid over the i and j axes (k, the fast
axis, stays whole on every rank). Each level is either

* decomposed: every rank holds its block, (dim/px, dim/py, dim) cells at
  offset (oi, oj) (``Part``); a level keeps an axis split while each rank
  keeps >= ``AGGLOMERATION_START`` cells along it (graduated: axes drop out
  one at a time), or
* replicated: an ordinary single-rank level, the same on every rank (the
  coarse grids and the bottom solve run redundantly on each, the analog of
  agglomerating onto one rank, MG_AGGLOMERATION_START).

Transitions between the two are ``gather`` (all_gather of the blocks) and
``cut``. The transport is the group's backend: NCCL sends device tensors
(one card per rank); gloo sends host copies (ranks sharing one card, or
the CPU), chosen by whoever initializes the group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

# Per-rank block floor below which an axis stops being split
# (MG_AGGLOMERATION_START analog, mg.h:15-17).
AGGLOMERATION_START = 8

# Graduated agglomeration: axes drop out of a level's split one at a time;
# False: a level is decomposed on every split axis or replicated.
GRADUATED = True

MESH_AXES = ("x", "y", "z")
REPLICATED = "replicated"


def _factor3(n: int) -> Tuple[int, int, int]:
    """Split n ranks into the squarest (x, y, z) factorization, mirroring
    ProcessGridFindSquarest (sampler.c:19-41)."""
    best_key, best = None, (n, 1, 1)
    for fx in range(1, n + 1):
        if n % fx:
            continue
        rem = n // fx
        for fy in range(1, rem + 1):
            if rem % fy:
                continue
            fz = rem // fy
            key = (max(fx, fy, fz) - min(fx, fy, fz), max(fx, fy, fz))
            if best_key is None or key < best_key:
                best_key, best = key, (fx, fy, fz)
    return tuple(sorted(best, reverse=True))


def mesh_ij_shape(n: int) -> Tuple[int, int, int]:
    """The (sx, sy, 1) grid of n ranks over i and j only (the decision of
    hpgmg_tpu/parallel/mesh.py:make_mesh_ij): the squarest pair, larger
    first."""
    best = (n, 1)
    for fx in range(1, n + 1):
        if n % fx:
            continue
        fy = n // fx
        if max(fx, fy) - min(fx, fy) <= max(best) - min(best):
            best = (fx, fy)
    return tuple(sorted(best, reverse=True)) + (1,)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (sx, sy, 1) grid of the default process
    group: rank r sits at (r // sy, r % sy). ``backend`` is the group's
    ("nccl" or "gloo"); ``device`` where this rank's tensors live."""

    shape: Tuple[int, int, int]
    rank: int
    backend: str
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> Tuple[int, int]:
        return self.rank // self.shape[1], self.rank % self.shape[1]

    def rank_at(self, cx: int, cy: int) -> int:
        return cx * self.shape[1] + cy


def make_mesh_ij(device: Union[str, torch.device, None] = None) -> Mesh:
    """The i/j grid over the initialized default process group (counterpart
    of hpgmg_tpu/parallel/mesh.py:make_mesh_ij). ``device`` defaults to
    the current CUDA device under NCCL, else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_ij needs an initialized process group")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(shape=mesh_ij_shape(dist.get_world_size()), rank=dist.get_rank(),
                backend=backend, device=torch.device(device))


def level_sharding(mesh, dim: int, face_axis: Optional[int] = None):
    """Which axes a level of extent ``dim`` is split over, as a tuple of
    mesh axis names, or ``REPLICATED`` (the decision of
    hpgmg_tpu/parallel/mesh.py:level_sharding): an axis stays split while
    each rank keeps >= AGGLOMERATION_START cells along it; axes that fall
    below drop out individually (GRADUATED). ``face_axis`` stays unsplit.
    ``mesh`` is a Mesh or its shape."""
    shape = mesh.shape if isinstance(mesh, Mesh) else tuple(mesh)
    split, dropped = [], False
    for ax, name in enumerate(MESH_AXES):
        size = shape[ax]
        if ax == face_axis or size == 1:
            continue
        if dim % size == 0 and dim // size >= AGGLOMERATION_START:
            split.append(name)
        else:
            dropped = True
    if not split or (dropped and not GRADUATED):
        return REPLICATED
    return tuple(split)


@dataclasses.dataclass(frozen=True)
class Part:
    """This rank's block of a decomposed level of extent ``dim``: split
    over i where ``split[0]``, over j where ``split[1]``. Along an unsplit
    axis the block is the whole extent; ranks that differ only along
    unsplit axes hold the same block, and the one at coordinate 0 there
    owns it (for reductions)."""

    mesh: Mesh
    split: Tuple[bool, bool]
    dim: int

    @property
    def counts(self) -> Tuple[int, int]:
        """Blocks along i and j."""
        return tuple(self.mesh.shape[a] if self.split[a] else 1 for a in (0, 1))

    @property
    def coords(self) -> Tuple[int, int]:
        c = self.mesh.coords
        return tuple(c[a] if self.split[a] else 0 for a in (0, 1))

    @property
    def ni(self) -> int:
        return self.dim // self.counts[0]

    @property
    def nj(self) -> int:
        return self.dim // self.counts[1]

    @property
    def oi(self) -> int:
        return self.coords[0] * self.ni

    @property
    def oj(self) -> int:
        return self.coords[1] * self.nj

    @property
    def owner(self) -> bool:
        c = self.mesh.coords
        return all(self.split[a] or c[a] == 0 for a in (0, 1))

    def coarsen(self) -> "Part":
        """The same split at half the extent: the block a local
        restriction leaves."""
        return dataclasses.replace(self, dim=self.dim // 2)

    def neighbor(self, axis: int, step: int, periodic: bool) -> Optional[int]:
        """The rank holding the block ``step`` (+-1) along the split
        ``axis``; None past a domain face unless ``periodic``."""
        c = list(self.mesh.coords)
        size = self.mesh.shape[axis]
        c[axis] += step
        if not 0 <= c[axis] < size:
            if not periodic:
                return None
            c[axis] %= size
        return self.mesh.rank_at(*c)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global field ``x`` (a copy)."""
        return x[self.oi:self.oi + self.ni, self.oj:self.oj + self.nj].clone(
            memory_format=torch.contiguous_format)


def level_part(mesh: Mesh, dim: int) -> Optional[Part]:
    """This rank's Part of a level of extent ``dim``; None where the level
    is replicated."""
    spec = level_sharding(mesh, dim)
    if spec == REPLICATED:
        return None
    return Part(mesh, ("x" in spec, "y" in spec), dim)


def shard_array(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the global cell field ``x``, or ``x`` itself
    where its level is replicated."""
    part = level_part(mesh, x.shape[0])
    return x if part is None else part.block(x)


def gather(x: torch.Tensor, part: Part) -> torch.Tensor:
    """The global field from every rank's block (all_gather), on x's
    device; the transport follows the group's backend."""
    mesh = part.mesh
    host = mesh.backend == "gloo"
    src = x.contiguous().cpu() if host else x.contiguous()
    bufs = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(bufs, src)
    out = torch.empty((part.dim, part.dim, x.shape[2]), dtype=x.dtype, device=src.device)
    for r, b in enumerate(bufs):
        p = dataclasses.replace(part, mesh=dataclasses.replace(mesh, rank=r))
        out[p.oi:p.oi + p.ni, p.oj:p.oj + p.nj] = b
    return out.to(x.device) if host else out


def redistribute(x: torch.Tensor, src: Optional[Part],
                 dst: Optional[Part]) -> torch.Tensor:
    """A field held as ``src`` (a Part, or None for the whole field on
    every rank) re-held as ``dst``: unchanged where they agree, else
    gathered and cut."""
    if src == dst:
        return x
    full = x if src is None else gather(x, src)
    return full if dst is None else dst.block(full)


def shard_hierarchy(mesh: Mesh, hier, cfg):
    """Cut every level of a (global) hierarchy to this rank: decomposed
    levels keep this rank's block of every field (shard_kernels'
    view builders), replicated ones stay as they are (decided per level by
    ``level_sharding``). A decomposed level the slab kernels do not take
    (odd local extents) raises: the port has no GSPMD path to fall back
    on."""
    from hpgmg_tpu_torch.core.hierarchy import Hierarchy
    from hpgmg_tpu_torch.parallel.shard_kernels import shard_level

    return Hierarchy(levels=[shard_level(lv, level_part(mesh, lv.dim), cfg)
                             for lv in hier.levels])


# ---------------------------------------------------------------------------
# Active-mesh context (counterpart of hpgmg_tpu/parallel/mesh.py:304-335):
# the solve runs under the mesh its hierarchy was cut for; the tail kernels
# (K4) are off under one, as in the JAX package.
# ---------------------------------------------------------------------------

_ACTIVE_MESH: Optional[Mesh] = None


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


class active_mesh:
    """Context manager: ``with active_mesh(mesh): u = fmg_solve(...)``."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False
