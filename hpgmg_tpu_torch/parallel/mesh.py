"""Process grid + level placement (counterpart of hpgmg_tpu/parallel/mesh.py).

The reference distributes boxes over MPI ranks and re-agglomerates coarse
levels onto fewer ranks (mg.c:894-997). The JAX package runs one SPMD
program whose levels carry a sharding; PyTorch has no GSPMD, so the port
decomposes explicitly: one process per rank in a ``torch.distributed``
group, laid out as an (sx, sy, sz) grid over the i, j and k axes
(``make_mesh``, the squarest factorization; ``make_mesh_ij``, the (sx, sy,
1) grid over i and j; ``make_pod_mesh``, emulated slices outermost on k).
Each level is either

* decomposed: every rank holds its block, (dim/px, dim/py, dim/pz) cells
  at offset (oi, oj, ok) (``Part``); a level keeps an axis split while
  each rank keeps >= ``AGGLOMERATION_START`` cells along it (graduated:
  axes drop out one at a time), or
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

import numpy as np
import torch
import torch.distributed as dist

from hpgmg_tpu_torch.utils.profiler import scope

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


def pod_layout(n: int, n_slices: int) -> Tuple[Tuple[int, int, int], Tuple[int, ...]]:
    """(shape, order) of ``make_pod_mesh`` over n ranks in ``n_slices``
    emulated slices: consecutive rank blocks form one slice each, laid out
    as the squarest grid of a slice, and the slices are concatenated along
    z, so the slice factor is the outermost of z (the emulated branch of
    hpgmg_tpu/parallel/mesh.py:make_pod_mesh). ``order`` lists the rank at
    each grid position in C order."""
    if n_slices < 1 or n % n_slices:
        raise ValueError(f"{n} ranks do not split into {n_slices} slices")
    per = n // n_slices
    per_slice = _factor3(per)
    arr = np.concatenate([np.arange(s * per, (s + 1) * per).reshape(per_slice)
                          for s in range(n_slices)], axis=2)
    return tuple(int(v) for v in arr.shape), tuple(int(r) for r in arr.reshape(-1))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (sx, sy, sz) grid of the default process
    group: ``order`` lists the rank at each grid position in C order (the
    device array of the JAX mesh, flattened); without one rank r sits at
    position r, (r // (sy sz), r // sz % sy, r % sz), as
    ``np.array(devices).reshape(shape)`` places device r. ``backend`` is
    the group's ("nccl" or "gloo"); ``device`` where this rank's tensors
    live."""

    shape: Tuple[int, int, int]
    rank: int
    backend: str
    device: torch.device
    order: Optional[Tuple[int, ...]] = None

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]

    def coords_of(self, rank: int) -> Tuple[int, int, int]:
        """The grid position (cx, cy, cz) of ``rank``."""
        pos = rank if self.order is None else self.order.index(rank)
        sy, sz = self.shape[1], self.shape[2]
        return pos // (sy * sz), pos // sz % sy, pos % sz

    @property
    def coords(self) -> Tuple[int, int, int]:
        return self.coords_of(self.rank)

    def rank_at(self, cx: int, cy: int, cz: int = 0) -> int:
        pos = (cx * self.shape[1] + cy) * self.shape[2] + cz
        return pos if self.order is None else self.order[pos]


def _group_mesh(shape, order, device, what: str) -> Mesh:
    """The Mesh of this rank of the initialized default process group.
    ``device`` defaults to the current CUDA device under NCCL, else the
    CPU."""
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialized process group")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(shape=tuple(shape), rank=dist.get_rank(), backend=backend,
                device=torch.device(device), order=order)


def make_mesh(device: Union[str, torch.device, None] = None) -> Mesh:
    """The 3D grid over the initialized default process group: the
    squarest (sx, sy, sz), rank r where ``np.array(devices).reshape(shape)``
    puts device r (counterpart of hpgmg_tpu/parallel/mesh.py:make_mesh)."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    return _group_mesh(_factor3(world), None, device, "make_mesh")


def make_mesh_ij(device: Union[str, torch.device, None] = None) -> Mesh:
    """The i/j grid over the initialized default process group (counterpart
    of hpgmg_tpu/parallel/mesh.py:make_mesh_ij)."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    return _group_mesh(mesh_ij_shape(world), None, device, "make_mesh_ij")


def make_pod_mesh(n_slices: Optional[int] = None,
                  device: Union[str, torch.device, None] = None) -> Mesh:
    """The pod layout over the initialized default process group: the
    ranks in ``n_slices`` emulated slices of consecutive ranks, the slice
    factor outermost on z (``pod_layout``), so a z-split level's exchanges
    cross a slice boundary at one plane a slice. None or 1 gives
    ``make_mesh``. Counterpart of hpgmg_tpu/parallel/mesh.py:make_pod_mesh
    with ``n_slices`` given; ``torch.distributed`` has no ``slice_index``,
    so the JAX branch that detects real slices and builds a hybrid device
    mesh has no counterpart here."""
    if n_slices is None or n_slices <= 1:
        return make_mesh(device)
    if not dist.is_initialized():
        raise RuntimeError("make_pod_mesh needs an initialized process group")
    shape, order = pod_layout(dist.get_world_size(), n_slices)
    return _group_mesh(shape, order, device, "make_pod_mesh")


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
    over i where ``split[0]``, over j where ``split[1]``, over k where
    ``split[2]`` (a pair: k whole; a split that keeps k whole is held as
    the pair, so that two Parts of one placement compare equal). Along an
    unsplit axis the block is the whole extent; ranks that differ only
    along unsplit axes hold the same block, and the one at coordinate 0
    there owns it (for reductions)."""

    mesh: Mesh
    split: Tuple[bool, ...]
    dim: int

    def __post_init__(self):
        split = tuple(bool(s) for s in self.split)
        if len(split) not in (2, 3):
            raise ValueError(f"split names 2 or 3 axes, got {self.split}")
        object.__setattr__(self, "split", split[:2] if len(split) == 3 and not split[2]
                           else split)

    @property
    def axes(self) -> Tuple[bool, bool, bool]:
        """Whether i, j and k are split."""
        return self.split + (False,) * (3 - len(self.split))

    @property
    def counts(self) -> Tuple[int, int, int]:
        """Blocks along i, j and k."""
        return tuple(self.mesh.shape[a] if self.axes[a] else 1 for a in range(3))

    @property
    def coords(self) -> Tuple[int, int, int]:
        c = self.mesh.coords
        return tuple(c[a] if self.axes[a] else 0 for a in range(3))

    @property
    def extents(self) -> Tuple[int, int, int]:
        """(ni, nj, nk): the block's cells along each axis."""
        return tuple(self.dim // c for c in self.counts)

    @property
    def offsets(self) -> Tuple[int, int, int]:
        """(oi, oj, ok): the block's first global cell."""
        return tuple(c * e for c, e in zip(self.coords, self.extents))

    @property
    def ni(self) -> int:
        return self.extents[0]

    @property
    def nj(self) -> int:
        return self.extents[1]

    @property
    def nk(self) -> int:
        return self.extents[2]

    @property
    def oi(self) -> int:
        return self.offsets[0]

    @property
    def oj(self) -> int:
        return self.offsets[1]

    @property
    def owner(self) -> bool:
        c = self.mesh.coords
        return all(self.axes[a] or c[a] == 0 for a in range(3))

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
        (oi, oj, ok), (ni, nj, nk) = self.offsets, self.extents
        return x[oi:oi + ni, oj:oj + nj, ok:ok + nk].clone(
            memory_format=torch.contiguous_format)


def level_part(mesh: Mesh, dim: int) -> Optional[Part]:
    """This rank's Part of a level of extent ``dim``; None where the level
    is replicated: where ``level_sharding`` replicates it, and where it
    splits it into blocks of an odd extent along any axis, which the slab
    kernels (K8a-K8d: even extents) do not take. The JAX package splits
    such a level through GSPMD; the port, which has no GSPMD, replicates
    it, with the same solution."""
    spec = level_sharding(mesh, dim)
    if spec == REPLICATED:
        return None
    part = Part(mesh, tuple(name in spec for name in MESH_AXES), dim)
    if any(e % 2 for e in part.extents):
        return None
    return part


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
    with scope("comm.all_gather"):
        dist.all_gather(bufs, src)
    out = torch.empty((part.dim,) * 3, dtype=x.dtype, device=src.device)
    for r, b in enumerate(bufs):
        p = dataclasses.replace(part, mesh=dataclasses.replace(mesh, rank=r))
        (oi, oj, ok), (ni, nj, nk) = p.offsets, p.extents
        out[oi:oi + ni, oj:oj + nj, ok:ok + nk] = b
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
    ``level_part``, which also replicates a level whose blocks would have
    an odd extent along any axis: the slab kernels do not take them, and
    the port has no GSPMD path). The BF16C views (``Level.kb16``) are
    one-rank only: every level drops them (hpgmg_tpu/parallel/mesh.py:214),
    and half-sweeps read the float32 ``kdinv`` again, so a level whose
    ``kdinv`` a slimmed hierarchy dropped for them cannot be cut. Every
    dtype is cut alike: a bfloat16 level keeps bf16 blocks, which the slab
    kernels' bf16 instantiations take."""
    import dataclasses

    from hpgmg_tpu_torch.core.hierarchy import Hierarchy
    from hpgmg_tpu_torch.parallel.shard_kernels import shard_level

    levels = []
    for lv in hier.levels:
        if lv.kb16 is not None:
            if lv.kdinv is None:
                raise ValueError(f"the {lv.dim}^3 level kept only its BF16C kdinv "
                                 f"(slim_hierarchy): cut the hierarchy before slimming it")
            lv = dataclasses.replace(lv, kb16=None)
        levels.append(shard_level(lv, level_part(mesh, lv.dim), cfg))
    return Hierarchy(levels=levels)


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
