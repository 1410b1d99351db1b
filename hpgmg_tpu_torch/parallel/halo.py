"""Halo exchange between the ranks of a decomposed level (counterpart of
hpgmg_tpu/parallel/halo.py).

Each exchange moves one axis's faces to the -/+ neighbours along that axis
(``exchange_faces``), one ``batch_isend_irecv`` per call; applied i, then
j, then k, each axis's faces taken from the block extended along the axes
before it, the edge and corner ghosts arrive transitively (the
shape-aware schedule of build_exchange_ghosts, level.c:498-531). The transport follows the group's backend: NCCL sends
the device tensors; gloo sends host copies (the copy to the host waits for
the stream that wrote the face) and the receiver copies back to its
device. Faces go in their own dtype (float32, float64 or bfloat16; gloo
and NCCL both carry bf16).

``exchange_local`` and the two explicit-communication demos below are the
JAX module's building blocks; the solver's own exchanges are the thin
slabs of ``parallel/shard_kernels.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from hpgmg_tpu_torch.core.config import BC
from hpgmg_tpu_torch.parallel.mesh import Part
from hpgmg_tpu_torch.utils.profiler import scope

# tags of the two directions (gloo matches by tag; NCCL by the order of
# the operations between a pair of ranks, which the order below keeps)
_UP, _DOWN = 0, 1


def _p2p(part: Part, sends: List[Tuple[torch.Tensor, int, int]],
         recvs: List[Tuple[torch.Tensor, int, int]]) -> List[torch.Tensor]:
    """Post every send (tensor, peer, tag) and receive (like-tensor, peer,
    tag) as one batch, wait, and return the received tensors on the
    like-tensors' device."""
    host = part.mesh.backend == "gloo"
    bufs = [torch.empty(t.shape, dtype=t.dtype, device="cpu" if host else t.device)
            for t, _, _ in recvs]
    ops = [dist.P2POp(dist.isend, t.contiguous().cpu() if host else t.contiguous(),
                      peer, tag=tag) for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, b, peer, tag=tag)
            for b, (_, peer, tag) in zip(bufs, recvs)]
    if ops:
        with scope("comm.p2p"):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    return [b.to(t.device) if host else b for b, (t, _, _) in zip(bufs, recvs)]


def exchange_faces(part: Optional[Part], axis: int, lo_face: torch.Tensor,
                   hi_face: torch.Tensor,
                   periodic: bool) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(ghost_lo, ghost_hi) along ``axis`` (0: i, 1: j, 2: k): the -1 neighbour's
    high face and the +1 neighbour's low face. None on a side that is a
    domain face (unless ``periodic``); along an unsplit axis the wrap of
    this rank's own faces, or (None, None)."""
    if part is None or part.counts[axis] == 1:
        return (hi_face, lo_face) if periodic else (None, None)
    lo_nb = part.neighbor(axis, -1, periodic)
    hi_nb = part.neighbor(axis, +1, periodic)
    sends, recvs, got = [], [], [None, None]
    if hi_nb is not None:  # my high face goes up, my high ghost comes down
        sends.append((hi_face, hi_nb, _UP))
    if lo_nb is not None:
        sends.append((lo_face, lo_nb, _DOWN))
    if lo_nb is not None:
        recvs.append((hi_face, lo_nb, _UP))
    if hi_nb is not None:
        recvs.append((lo_face, hi_nb, _DOWN))
    out = iter(_p2p(part, sends, recvs))
    if lo_nb is not None:
        got[0] = next(out)
    if hi_nb is not None:
        got[1] = next(out)
    return got[0], got[1]


def _exchange_axis(x_local: torch.Tensor, part: Optional[Part], axis: int,
                   radius: int, periodic: bool) -> torch.Tensor:
    """``x_local`` extended by ``radius`` ghosts along ``axis``: the
    neighbours' faces, the wrap, or zeros at a Dirichlet domain face (the
    caller's BC fill overwrites them)."""
    n = x_local.shape[axis]
    lo_face = x_local.narrow(axis, 0, radius)
    hi_face = x_local.narrow(axis, n - radius, radius)
    glo, ghi = exchange_faces(part, axis, lo_face, hi_face, periodic)
    glo = torch.zeros_like(lo_face) if glo is None else glo
    ghi = torch.zeros_like(hi_face) if ghi is None else ghi
    return torch.cat([glo, x_local, ghi], dim=axis)


def exchange_local(x_local: torch.Tensor, part: Optional[Part], radius: int,
                   bc: BC) -> torch.Tensor:
    """This rank's block extended by ``radius`` ghosts on every axis, i then
    j then k, so edge and corner ghosts arrive transitively (the exchange
    body of hpgmg_tpu/parallel/halo.py:exchange_local)."""
    periodic = bc == BC.PERIODIC
    for axis in range(3):
        x_local = _exchange_axis(x_local, part, axis, radius, periodic)
    return x_local


def halo_exchange(part: Optional[Part], x_local: torch.Tensor, radius: int = 1,
                  bc: BC = BC.PERIODIC) -> torch.Tensor:
    """Exchange the ghost zones of this rank's block: the block extended by
    ``radius`` on every axis (counterpart of halo.py:halo_exchange, which
    takes the sharded global array; here each rank passes its own block)."""
    return exchange_local(x_local, part, radius, bc)


def apply_poisson7_explicit(part: Optional[Part], x_local: torch.Tensor, h2inv: float,
                            bc: BC = BC.PERIODIC) -> torch.Tensor:
    """Constant-coefficient 7-point A(u) = -h2inv*(sum(neighbours) - 6u) with
    explicit communication: the halo exchange, then the purely local
    stencil (exchange_boundary.c:12-117 + apply_op.c:9)."""
    g = exchange_local(x_local, part, 1, bc)
    c = g[1:-1, 1:-1, 1:-1]
    neigh = (g[:-2, 1:-1, 1:-1] + g[2:, 1:-1, 1:-1]
             + g[1:-1, :-2, 1:-1] + g[1:-1, 2:, 1:-1]
             + g[1:-1, 1:-1, :-2] + g[1:-1, 1:-1, 2:])
    return -h2inv * (neigh - 6.0 * c)


def jacobi_sweeps_explicit(part: Optional[Part], x_local: torch.Tensor,
                           rhs_local: torch.Tensor, h2inv: float, sweeps: int,
                           bc: BC = BC.PERIODIC,
                           weight: float = 2.0 / 3.0) -> torch.Tensor:
    """Weighted-Jacobi smoothing on the explicit-communication apply
    (jacobi.c:8-65 with an exchange per sweep)."""
    dinv = 1.0 / (6.0 * h2inv)
    for _ in range(sweeps):
        ax = apply_poisson7_explicit(part, x_local, h2inv, bc)
        x_local = x_local + weight * dinv * (rhs_local - ax)
    return x_local
