"""Level-wide reductions (counterpart of hpgmg_tpu/core/blas.py).

``norm`` is the max norm, matching the reference (misc.c:287). Results
are 0-d tensors on the input's device and dtype; ``dot`` and ``mean``
accumulate in ``reduce_dtype`` where one is given (``cfg.reduce_dtype``),
else in the input's dtype. Nothing here synchronizes, except on a
decomposed level: given the level's ``part`` (parallel/mesh.py), the local
result is all-reduced over the ranks (SUM, or MAX for the max norm), each
block counted once (by its owner), so every rank gets the global value.
"""

from __future__ import annotations

from typing import Optional

import torch

from hpgmg_tpu_torch.utils.profiler import scope


def _all_reduce(t: torch.Tensor, part, op) -> torch.Tensor:
    """``t`` (this rank's contribution) reduced over the ranks of ``part``;
    ``t`` itself without one."""
    if part is None:
        return t
    import torch.distributed as dist

    host = part.mesh.backend == "gloo"
    buf = t.detach().reshape(1).cpu() if host else t.detach().reshape(1).clone()
    with scope("comm.all_reduce"):
        dist.all_reduce(buf, op=op)
    return buf.to(t.device).reshape(())


def _sum(t: torch.Tensor, part) -> torch.Tensor:
    import torch.distributed as dist

    if part is not None and not part.owner:
        t = torch.zeros_like(t)
    return _all_reduce(t, part, dist.ReduceOp.SUM)


def dot(u: torch.Tensor, v: torch.Tensor,
        reduce_dtype: Optional[torch.dtype] = None, part=None) -> torch.Tensor:
    acc = reduce_dtype or u.dtype
    return _sum(torch.sum((u * v).to(acc)), part).to(u.dtype)


def norm(u: torch.Tensor, part=None) -> torch.Tensor:
    """Max norm (misc.c:287 reduces with MPI_MAX)."""
    import torch.distributed as dist

    return _all_reduce(torch.max(torch.abs(u)), part, dist.ReduceOp.MAX)


def mean(u: torch.Tensor, reduce_dtype: Optional[torch.dtype] = None,
         part=None) -> torch.Tensor:
    acc = reduce_dtype or u.dtype
    count = u.numel() if part is None else part.dim ** 2 * u.shape[2]
    return (_sum(torch.sum(u.to(acc)), part) / count).to(u.dtype)
