"""Level-wide reductions (counterpart of hpgmg_tpu/core/blas.py).

``norm`` is the max norm, matching the reference (misc.c:287). Results
are 0-d tensors on the input's device and dtype; ``dot`` and ``mean``
accumulate in ``reduce_dtype`` where one is given (``cfg.reduce_dtype``),
else in the input's dtype. Nothing here synchronizes, except on a
decomposed level: given the level's ``part`` (parallel/mesh.py), the local
result is all-reduced over the ranks (SUM, or MAX for the max norm), each
block counted once (by its owner), so every rank gets the global value.
There a bfloat16 field's partial sums are kept in float32 through the
all-reduce and rounded once (``partial_dtype``), as one rank's
``torch.sum`` of a bf16 field accumulates in float32 and rounds once.
"""

from __future__ import annotations

from typing import Optional

import torch

from hpgmg_tpu_torch.utils.profiler import scope


def _all_reduce(t: torch.Tensor, part, op) -> torch.Tensor:
    """``t`` (this rank's contribution, of any shape) reduced over the
    ranks of ``part``; ``t`` itself without one."""
    if part is None:
        return t
    import torch.distributed as dist

    host = part.mesh.backend == "gloo"
    flat = t.detach().reshape(-1)
    buf = flat.cpu().clone() if host else flat.clone()
    with scope("comm.all_reduce"):
        dist.all_reduce(buf, op=op)
    return buf.to(t.device).reshape(t.shape)


def partial_dtype(acc: torch.dtype, part) -> torch.dtype:
    """The type a rank sums its part of a reduction in, and all-reduces:
    ``acc``, or float32 where ``acc`` is bfloat16 on a decomposed level
    (the ranks' partial sums rounded to bf16 before the all-reduce would
    round more often than one rank's sum)."""
    return torch.float32 if part is not None and acc == torch.bfloat16 else acc


def sum_over(t: torch.Tensor, part) -> torch.Tensor:
    """The sum over the ranks of ``part`` of each rank's partial sums ``t``
    (any shape), each block counted once (by its owner); ``t`` itself
    without a part."""
    import torch.distributed as dist

    if part is not None and not part.owner:
        t = torch.zeros_like(t)
    return _all_reduce(t, part, dist.ReduceOp.SUM)


def dot(u: torch.Tensor, v: torch.Tensor,
        reduce_dtype: Optional[torch.dtype] = None, part=None) -> torch.Tensor:
    acc = partial_dtype(reduce_dtype or u.dtype, part)
    return sum_over(torch.sum((u * v).to(acc)), part).to(u.dtype)


def norm(u: torch.Tensor, part=None) -> torch.Tensor:
    """Max norm (misc.c:287 reduces with MPI_MAX)."""
    import torch.distributed as dist

    return _all_reduce(torch.max(torch.abs(u)), part, dist.ReduceOp.MAX)


def mean(u: torch.Tensor, reduce_dtype: Optional[torch.dtype] = None,
         part=None) -> torch.Tensor:
    acc = partial_dtype(reduce_dtype or u.dtype, part)
    count = u.numel() if part is None else part.dim ** 3
    return (sum_over(torch.sum(u.to(acc)), part) / count).to(u.dtype)
