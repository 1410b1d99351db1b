"""Level-wide reductions (counterpart of hpgmg_tpu/core/blas.py).

``norm`` is the max norm, matching the reference (misc.c:287). Results
are 0-d tensors on the input's device and dtype; ``dot`` and ``mean``
accumulate in ``reduce_dtype`` where one is given (``cfg.reduce_dtype``),
else in the input's dtype. Nothing here synchronizes.
"""

from __future__ import annotations

from typing import Optional

import torch


def dot(u: torch.Tensor, v: torch.Tensor,
        reduce_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    acc = reduce_dtype or u.dtype
    return torch.sum((u * v).to(acc)).to(u.dtype)


def norm(u: torch.Tensor) -> torch.Tensor:
    """Max norm (misc.c:287 reduces with MPI_MAX)."""
    return torch.max(torch.abs(u))


def mean(u: torch.Tensor,
         reduce_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    acc = reduce_dtype or u.dtype
    return (torch.sum(u.to(acc)) / u.numel()).to(u.dtype)
