"""Level-wide reductions (counterpart of hpgmg_tpu/core/blas.py).

``norm`` is the max norm, matching the reference (misc.c:287). Results
are 0-d tensors on the input's device, accumulated in the input's dtype:
nothing here synchronizes.
"""

from __future__ import annotations

import torch


def dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v)


def norm(u: torch.Tensor) -> torch.Tensor:
    """Max norm (misc.c:287 reduces with MPI_MAX)."""
    return torch.max(torch.abs(u))


def mean(u: torch.Tensor) -> torch.Tensor:
    return torch.sum(u) / u.numel()
