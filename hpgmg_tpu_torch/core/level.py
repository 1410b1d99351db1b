"""Level representation (counterpart of hpgmg_tpu/core/level.py).

Each level is one dense array per field. Ghost zones are never stored:
the stencil synthesizes its boundary ghosts from the interior (in-kernel
on CUDA, by a separable extension in the plain version).

The face coefficients are plain face arrays, ``beta_i`` (n+1, n, n),
``beta_j`` (n, n+1, n), ``beta_k`` (n, n, n+1), as the radius-1 suites
(fv7pt, fv2, 27pt) keep them. The fv4 suite stores them *tangentially
extended* by one ghost layer, as ``FV4.rebuild_operator`` leaves them:
``beta_i`` (n+1, n+2, n+2), ``beta_j`` (n+2, n+1, n+2), ``beta_k``
(n+2, n+2, n+1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Level:
    """One grid level: geometry and operator coefficient fields.

    Solution, rhs and residual vectors are not stored here; the solver
    passes them as arguments.
    """

    dim: int
    h: float
    depth: int  # 0 = finest

    beta_i: torch.Tensor
    beta_j: torch.Tensor
    beta_k: torch.Tensor
    alpha: Optional[torch.Tensor] = None  # (n, n, n); None for pure Poisson
    dinv: Optional[torch.Tensor] = None  # (n, n, n) 1/diag(A)
    l1inv: Optional[torch.Tensor] = None  # (n, n, n) L1-Jacobi weights
    # 0-d tensor: Gershgorin bound on the dominant eigenvalue of D^-1 A
    lambda_max: Optional[torch.Tensor] = None
    # (dim^3, dim^3) dense inverse of the bottom operator (DIRECT bottom)
    bottom_ainv: Optional[torch.Tensor] = None
    # (red, black) dinv with the GSRB parity mask folded in: zeros at the
    # cells a half-sweep of that parity does not update
    kdinv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def shape(self):
        return (self.dim, self.dim, self.dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.beta_i.dtype

    @property
    def device(self) -> torch.device:
        return self.beta_i.device

    @property
    def h2inv(self) -> float:
        return 1.0 / (self.h * self.h)

    @property
    def ncells(self) -> int:
        return self.dim ** 3


def rb_mask(n: int, sweep_parity: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Red-black mask: 1.0 where cell (i,j,k) is updated on this half-sweep,
    i.e. where (i+j+k) % 2 == sweep_parity % 2 (gsrb.c:55,113)."""
    idx = torch.arange(n, device=device)
    parity = (idx.view(n, 1, 1) + idx.view(1, n, 1) + idx.view(1, 1, n)) & 1
    return (parity == (sweep_parity & 1)).to(dtype)
