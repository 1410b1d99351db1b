"""Level representation (counterpart of hpgmg_tpu/core/level.py).

Each level is one dense array per field. Ghost zones are never stored:
the stencil synthesizes its boundary ghosts from the interior (in-kernel
on CUDA, by a separable extension in the plain version).

On a level decomposed over a process grid (``part`` set, see
parallel/mesh.py) every field is this rank's cut: the cell fields
(ni, nj, nk), the face arrays with their margins cut from the global ones
(so interior margins hold the neighbours' true faces); ``dim`` stays the
global extent.

The face coefficients are plain face arrays, ``beta_i`` (n+1, n, n),
``beta_j`` (n, n+1, n), ``beta_k`` (n, n, n+1), as the radius-1 suites
(fv7pt, fv2, 27pt) keep them. The fv4 suite stores them *tangentially
extended* by one ghost layer, as ``FV4.rebuild_operator`` leaves them:
``beta_i`` (n+1, n+2, n+2), ``beta_j`` (n+2, n+1, n+2), ``beta_k``
(n+2, n+2, n+1).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Optional, Tuple

import torch

if TYPE_CHECKING:
    from hpgmg_tpu_torch.parallel.mesh import Part


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
    # BF16C (kernels/stencils.py): bfloat16 copies of beta_i, beta_j,
    # beta_k, kdinv[0] and kdinv[1], which K1's gsrb half-sweeps read in a
    # float32 solve; None where bf16c_active is false
    kb16: Optional[tuple] = None
    # on a level decomposed over a process grid (parallel/mesh.py): this
    # rank's part; every field above is then cut to it
    part: Optional["Part"] = None
    # K8d's ring views on such a level (kernels/stencils_r1.py:ring_views)
    ring: Optional[tuple] = None
    # launch plans made from this level's operands (``plan``); a new level,
    # from dataclasses.replace too, starts with none
    plans: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                    compare=False)

    def plan(self, key, make: Callable[[], Any]):
        """The launch plan ``make()`` returns for ``key``: made once, its
        operands checked then, and kept with the level, so that it goes
        when the level goes. A plan that also reads other levels or a
        config holds them, and ``key`` names them by id."""
        plan = self.plans.get(key)
        if plan is None:
            plan = self.plans[key] = make()
        return plan

    @property
    def shape(self):
        """The shape of this rank's cell fields."""
        if self.part is not None:
            return self.part.extents
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
