"""2nd-order variable-coefficient 7-point operator suite (counterpart of
hpgmg_tpu/ops/fv7pt.py; reference operators.7pt.c).

* stencil: A(u) = a*alpha*u - b * div(beta grad u) with the 7-point
  variable-coefficient flux, radius 1 (operators.7pt.c:49-89); the Poisson
  build drops the alpha term. Linear (odd-reflection) Dirichlet ghosts.
* rebuild_operator: analytic Dinv / L1inv / Gershgorin bound, with
  boundary-validity factors folding the linear Dirichlet BC into the
  diagonal (operators.7pt.c:95-252).
* transfers: piecewise-constant V-cycle interpolation (p0), trilinear
  F-cycle interpolation (p1) (operators.7pt.c:280-281).

The stencil and its plain version (``beta_laplacian``) live in
``kernels/stencils_r1.py``: every operator application runs through K5 and
every full GSRB sweep on the levels ``stencils_r1.GSRB2_MAX_DIM`` admits
through K6 (``ops/base.py:RadiusOneSuite``).
"""

from __future__ import annotations

import dataclasses

import torch

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.ops import base


def _valid_masks(n: int, bc: BC, dtype: torch.dtype, device: torch.device):
    """Per-axis low/high neighbour-validity factors (operators.7pt.c:158-172):
    a Dirichlet neighbour outside the domain is "invalid"; its linear ghost
    is minus the interior value, which folds into the diagonal as a factor
    (valid - 2). Under periodic BCs every neighbour is valid."""
    if bc == BC.PERIODIC:
        one = torch.ones(n, dtype=dtype, device=device)
        return one, one
    idx = torch.arange(n, device=device)
    return (idx > 0).to(dtype), (idx < n - 1).to(dtype)


@base.register("fv7pt")
class FV7pt(base.RadiusOneSuite):
    name = "fv7pt"
    interpolation_vcycle = "p0"
    interpolation_fcycle = "p1"
    taps_key = "p1"

    def rebuild_operator(self, level: Level, cfg: SolverConfig) -> Level:
        n = level.dim
        lo, hi = _valid_masks(n, cfg.bc, level.dtype, level.device)

        def along(m, axis):
            return m.reshape([-1 if a == axis else 1 for a in range(3)])

        vlo = [along(lo, a) for a in range(3)]
        vhi = [along(hi, a) for a in range(3)]
        bi_lo, bi_hi = level.beta_i[:-1], level.beta_i[1:]
        bj_lo, bj_hi = level.beta_j[:, :-1], level.beta_j[:, 1:]
        bk_lo, bk_hi = level.beta_k[:, :, :-1], level.beta_k[:, :, 1:]

        bh2 = cfg.b * level.h2inv
        # diagonal: each face term contributes -beta*(valid - 2) * b*h2inv
        aii = -bh2 * (
            bi_lo * (vlo[0] - 2.0) + bi_hi * (vhi[0] - 2.0)
            + bj_lo * (vlo[1] - 2.0) + bj_hi * (vhi[1] - 2.0)
            + bk_lo * (vlo[2] - 2.0) + bk_hi * (vhi[2] - 2.0)
        )
        if cfg.helmholtz:
            aii = aii + cfg.a * level.alpha
        # Gershgorin radius: sum of |off-diagonal| entries
        sum_abs = abs(bh2) * (
            torch.abs(bi_lo * vlo[0]) + torch.abs(bi_hi * vhi[0])
            + torch.abs(bj_lo * vlo[1]) + torch.abs(bj_hi * vhi[1])
            + torch.abs(bk_lo * vlo[2]) + torch.abs(bk_hi * vhi[2])
        )
        lam = torch.max((aii + sum_abs) / aii)
        # Baker et al. eq 6.5 switch (operators.7pt.c:221-224)
        l1inv = torch.where(aii >= 1.5 * sum_abs, 1.0 / aii,
                            1.0 / (aii + 0.5 * sum_abs))
        lv = dataclasses.replace(level, dinv=1.0 / aii, l1inv=l1inv,
                                 lambda_max=lam)
        return self.fold_kdinv(lv)
