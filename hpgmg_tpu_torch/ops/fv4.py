"""4th-order variable-coefficient operator suite (counterpart of
hpgmg_tpu/ops/fv4.py; reference operators.fv4.c), the HPGMG benchmark
operator.

A(u) = -b * div(beta grad u) on cell averages (operators.fv4.c:87-114):
per face a 4-wide flux ``beta_f * (15*(u_n - u_c) - (u_nn - u_opp)) / 12``
plus 12 mixed-derivative terms ``(dbeta_tangential) * (cross second
difference) / 48``. Radius 2, quartic volume-averaged BCs, black-box Dinv
with 4 colors per axis, v2 interpolation in V-cycles and v4 in F-cycles,
GSRB with 3 smooths.

On a level decomposed over a process grid (``level.part``) every apply,
residual and half-sweep goes through K8a (K8b under
``shard_kernels.OVERLAP``) after the slab exchange, and the residual
restriction is K8a's residual, then K3 on the local block (K8a has no
fres mode); K2c takes no decomposed level. Elsewhere every apply,
residual, half-sweep and residual restriction goes through
K1, or K7a on a periodic level (``kernels/stencils.py:fv4_stencil``, whose
plain version is ``stencil_ax`` there), and every full GSRB sweep on the
smaller Dirichlet levels through K2c (``fv4_gsrb2``). Under
``stencils.SUBTILE`` the levels ``stencils.use_subtile`` admits take K1s
(``fv4_subtile``) for their applies, residuals and half-sweeps instead,
and restrict their residual unfused (K1s residual, then K3), as the JAX
suite does (hpgmg_tpu/ops/fv4.py:194-195): K1s has no fres mode. A
level below 4^3 (``stencils.small_level``) takes the plain version on
every device (``fv4_small``), as the JAX package's XLA ops take it; no
kernel and no fused sweep takes it. With BF16C views on a level
(``Level.kb16``, attached where ``stencils.bf16c_active`` says) its gsrb
half-sweeps go through K1 with the bfloat16 coefficient streams.
"""

from __future__ import annotations

import dataclasses

from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils
from hpgmg_tpu_torch.kernels.restrict import restrict_cell
from hpgmg_tpu_torch.kernels.stencils import (bf16c_view, fv4_gsrb2, fv4_small,
                                              fv4_stencil, fv4_subtile)
from hpgmg_tpu_torch.ops import base
from hpgmg_tpu_torch.ops.bc_fv import extend_beta_tangential
from hpgmg_tpu_torch.ops.rebuild import rebuild_blackbox
from hpgmg_tpu_torch.parallel.shard_kernels import fv4_sharded


@base.register("fv4")
class FV4(base.OperatorSuite):
    name = "fv4"
    interpolation_vcycle = "v2"
    interpolation_fcycle = "v4"
    gsrb_num_smooths = 3
    chebyshev_degree = 6  # operators.fv4.c smoother wiring

    @staticmethod
    def _stencil(level: Level, x, cfg: SolverConfig, mode: str, parity=None, **kw):
        """K8a (K8b) on a decomposed level, the plain version on a level
        below 4^3, K1s where the gate admits the level, else K1 (K7a); each
        takes a half-sweep's ``parity`` and computes that colour's cells
        only."""
        if level.part is not None:
            return fv4_sharded(level, x, cfg, mode, parity=parity, **kw)
        if stencils.small_level(level):
            return fv4_small(level, x, cfg, mode, parity=parity, **kw)
        if stencils.use_subtile(level, cfg):
            return fv4_subtile(level, x, cfg, mode, parity=parity, **kw)
        return fv4_stencil(level, x, cfg, mode, parity=parity, **kw)

    def apply_op(self, level: Level, x, cfg: SolverConfig):
        return self._stencil(level, x, cfg, "apply")

    def residual(self, level: Level, x, rhs, cfg: SolverConfig):
        return self._stencil(level, x, cfg, "residual", rhs=rhs)

    def gsrb_sweep(self, level: Level, x, rhs, cfg: SolverConfig,
                   parity: int):
        if level.kb16 is not None:
            return fv4_stencil(bf16c_view(level), x, cfg, "gsrb", parity=parity & 1,
                               rhs=rhs, kdinv=level.kb16[3 + (parity & 1)])
        return self._stencil(level, x, cfg, "gsrb", parity=parity & 1, rhs=rhs,
                             kdinv=level.kdinv[parity & 1])

    def gsrb_smooth(self, level: Level, x, rhs, cfg: SolverConfig,
                    nsweeps: int):
        """``nsweeps`` half-sweeps from parity 0: pairs of them as K2c's
        full sweeps on Dirichlet levels of 4^3 up to
        ``stencils.GSRB2_MAX_DIM``, else one K1s, K1 or K7a launch (or
        plain half-sweep, below 4^3) each."""
        if (level.part is None and cfg.bc == BC.DIRICHLET and nsweeps % 2 == 0
                and not stencils.small_level(level)
                and level.dim <= stencils.GSRB2_MAX_DIM):
            for _ in range(nsweeps // 2):
                x = fv4_gsrb2(level, x, rhs, cfg)
            return x
        return super().gsrb_smooth(level, x, rhs, cfg, nsweeps)

    def restrict_residual(self, level: Level, x, rhs, cfg: SolverConfig):
        if level.part is None and stencils.small_level(level):
            return fv4_small(level, x, cfg, "fres", rhs=rhs)
        if level.part is not None or stencils.use_subtile(level, cfg):
            return restrict_cell(self._stencil(level, x, cfg, "residual", rhs=rhs))
        return fv4_stencil(level, x, cfg, "fres", rhs=rhs)

    def rebuild_operator(self, level: Level, cfg: SolverConfig) -> Level:
        """Extend the face coefficients tangentially once per level (the
        extrapolate_betas analog), probe the black-box diagonal through
        the suite's apply (K1 or K1s), then fold the GSRB parity masks into
        dinv (the GSRB_FP mask plane, gsrb.c:78-87, moved to build time),
        and attach the BF16C views where ``stencils.bf16c_active`` says."""
        lv = dataclasses.replace(
            level,
            beta_i=extend_beta_tangential(level.beta_i, 0, cfg.bc).contiguous(),
            beta_j=extend_beta_tangential(level.beta_j, 1, cfg.bc).contiguous(),
            beta_k=extend_beta_tangential(level.beta_k, 2, cfg.bc).contiguous(),
        )
        lv = rebuild_blackbox(self, lv, cfg, colors=4)
        kdinv = tuple(rb_mask(lv.dim, p, lv.dtype, lv.device) * lv.dinv
                      for p in (0, 1))
        kb16 = (stencils.kernel_views_bf16(lv, kdinv)
                if stencils.bf16c_active(lv.dim, lv.dtype, cfg.bc) else None)
        return dataclasses.replace(lv, kdinv=kdinv, kb16=kb16)
