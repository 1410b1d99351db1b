"""2nd-order volume-averaged operator suite (counterpart of
hpgmg_tpu/ops/fv2.py; reference operators.fv2.c).

The 7-point variable-coefficient flux stencil of fv7pt
(operators.fv2.c:55-92) with:

* quadratic volume-averaged Dirichlet ghosts (apply_BCs_v2:
  g = -5/2 x1 + 1/2 x2, ``ops/bc_fv.py``);
* the black-box Dinv rebuild with 2 colors per axis
  (operators.fv2.c:122), whose probes run through K5;
* v2 interpolation in both V- and F-cycles (operators.fv2.c:155-156);
* GSRB with 3 smooths (operators.fv2.c:132);
* the cell-averaged sine problem (``problems/fv.py``).
"""

from __future__ import annotations

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.ops import base
from hpgmg_tpu_torch.ops.rebuild import rebuild_blackbox


@base.register("fv2")
class FV2(base.RadiusOneSuite):
    name = "fv2"
    interpolation_vcycle = "v2"
    interpolation_fcycle = "v2"
    gsrb_num_smooths = 3
    chebyshev_degree = 6  # operators.fv2.c:136
    taps_key = "v2"

    def rebuild_operator(self, level: Level, cfg: SolverConfig) -> Level:
        return self.fold_kdinv(rebuild_blackbox(self, level, cfg, colors=2))
