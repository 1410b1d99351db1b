"""4th-order constant-coefficient dense 27-point suite (counterpart of
hpgmg_tpu/ops/const27pt.py; reference operators.27pt.c).

A(u) = a*u - b*h2inv * (sum of the 27 neighbours weighted {-128, 14, 3,
1}/30 for {center, face, edge, corner}) (operators.27pt.c:48-92); the a*u
term is always added, whatever ``cfg.helmholtz`` says. Cell-centered
quadratic Dirichlet ghosts (apply_BCs_p2), p2 interpolation in both
cycles, the black-box rebuild with 2 colors, GSRB with 2 smooths, problem
p6. The beta arrays are carried but unused (constant coefficient). The
weights and the stencil (``C0``..``C3``, ``laplacian_27pt``) live in
``kernels/stencils_r1.py``, beside K5 and K6 that apply it.
"""

from __future__ import annotations

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.ops import base
from hpgmg_tpu_torch.ops.rebuild import rebuild_blackbox


@base.register("27pt")
class Const27pt(base.RadiusOneSuite):
    name = "27pt"
    interpolation_vcycle = "p2"
    interpolation_fcycle = "p2"
    gsrb_num_smooths = 2
    chebyshev_degree = 4
    taps_key = "27pt"
    var7 = False

    def rebuild_operator(self, level: Level, cfg: SolverConfig) -> Level:
        return self.fold_kdinv(rebuild_blackbox(self, level, cfg, colors=2))
