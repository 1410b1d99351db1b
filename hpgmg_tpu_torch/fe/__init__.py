"""HPGMG-FE in PyTorch (counterpart of hpgmg_tpu/fe/): the Q1/Q2
matrix-free FAS full multigrid, its placement over the 3D process grid
(``fe/mesh.py``), its sampler and its action CLI
(``python -m hpgmg_tpu_torch.fe.cli``)."""

from hpgmg_tpu_torch.fe.grid import FEGrid
from hpgmg_tpu_torch.fe.op import FEOp, get_fe_op
from hpgmg_tpu_torch.fe.fas import (build_fe_levels, fas_fcycle, fas_vcycle,
                                    run_fmg, diagnostics)
from hpgmg_tpu_torch.fe.mesh import (FEPart, gather_fe_field, shard_fe_field,
                                     shard_fe_levels)
from hpgmg_tpu_torch.fe.sampler import run_sample

__all__ = ["FEGrid", "FEOp", "get_fe_op", "build_fe_levels", "fas_fcycle",
           "fas_vcycle", "run_fmg", "diagnostics", "FEPart", "gather_fe_field",
           "shard_fe_field", "shard_fe_levels", "run_sample"]
