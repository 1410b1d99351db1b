"""hpgmg_tpu_torch — the finite-volume multigrid solver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``hpgmg_tpu`` (JAX/XLA/Pallas) that mirrors its module paths:
``hpgmg_tpu_torch/core/config.py`` is the counterpart of
``hpgmg_tpu/core/config.py`` and so on. Plain tensor code is eager
PyTorch; every stencil application and cell restriction of the fv4
F-cycle runs through the CUDA kernels under ``kernels/csrc`` when its
tensors lie on a CUDA device, and through their plain PyTorch versions
when they lie on the CPU. ``parallel/`` runs the same F-cycle decomposed
over a 3D grid of ranks (``torch.distributed``, one process per rank).
"""

__version__ = "0.1.0"

from hpgmg_tpu_torch.core.config import (BC, BottomSolver, CycleType,
                                         Smoother, SolverConfig)
from hpgmg_tpu_torch.core.hierarchy import Hierarchy, build_hierarchy
from hpgmg_tpu_torch.core.level import Level

__all__ = [
    "BC",
    "Smoother",
    "BottomSolver",
    "CycleType",
    "SolverConfig",
    "Level",
    "Hierarchy",
    "build_hierarchy",
]
