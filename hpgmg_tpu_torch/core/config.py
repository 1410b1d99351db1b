"""Runtime solver configuration (counterpart of hpgmg_tpu/core/config.py).

One frozen dataclass selects operator, smoother, bottom solver and cycle.
There is no kernel switch: the port dispatches on the device of the
tensors it is given (CUDA tensors launch the hand-written kernels, CPU
tensors take their plain PyTorch versions).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class BC(enum.Enum):
    """Boundary condition (reference: level.h:24-25)."""

    DIRICHLET = "dirichlet"  # homogeneous Dirichlet (u = 0 on the boundary)
    PERIODIC = "periodic"  # wrap ghosts; pure Poisson is singular


class Smoother(enum.Enum):
    GSRB = "gsrb"  # red-black Gauss-Seidel, GSRB_FP masked variant
    CHEBYSHEV = "chebyshev"  # degree-d polynomial (chebyshev.c:8-100)
    JACOBI = "jacobi"  # weighted, omega = 2/3 (jacobi.c:8-65)
    L1JACOBI = "l1jacobi"  # L1 row-sum weights (operators.test/l1jacobi.c)
    SYMGS = "symgs"  # symmetric red-black GS (operators.test/symgs.c)


class BottomSolver(enum.Enum):
    BICGSTAB = "bicgstab"  # Saad Alg 7.7 with diagonal preconditioning
    CG = "cg"  # diagonally-preconditioned CG (solvers/cg.c)
    CABICGSTAB = "cabicgstab"  # s-step communication-avoiding (cabicgstab.c)
    CACG = "cacg"  # s-step CG (cacg.c)
    SMOOTH = "smooth"  # smooth until converged (solvers.c fallback)
    # dense inverse of the coarsest operator, built at hierarchy build
    # time: every bottom solve is one small matvec
    DIRECT = "direct"


OPS = ("fv7pt", "fv2", "fv4", "27pt")


class CycleType(enum.Enum):
    V = "V"
    F = "F"


# GSRB smooths per pre/post smooth call; the fv2 and fv4 suites override
# GSRB to 3 (operators.fv2.c:132, operators.fv4.c smoother wiring)
_DEFAULT_NUM_SMOOTHS = {
    Smoother.GSRB: 2,
    Smoother.CHEBYSHEV: 1,
    Smoother.JACOBI: 6,
    Smoother.L1JACOBI: 8,
    Smoother.SYMGS: 2,
}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration of one multigrid solve.

    a, b: coefficients of ``a*alpha*u - b*div(beta grad u) = f``;
    ``helmholtz=False`` drops the ``a*alpha`` term (pure Poisson).
    dtype: the solve dtype (torch.float32, torch.float64 or torch.bfloat16,
    every suite and BC; a bf16 hierarchy runs on one rank: the slab kernels
    have no bf16 instantiation, ``parallel/mesh.py:shard_hierarchy``);
    every tensor the solver creates takes it explicitly.
    """

    op: str = "fv4"  # operator suite: fv7pt | fv2 | fv4 | 27pt
    bc: BC = BC.DIRICHLET
    helmholtz: bool = False
    a: float = 1.0
    b: float = 1.0

    smoother: Smoother = Smoother.GSRB
    # None => the operator suite's default (GSRB: 2 smooths, 3 for fv2/fv4)
    num_smooths: Optional[int] = None
    chebyshev_degree: Optional[int] = None  # None => suite default (4 or 6)

    bottom: BottomSolver = BottomSolver.DIRECT
    bottom_rtol: float = 1e-3  # MG_DEFAULT_BOTTOM_NORM (mg.h:18-19)
    bottom_max_iters: int = 200  # jMax in bicgstab.c:26
    cabicgstab_telescoping: bool = True  # s=1,2,4 telescoping (cabicgstab.c:50-54)

    cycle: CycleType = CycleType.F
    max_vcycles: int = 20  # MGSolve cap (mg.c:1176)
    post_f_vcycles: int = 0  # V-cycles after the F-cycle (mg.c:1246: none)
    rtol: float = 1e-10

    min_coarse_dim: int = 2  # coarsen while dims even and > this
    dtype: torch.dtype = torch.float32
    # dtype of the dot and mean accumulations (None: the solve dtype);
    # max-norms are exact in any dtype
    reduce_dtype: Optional[torch.dtype] = None

    def resolved_num_smooths(self, suite=None) -> int:
        if self.num_smooths is not None:
            return self.num_smooths
        if suite is not None and self.smoother == Smoother.GSRB:
            return getattr(suite, "gsrb_num_smooths",
                           _DEFAULT_NUM_SMOOTHS[self.smoother])
        return _DEFAULT_NUM_SMOOTHS[self.smoother]

    def resolved_chebyshev_degree(self, suite=None) -> int:
        if self.chebyshev_degree is not None:
            return self.chebyshev_degree
        return getattr(suite, "chebyshev_degree", 4) if suite is not None else 4

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown operator suite {self.op!r}; have {OPS}")
        if self.dtype not in (torch.float32, torch.float64, torch.bfloat16):
            raise ValueError(f"solve dtype must be float32, float64 or bfloat16, "
                             f"got {self.dtype}")
        if self.reduce_dtype not in (None, torch.float32, torch.float64):
            raise ValueError(f"reduce dtype must be None, float32 or float64, "
                             f"got {self.reduce_dtype}")
