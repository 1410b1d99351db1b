"""Reference element (counterpart of hpgmg_tpu/fe/reference.py, a copy:
numpy only): 1D basis, Gauss quadrature, fine-node interp weights.

Rebuild of FESetUp / FEBasisEval / DMFEGetTensorEval (grid.c:841-918):

* degree p in {1, 2}; P = p+1 nodes per axis on [-1, 1]
* Q = P + addquadpts Gauss points; B (Q x P) basis values, D (Q x P)
  derivatives (reference-coordinate)
* interp: weights filling the fine nodes NOT nested in the coarse grid —
  basis evaluated at q=0 (p=1) or q=-+1/2 (p=2) (grid.c:891-898)

All matrices are tiny numpy constants; ``FEOp`` keeps their tensors on
its device (fe/op.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def basis_eval(degree: int, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Lagrange basis values/derivatives at points q (reference interval
    [-1,1]; nodes at {-1,1} for p=1, {-1,0,1} for p=2) — FEBasisEval."""
    q = np.asarray(q, dtype=np.float64)
    if degree == 1:
        B = np.stack([(1 - q) / 2, (1 + q) / 2], axis=-1)
        D = np.stack([np.full_like(q, -0.5), np.full_like(q, 0.5)], axis=-1)
    elif degree == 2:
        B = np.stack([0.5 * (q * q - q), 1 - q * q, 0.5 * (q * q + q)],
                     axis=-1)
        D = np.stack([q - 0.5, -2 * q, q + 0.5], axis=-1)
    else:
        raise ValueError(f"unsupported degree {degree}")
    return B, D


@dataclasses.dataclass(frozen=True)
class ReferenceElement:
    degree: int
    addquadpts: int = 0

    @property
    def P(self) -> int:
        return self.degree + 1

    @property
    def Q(self) -> int:
        return self.degree + 1 + self.addquadpts

    def quadrature(self) -> Tuple[np.ndarray, np.ndarray]:
        """Q-point Gauss-Legendre rule on [-1, 1]."""
        x, w = np.polynomial.legendre.leggauss(self.Q)
        return x, w

    def tensors(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(B, D, w): Q x P basis/derivative matrices + quadrature weights."""
        x, w = self.quadrature()
        B, D = basis_eval(self.degree, x)
        return B, D, w

    def interp_weights(self) -> np.ndarray:
        """(degree, P) weights for the non-nested fine nodes inside one
        coarse element: p=1 -> midpoint q=0; p=2 -> q=-1/2, +1/2."""
        floc = {1: [0.0], 2: [-0.5, 0.5]}[self.degree]
        B, _ = basis_eval(self.degree, np.asarray(floc))
        return B
