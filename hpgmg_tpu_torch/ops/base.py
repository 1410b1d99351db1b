"""Operator-suite interface and registry (counterpart of
hpgmg_tpu/ops/base.py). Only the fv4 suite is ported."""

from __future__ import annotations

import importlib
from typing import Callable, Dict

import torch

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level


class OperatorSuite:
    """What a suite provides to the solver; every method is the suite's."""

    name: str = "?"
    # names in the ops.transfer interpolation registry
    interpolation_vcycle: str
    interpolation_fcycle: str

    def apply_op(self, level: Level, x: torch.Tensor,
                 cfg: SolverConfig) -> torch.Tensor:
        """A(x) over the level interior; ghosts are synthesized inside."""
        raise NotImplementedError

    def residual(self, level: Level, x, rhs, cfg: SolverConfig):
        """rhs - A(x) (operators/residual.c:9-51)."""
        raise NotImplementedError

    def gsrb_sweep(self, level: Level, x, rhs, cfg: SolverConfig,
                   parity: int):
        """One red-black half-sweep, out of place: cells with
        (i+j+k) % 2 == parity take x + dinv * (rhs - A x)."""
        raise NotImplementedError

    def gsrb_smooth(self, level: Level, x, rhs, cfg: SolverConfig,
                    nsweeps: int):
        """``nsweeps`` half-sweeps; sweep s has parity s % 2."""
        for s in range(nsweeps):
            x = self.gsrb_sweep(level, x, rhs, cfg, s & 1)
        return x

    def restrict_residual(self, level: Level, x, rhs, cfg: SolverConfig):
        """restrict_cell(rhs - A x): the V-cycle's residual feeding the
        restriction (residual.c:9-51 then restriction.c:104)."""
        raise NotImplementedError

    def rebuild_operator(self, level: Level, cfg: SolverConfig) -> Level:
        """Return the level with dinv / l1inv / lambda_max (and whatever
        else the suite's stencil reads) populated."""
        raise NotImplementedError


_REGISTRY: Dict[str, Callable[[], OperatorSuite]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


_SUITE_MODULES = {"fv4": "hpgmg_tpu_torch.ops.fv4"}


def get_suite(name: str) -> OperatorSuite:
    if name not in _REGISTRY and name in _SUITE_MODULES:
        importlib.import_module(_SUITE_MODULES[name])  # registers itself
    if name not in _REGISTRY:
        raise ValueError(f"unknown operator suite {name!r}; "
                         f"have {sorted(_SUITE_MODULES)}")
    return _REGISTRY[name]()
