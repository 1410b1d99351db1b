"""Operator-suite interface and registry (counterpart of
hpgmg_tpu/ops/base.py): the fv4 suite (``ops/fv4.py``) and the three
radius-1 suites fv7pt, fv2 and 27pt, which share ``RadiusOneSuite``."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict

import torch

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils_r1
from hpgmg_tpu_torch.parallel.shard_kernels import (r1_gsrb2_rhs_sharded,
                                                    r1_gsrb2_sharded, r1_sharded)


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


class RadiusOneSuite(OperatorSuite):
    """The dispatch of the radius-1 suites to K5 and K6 (counterpart of
    hpgmg_tpu/ops/base.py:RadiusOneKernelMixin). A suite sets
    ``taps_key`` (its Dirichlet ghost taps, ``stencils_r1.TAPS``) and
    ``var7`` (False: the 27pt body), and ends its ``rebuild_operator``
    with ``fold_kdinv``. Every apply, residual, half-sweep and residual
    restriction is one K5 call (K7b on a periodic level), so the black-box
    probes of the rebuild and the DIRECT bottom's identity probes run
    through it too; full GSRB sweeps go through K6 where
    ``stencils_r1.use_gsrb2`` admits the level. On a decomposed level
    (``level.part``) K8c and K8d take their places after the exchange.
    The levels keep the natural face arrays (beta_i (n+1, n, n)): the
    radius-1 flux reads no face outside the domain."""

    taps_key: str = "p1"
    var7: bool = True

    def _k5(self, level: Level, x, cfg: SolverConfig, mode: str, **kw):
        if level.part is not None:
            return r1_sharded(level, x, cfg, mode, self.taps_key, self.var7, **kw)
        return stencils_r1.r1_stencil(level, x, cfg, mode, self.taps_key,
                                      self.var7, **kw)

    def apply_op(self, level: Level, x, cfg: SolverConfig):
        return self._k5(level, x, cfg, "apply")

    def residual(self, level: Level, x, rhs, cfg: SolverConfig):
        return self._k5(level, x, cfg, "residual", rhs=rhs)

    def gsrb_sweep(self, level: Level, x, rhs, cfg: SolverConfig,
                   parity: int):
        return self._k5(level, x, cfg, "gsrb", rhs=rhs,
                        kdinv=level.kdinv[parity & 1])

    def gsrb_smooth(self, level: Level, x, rhs, cfg: SolverConfig,
                    nsweeps: int):
        """``nsweeps`` half-sweeps from parity 0: pairs of them as K6's
        full sweeps where the gate admits the level (Dirichlet only), else
        one K5 (K7b) launch each; on a decomposed level K8d's full sweeps
        where its ring views were cut (the same gate), else K8c's
        half-sweeps."""
        if level.part is not None:
            if nsweeps % 2 == 0 and level.ring is not None:
                rhs2 = r1_gsrb2_rhs_sharded(level.part, rhs)
                for _ in range(nsweeps // 2):
                    x = r1_gsrb2_sharded(level, x, rhs2, cfg, self.taps_key, self.var7)
                return x
            return super().gsrb_smooth(level, x, rhs, cfg, nsweeps)
        if (nsweeps % 2 == 0
                and stencils_r1.use_gsrb2(level.dim, self.var7, cfg.bc)):
            for _ in range(nsweeps // 2):
                x = stencils_r1.r1_gsrb2(level, x, rhs, cfg, self.taps_key,
                                         self.var7)
            return x
        return super().gsrb_smooth(level, x, rhs, cfg, nsweeps)

    def restrict_residual(self, level: Level, x, rhs, cfg: SolverConfig):
        return self._k5(level, x, cfg, "fres", rhs=rhs)

    @staticmethod
    def fold_kdinv(level: Level) -> Level:
        """Fold the GSRB parity masks into dinv (the GSRB_FP mask plane,
        gsrb.c:78-87, moved to build time; hpgmg_tpu/ops/base.py:209-210)."""
        kdinv = tuple(rb_mask(level.dim, p, level.dtype, level.device)
                      * level.dinv for p in (0, 1))
        return dataclasses.replace(level, kdinv=kdinv)


_REGISTRY: Dict[str, Callable[[], OperatorSuite]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


_SUITE_MODULES = {
    "fv7pt": "hpgmg_tpu_torch.ops.fv7pt",
    "fv2": "hpgmg_tpu_torch.ops.fv2",
    "fv4": "hpgmg_tpu_torch.ops.fv4",
    "27pt": "hpgmg_tpu_torch.ops.const27pt",
}


def get_suite(name: str) -> OperatorSuite:
    if name not in _REGISTRY and name in _SUITE_MODULES:
        importlib.import_module(_SUITE_MODULES[name])  # registers itself
    if name not in _REGISTRY:
        raise ValueError(f"unknown operator suite {name!r}; "
                         f"have {sorted(_SUITE_MODULES)}")
    return _REGISTRY[name]()
