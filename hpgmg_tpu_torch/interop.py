"""Carry levels built elsewhere (numpy copies of the JAX package's level
fields) into the port: FV levels into a ``Hierarchy``
(``hierarchy_from_numpy``), FE levels into ``FELevel``s
(``fe_levels_from_numpy``).

Each level is a mapping with ``dim``, ``h``, ``depth`` and numpy arrays for
the fields it has: ``beta_i/j/k`` as the JAX ``rebuild_operator`` leaves
them (tangentially extended for fv4, the natural (n+1, n, n) face arrays
for the radius-1 suites fv7pt, fv2 and 27pt), ``alpha``, ``dinv``,
``l1inv``, ``kdinv`` (a pair), ``lambda_max`` and ``bottom_ainv``. Arrays are copied (``torch.tensor``),
not shared: a zero-copy DLPack export of a JAX CPU array fails with
"Cannot export readonly array". Where a level has ``dinv`` but no
``kdinv`` (the JAX package attaches it only to its kernel levels), the
parity-folded pair is rebuilt from ``dinv``. The JAX package's TPU kernel
views (``kbi``, ``k2`` and the like) are not carried: the port's kernels
read the face arrays themselves.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.hierarchy import Hierarchy
from hpgmg_tpu_torch.core.level import Level, rb_mask

_FIELDS = ("beta_i", "beta_j", "beta_k", "alpha", "dinv", "l1inv",
           "lambda_max", "bottom_ainv")


def hierarchy_from_numpy(levels: Sequence[Mapping[str, Any]],
                         cfg: SolverConfig, device) -> Hierarchy:
    device = torch.device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=cfg.dtype, device=device)

    out = []
    for lv in levels:
        kw = {f: tensor(lv[f]) for f in _FIELDS if lv.get(f) is not None}
        n = int(lv["dim"])
        if lv.get("kdinv") is not None:
            kw["kdinv"] = tuple(tensor(k) for k in lv["kdinv"])
        elif "dinv" in kw:
            kw["kdinv"] = tuple(rb_mask(n, p, cfg.dtype, device) * kw["dinv"]
                                for p in (0, 1))
        out.append(Level(dim=n, h=float(lv["h"]), depth=int(lv["depth"]), **kw))
    return Hierarchy(levels=out)


def fe_levels_from_numpy(levels: Sequence[Mapping[str, Any]], grid,
                         device, dtype) -> list:
    """The port's ``FELevel``s of ``grid``'s ladder (fine to coarse) from
    numpy copies of the JAX package's FELevel fields: one mapping a level
    with ``coords``, ``dinv``, ``metric_a`` and ``metric_w``."""
    from hpgmg_tpu_torch.fe.fas import FELevel

    grids = [grid]
    while grids[-1].can_coarsen():
        grids.append(grids[-1].coarsen())
    if len(levels) != len(grids):
        raise ValueError(f"{len(levels)} levels for a ladder of {len(grids)}")

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return [FELevel(grid=g, **{f: tensor(lv[f]) for f in
                               ("coords", "dinv", "metric_a", "metric_w")})
            for g, lv in zip(grids, levels)]
