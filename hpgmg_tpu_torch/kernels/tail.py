"""K4: the coarse-ladder ("tail") halves of the fv4 V-cycle, each in one
launch over every tail level (counterpart of hpgmg_tpu/kernels/tail.py:
_down_kernel, entered through tail_down_call, and _up_kernel, entered
through tail_up_call).

The tail is the run of levels with TAIL_MIN_DIM <= dim <= TAIL_MAX_DIM
starting at a V-cycle's root, never including the bottom level. Below
32^3 a level's work is a few microseconds of device time against ~20
launches, each costing more host time than that; K4 does a whole descent
or climb in one launch (``csrc/tail.cu``):

* ``tail_down``: per level, ``nsweeps`` GSRB half-sweeps (from the given
  iterate on the first level, from zero below), then the restricted
  residual that is the next level's rhs (mg.c:1135-1150);
* ``tail_up``: per level from the coarsest, the v2 interpolation of the
  solution below added to the pre-smoothed iterate, then ``nsweeps``
  half-sweeps (mg.c:1152-1158).

CUDA tensors launch the kernels; CPU tensors take the plain versions, the
same steps through K1's plain version and ``ops/transfer_fv.py:interp_v2``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from hpgmg_tpu_torch.core.config import BC, Smoother, SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels.stencils import _check, _stream, fv4_stencil_plain
from hpgmg_tpu_torch.ops.transfer_fv import interp_v2

# V-cycles route their tail levels through K4; False keeps the level-by-level
# recursion (for A/B timing).
TAIL_FUSE = True
TAIL_MAX_DIM = 32  # levels with dim <= this fuse
TAIL_MIN_DIM = 8   # quartic ghosts need 4 cells, the v2 coarse grid 2
MAX_TAIL = 6       # levels per launch (csrc/tail.cu:kMaxTail)


def _fusible(lv: Level) -> bool:
    return (TAIL_MIN_DIM <= lv.dim <= TAIL_MAX_DIM and lv.dim % 2 == 0
            and lv.kdinv is not None)


def tail_span(levels: Sequence[Level], lev: int) -> int:
    """Number of consecutive fusible levels from ``lev``, never the bottom
    level (it has no level below to restrict to)."""
    span = 0
    for lv in levels[lev:-1]:
        if not _fusible(lv) or span == MAX_TAIL:
            break
        span += 1
    return span


def use_tail(op, cfg: SolverConfig, levels: Sequence[Level], lev: int) -> bool:
    """Whether the V-cycle at ``levels[lev]`` runs its tail through K4:
    fv4, Dirichlet, GSRB with an even half-sweep count, a non-empty span."""
    return (TAIL_FUSE and op.name == "fv4" and cfg.bc == BC.DIRICHLET
            and cfg.smoother == Smoother.GSRB
            and cfg.resolved_num_smooths(op) >= 1
            and not (cfg.helmholtz and levels[lev].alpha is None)
            and tail_span(levels, lev) >= 1)


def _check_tail(tail: Sequence[Level], cfg: SolverConfig, nsweeps: int,
                tensors: Sequence[Tuple[str, torch.Tensor, tuple]]):
    if not 1 <= len(tail) <= MAX_TAIL:
        raise ValueError(f"the tail kernels take 1..{MAX_TAIL} levels, got {len(tail)}")
    if nsweeps < 2 or nsweeps % 2:
        raise ValueError(f"the tail kernels take an even nsweeps >= 2, got {nsweeps}")
    for i, lv in enumerate(tail):
        if lv.kdinv is None:
            raise ValueError(f"tail level {lv.dim}^3 has no kdinv")
        if lv.dim < TAIL_MIN_DIM or lv.dim % 2 or (i and 2 * lv.dim != tail[i - 1].dim):
            raise ValueError(f"tail dims {[t.dim for t in tail]} do not halve "
                             f"from an even dim >= {TAIL_MIN_DIM}")
        probe = lv.kdinv[0]  # any tensor of the level's shape, dtype, device
        _check(lv, probe, cfg, "gsrb", probe, lv.kdinv)
    dev, dt = tail[0].device, tail[0].dtype
    for name, t, shape in tensors:
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}; "
                             f"want {shape} {dt} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _sweeps(lv: Level, x, rhs, cfg: SolverConfig, nsweeps: int):
    for s in range(nsweeps):
        x = fv4_stencil_plain(lv, x, cfg, "gsrb", rhs=rhs, kdinv=lv.kdinv[s & 1])
    return x


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def tail_down_plain(tail: Sequence[Level], e, rhs, cfg: SolverConfig,
                    nsweeps: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The plain version of K4's descent. Returns (pre-smoothed iterate per
    level, restricted residual per level = the rhs of the level below)."""
    _check_tail(tail, cfg, nsweeps, [("e", e, tail[0].shape),
                                     ("rhs", rhs, tail[0].shape)])
    tail_down_plain.calls += 1
    es, rhss = [], []
    x = e
    for lv in tail:
        x = _sweeps(lv, x, rhs, cfg, nsweeps)
        es.append(x)
        rhs = fv4_stencil_plain(lv, x, cfg, "fres", rhs=rhs)
        rhss.append(rhs)
        x = torch.zeros_like(rhs)
    return es, rhss


tail_down_plain.calls = 0


def _up_tensors(tail, es, rhss, u_bot):
    d = tail[-1].dim // 2
    return ([(f"es[{i}]", e, lv.shape) for i, (lv, e) in enumerate(zip(tail, es))]
            + [(f"rhss[{i}]", r, lv.shape) for i, (lv, r) in enumerate(zip(tail, rhss))]
            + [("u_bot", u_bot, (d, d, d))])


def tail_up_plain(tail: Sequence[Level], es, rhss, u_bot, cfg: SolverConfig,
                  nsweeps: int) -> torch.Tensor:
    """The plain version of K4's climb. ``es`` and ``rhss`` are each tail
    level's pre-smoothed iterate and rhs; returns the first level's
    post-smoothed solution."""
    if len(es) != len(tail) or len(rhss) != len(tail):
        raise ValueError("tail_up wants one iterate and one rhs per level")
    _check_tail(tail, cfg, nsweeps, _up_tensors(tail, es, rhss, u_bot))
    tail_up_plain.calls += 1
    u = u_bot
    for lv, e, rhs in reversed(list(zip(tail, es, rhss))):
        u = _sweeps(lv, interp_v2(u, 1.0, e, cfg.bc), rhs, cfg, nsweeps)
    return u


tail_up_plain.calls = 0


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _launch(down: bool, tail, cfg, nsweeps, per_level, src):
    """Call the C entry with ``per_level``: (rhs, e, res) per level."""
    from hpgmg_tpu_torch.kernels.build import library

    n0, dt, dev = tail[0].dim, tail[0].dtype, tail[0].device
    ptrs = []
    for lv, (rhs, e, res) in zip(tail, per_level):
        alpha = lv.alpha if cfg.helmholtz else None
        ptrs += [lv.beta_i.data_ptr(), lv.beta_j.data_ptr(), lv.beta_k.data_ptr(),
                 None if alpha is None else alpha.data_ptr(),
                 lv.kdinv[0].data_ptr(), lv.kdinv[1].data_ptr(),
                 rhs.data_ptr(), e.data_ptr(), res.data_ptr()]
    nlev = len(tail)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * nlev)(*[lv.dim for lv in tail])
    c_scales = (ctypes.c_double * nlev)(*[-cfg.b * lv.h2inv for lv in tail])
    xp = torch.empty((n0 + 4,) * 3, dtype=dt, device=dev)
    tmp = torch.empty((n0,) * 3, dtype=dt, device=dev)
    lib = library()
    name = f"hpgmg_tail_{'down' if down else 'up'}_{'f32' if dt == torch.float32 else 'f64'}"
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(c_ptrs, c_dims, c_scales, nlev, nsweeps,
                                float(cfg.a), src.data_ptr(), xp.data_ptr(),
                                tmp.data_ptr(), _stream(src))
    if rc != 0:
        raise RuntimeError(f"tail {'down' if down else 'up'} kernel launch "
                           f"failed: CUDA error {rc}")


def tail_down_cuda(tail: Sequence[Level], e, rhs, cfg: SolverConfig,
                   nsweeps: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Launch K4's descent (``csrc/tail.cu:tail_down_kernel``)."""
    _check_tail(tail, cfg, nsweeps, [("e", e, tail[0].shape),
                                     ("rhs", rhs, tail[0].shape)])
    if not e.is_cuda:
        raise ValueError(f"tail_down_cuda wants CUDA tensors, got {e.device}")
    es = [torch.empty(lv.shape, dtype=e.dtype, device=e.device) for lv in tail]
    rhss = [torch.empty((lv.dim // 2,) * 3, dtype=e.dtype, device=e.device)
            for lv in tail]
    _launch(True, tail, cfg, nsweeps, list(zip([rhs] + rhss[:-1], es, rhss)), e)
    tail_down_cuda.launches += 1
    return es, rhss


tail_down_cuda.launches = 0


def tail_up_cuda(tail: Sequence[Level], es, rhss, u_bot, cfg: SolverConfig,
                 nsweeps: int) -> torch.Tensor:
    """Launch K4's climb (``csrc/tail.cu:tail_up_kernel``)."""
    if len(es) != len(tail) or len(rhss) != len(tail):
        raise ValueError("tail_up wants one iterate and one rhs per level")
    _check_tail(tail, cfg, nsweeps, _up_tensors(tail, es, rhss, u_bot))
    if not u_bot.is_cuda:
        raise ValueError(f"tail_up_cuda wants CUDA tensors, got {u_bot.device}")
    outs = [torch.empty(lv.shape, dtype=u_bot.dtype, device=u_bot.device)
            for lv in tail]
    _launch(False, tail, cfg, nsweeps, list(zip(rhss, es, outs)), u_bot)
    tail_up_cuda.launches += 1
    return outs[0]


tail_up_cuda.launches = 0


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------

def tail_down(tail: Sequence[Level], e, rhs, cfg: SolverConfig, nsweeps: int):
    """K4's descent: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if e.is_cuda:
        return tail_down_cuda(tail, e, rhs, cfg, nsweeps)
    if e.device.type == "cpu":
        return tail_down_plain(tail, e, rhs, cfg, nsweeps)
    raise ValueError(f"tail_down has no kernel for device {e.device}")


def tail_up(tail: Sequence[Level], es, rhss, u_bot, cfg: SolverConfig,
            nsweeps: int):
    """K4's climb: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if u_bot.is_cuda:
        return tail_up_cuda(tail, es, rhss, u_bot, cfg, nsweeps)
    if u_bot.device.type == "cpu":
        return tail_up_plain(tail, es, rhss, u_bot, cfg, nsweeps)
    raise ValueError(f"tail_up has no kernel for device {u_bot.device}")
