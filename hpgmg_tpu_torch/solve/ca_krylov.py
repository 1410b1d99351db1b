"""Communication-avoiding Krylov bottom solvers, CABiCGStab and CACG
(counterpart of hpgmg_tpu/solve/ca_krylov.py; reference
solvers/cabicgstab.c, Carson/Demmel/Knight s-step BiCGStab Alg 3.4, and
solvers/cacg.c).

Per outer iteration the method forms the monomial basis vectors
[P, A P, ..., R, A R, ...] (4s+1 for CABiCGStab, 2s+1 for CACG), one
Gram-like matrix G of their inner products (one reduction: a
``torch.matmul`` of the flattened basis, as the JAX package's XLA einsum,
TF32 off), then s inner iterations on tiny (4s+1)-dim recurrences, which
stay on the device. The breakdown and convergence "break"s of the inner
loop are masked updates through an ``active`` flag, preserving the
reference's exact exit semantics; the outer loop reads its flags on the
host once per outer iteration.

CABiCGStab telescopes s = 1, 2, then 4 (cabicgstab.c:49-54) unless
``cfg.cabicgstab_telescoping`` is off.

On a decomposed bottom level (``level.part``) each rank forms the basis
on its block and the local Gram matrix, which one all-reduce sums over
the ranks (``blas.sum_over``), as the setup's dots and norms are; the
tiny recurrences then run alike on every rank, so all take the same
branches.

f32 robustness, the SCALED monomial basis: the raw powers A^{2s} r grow
like ||A||^{2s} and their Gram squares overflow f32 (the reference is
f64-only). Each power is divided by a per-solve power-of-two bound
sigma >= ~||A|| from one Rayleigh probe at setup, and sigma is folded into
the shift matrices (A v_i = sigma v_{i+1}); the recurrences are invariant
under the rescale and a power-of-two sigma makes it lossless.
"""

from __future__ import annotations

import numpy as np
import torch

from hpgmg_tpu_torch.core import blas
from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level

CA_KRYLOV_S = 4  # cabicgstab.c:18
_M_MAX = 200


def _monomial_shift(k: int, splits, power: int, sigma: torch.Tensor):
    """sigma^power * T' (power 1) or T'' (power 2) for the monomial basis:
    the shift by ``power`` within each of the index blocks ``splits``
    (cabicgstab.c:112-117)."""
    t = np.zeros((k, k))
    for lo, hi in splits:
        for i in range(lo, hi - power + 1):
            if i + power < k:
                t[i + power, i] = 1.0
    return sigma ** power * torch.tensor(t, dtype=sigma.dtype, device=sigma.device)


def _basis_scale(op, level: Level, cfg: SolverConfig, r):
    """Power-of-two upper-bound estimate of ||A|| from one Rayleigh probe
    (||A r|| / ||r||, x4 safety): one setup-time reduction per solve that
    keeps every scaled power O(||r||)."""
    nr = blas.norm(r, level.part)
    na = blas.norm(op.apply_op(level, r, cfg), level.part)
    pos = nr > 0
    est = torch.where(pos, 4.0 * na / torch.where(pos, nr, torch.ones_like(nr)),
                      torch.ones_like(nr))
    est = torch.clamp(est, min=1.0)
    return torch.exp2(torch.ceil(torch.log2(est))).to(r.dtype)


def _powers(op, level: Level, cfg: SolverConfig, v, count: int, inv_sigma):
    """[v, A v / sigma, ..., (A / sigma)^count v]."""
    out = [v]
    for _ in range(count):
        out.append(inv_sigma * op.apply_op(level, out[-1], cfg))
    return out


def _gram(rows: torch.Tensor, cols: torch.Tensor, reduce_dtype, part=None):
    """G[a, b] = <rows[a], cols[b]>: one matrix product, one reduction
    (summed over the ranks of ``part``)."""
    acc = blas.partial_dtype(reduce_dtype or rows.dtype, part)
    fr = rows.reshape(rows.shape[0], -1).to(acc)
    fc = cols.reshape(cols.shape[0], -1).to(acc)
    return blas.sum_over(fr @ fc.t(), part).to(rows.dtype)


def _combine(coeff: torch.Tensor, basis: torch.Tensor):
    """sum_i coeff[i] * basis[i] over the stacked basis."""
    return (coeff @ basis.reshape(basis.shape[0], -1)).reshape(basis.shape[1:])


def _unit(k: int, i: int, like: torch.Tensor):
    e = torch.zeros((k,), dtype=like.dtype, device=like.device)
    e[i] = 1.0
    return e


def _cabicgstab_sstep(op, level: Level, cfg: SolverConfig, s: int, st: dict,
                      rt, l2_rt, sigma):
    """One outer s-step: the 4s+1 basis, one Gram reduction, s inner
    iterations (cabicgstab.c:101-277). ``st`` holds x, p, r, delta, m,
    failed, converged; returns the next state."""
    k = 4 * s + 1
    tp = _monomial_shift(k, [(0, 2 * s), (2 * s + 1, 4 * s)], 1, sigma)
    tpp = _monomial_shift(k, [(0, 2 * s - 1), (2 * s + 1, 4 * s - 1)], 2, sigma)

    # scaled monomial matrix powers (cabicgstab.c:124-143)
    inv_sigma = 1.0 / sigma
    basis = torch.stack(_powers(op, level, cfg, st["p"], 2 * s, inv_sigma)
                        + _powers(op, level, cfg, st["r"], 2 * s - 1, inv_sigma))
    gg = _gram(basis, torch.cat([basis, rt[None]]), cfg.reduce_dtype, level.part)
    G, g = gg[:, :k], gg[:, k]

    aj = _unit(k, 0, rt)
    cj = _unit(k, 2 * s + 1, rt)
    ej = torch.zeros_like(aj)
    delta = st["delta"]
    was_active = ~(st["failed"] | st["converged"])
    active = was_active
    failed, converged = st["failed"], st["converged"]
    target = cfg.bottom_rtol * l2_rt

    for _ in range(s):
        tpaj = tp @ aj
        tpcj = tp @ cj
        tppaj = tpp @ aj
        g_dot_tpaj = g @ tpaj
        alpha = delta / g_dot_tpaj
        fail_now = (g_dot_tpaj == 0.0) | ~torch.isfinite(alpha)  # pivot breakdown
        alpha_s = torch.where(fail_now, 0.0, alpha)

        # omega via the numerically preferred grouping (cabicgstab.c:184-189)
        t1 = tpcj - alpha_s * tppaj
        t2 = G @ t1
        t3 = cj - alpha_s * tpaj
        omega_num = t3 @ t2
        omega_den = t1 @ t2

        # the partial ej update precedes the omega checks (cabicgstab.c:195)
        ej_half = ej + alpha_s * aj

        # ||s|| through the Gram matrix (cabicgstab.c:199-202)
        l2_s = torch.sqrt(torch.clamp(t3 @ (G @ t3), min=0.0))
        conv_now = l2_s < target

        omega = omega_num / omega_den
        fail_omega = (omega_den == 0.0) | ~torch.isfinite(omega)
        omega_s = torch.where(fail_omega, 0.0, omega)

        ej_full = ej_half + omega_s * cj - omega_s * alpha_s * tpaj
        cj_full = cj - omega_s * tpcj - alpha_s * tpaj + omega_s * alpha_s * tppaj

        # incremental residual norm (cabicgstab.c:230-237)
        l2_r = torch.sqrt(torch.clamp(cj_full @ (G @ cj_full), min=0.0))
        conv_late = l2_r < target

        delta_next = g @ cj_full
        beta = (delta_next / delta) * (alpha_s / omega_s)
        fail_late = (~torch.isfinite(delta_next) | (delta_next == 0.0)
                     | (omega_s == 0.0) | ~torch.isfinite(beta) | (beta == 0.0))
        aj_next = cj_full + beta * aj - omega_s * beta * tpaj

        # commit with break semantics: once failed or converged, freeze
        step_done = fail_now | conv_now | fail_omega | conv_late | fail_late
        ej = torch.where(active, torch.where(fail_now, ej, torch.where(
            conv_now | fail_omega, ej_half, ej_full)), ej)
        cj = torch.where(active & ~(fail_now | conv_now | fail_omega), cj_full, cj)
        aj = torch.where(active & ~step_done, aj_next, aj)
        delta = torch.where(active & ~step_done, delta_next, delta)
        failed = failed | (active & (fail_now | fail_omega | (~conv_late & fail_late)))
        converged = converged | (active & (conv_now | conv_late))
        active = active & ~step_done

    cont = was_active & ~(failed | converged)
    return {"x": torch.where(was_active, st["x"] + _combine(ej, basis), st["x"]),
            "p": torch.where(cont, _combine(aj, basis), st["p"]),
            "r": torch.where(cont, _combine(cj, basis), st["r"]),
            "delta": delta, "m": st["m"] + s, "failed": failed,
            "converged": converged}


def _done(st: dict) -> bool:
    """The outer loop's exit test, read on the host."""
    return st["m"] >= _M_MAX or bool(st["failed"] | st["converged"])


def cabicgstab(op, level: Level, x, rhs, cfg: SolverConfig,
               must_subtract_mean: bool = False):
    """s-step BiCGStab (cabicgstab.c): telescoping s = 1, 2 prologue
    steps, then s = 4 until converged, failed or 200 inner steps."""
    rd, part = cfg.reduce_dtype, level.part
    rt = op.residual(level, x, rhs, cfg)
    if must_subtract_mean:
        rt = rt - blas.mean(rt, rd, part)
    delta = blas.dot(rt, rt, rd, part)
    l2_rt = torch.sqrt(delta)
    sigma = _basis_scale(op, level, cfg, rt)
    st = {"x": x, "p": rt, "r": rt, "delta": delta, "m": 0,
          "failed": torch.zeros((), dtype=torch.bool, device=x.device),
          "converged": (blas.norm(rt, part) == 0.0) | (delta == 0.0)}
    steps = [1, 2] if cfg.cabicgstab_telescoping else []
    while True:
        s = steps.pop(0) if steps else CA_KRYLOV_S
        if s == CA_KRYLOV_S and _done(st):
            break
        if s != CA_KRYLOV_S and bool(st["failed"] | st["converged"]):
            continue  # a frozen state passes the prologue unchanged
        st = _cabicgstab_sstep(op, level, cfg, s, st, rt, l2_rt, sigma)
    return st["x"]


def _cacg_step(op, level: Level, cfg: SolverConfig, st: dict, tp, target,
               inv_sigma):
    """One outer s-step of CACG: 2s+1 basis vectors, one Gram reduction,
    s inner iterations (cacg.c:126-156)."""
    s, k = CA_KRYLOV_S, 2 * CA_KRYLOV_S + 1
    basis = torch.stack(_powers(op, level, cfg, st["p"], s, inv_sigma)
                        + _powers(op, level, cfg, st["r"], s - 1, inv_sigma))
    G = _gram(basis, basis, cfg.reduce_dtype, level.part)

    aj = _unit(k, 0, basis)
    cj = _unit(k, s + 1, basis)
    ej = torch.zeros_like(aj)
    active = torch.ones((), dtype=torch.bool, device=basis.device)
    failed = torch.zeros_like(active)
    converged = torch.zeros_like(active)
    for _ in range(s):
        tpaj = tp @ aj
        aj_dot_gtpaj = aj @ (G @ tpaj)
        cj_dot_gcj = cj @ (G @ cj)
        alpha = cj_dot_gcj / aj_dot_gtpaj
        fail_now = (aj_dot_gtpaj == 0.0) | ~torch.isfinite(alpha)
        alpha_s = torch.where(fail_now, 0.0, alpha)

        ej_new = ej + alpha_s * aj
        cj_new = cj - alpha_s * tpaj
        cj_dot_gcj_new = cj_new @ (G @ cj_new)
        conv_now = torch.sqrt(torch.clamp(cj_dot_gcj_new, min=0.0)) < target
        beta = cj_dot_gcj_new / cj_dot_gcj
        fail_late = (cj_dot_gcj_new == 0.0) | ~torch.isfinite(beta) | (beta == 0.0)
        aj_new = cj_new + beta * aj

        upd = active & ~fail_now
        ej = torch.where(upd, ej_new, ej)
        cj = torch.where(upd, cj_new, cj)
        aj = torch.where(upd & ~(conv_now | fail_late), aj_new, aj)
        failed = failed | (active & (fail_now | (~conv_now & fail_late)))
        converged = converged | (active & conv_now)
        active = active & ~(fail_now | conv_now | fail_late)

    cont = ~(failed | converged)
    return {"x": st["x"] + _combine(ej, basis),
            "p": torch.where(cont, _combine(aj, basis), st["p"]),
            "r": torch.where(cont, _combine(cj, basis), st["r"]),
            "m": st["m"] + s, "failed": st["failed"] | failed,
            "converged": st["converged"] | converged}


def cacg(op, level: Level, x, rhs, cfg: SolverConfig,
         must_subtract_mean: bool = False):
    """s-step CG (solvers/cacg.c), s = 4, until converged, failed or 200
    inner steps."""
    rd, part = cfg.reduce_dtype, level.part
    s, k = CA_KRYLOV_S, 2 * CA_KRYLOV_S + 1
    r0 = op.residual(level, x, rhs, cfg)
    if must_subtract_mean:
        r0 = r0 - blas.mean(r0, rd, part)
    delta0 = blas.dot(r0, r0, rd, part)
    target = cfg.bottom_rtol * torch.sqrt(delta0)
    sigma = _basis_scale(op, level, cfg, r0)
    tp = _monomial_shift(k, [(0, s), (s + 1, 2 * s)], 1, sigma)
    st = {"x": x, "p": r0, "r": r0, "m": 0,
          "failed": torch.zeros((), dtype=torch.bool, device=x.device),
          "converged": delta0 == 0.0}
    while not _done(st):
        st = _cacg_step(op, level, cfg, st, tp, target, 1.0 / sigma)
    return st["x"]
