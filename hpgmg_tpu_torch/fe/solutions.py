"""Manufactured solutions for the FE Poisson operators (counterpart of
hpgmg_tpu/fe/solutions.py).

Rebuild of op-poisson1.c:16-83: sine / hump / wave pairs (u, f = -lap u)
on [0, L]^3 with homogeneous Dirichlet boundaries. ``x`` is a tensor whose
leading axis holds the three coordinates; u and f have the shape of
``x[0]``.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def _sine(x, L):
    u = (torch.sin(1 * PI * x[0] / L[0]) * torch.sin(2 * PI * x[1] / L[1])
         * torch.sin(3 * PI * x[2] / L[2]))
    f = ((1 * PI / L[0]) ** 2 + (2 * PI / L[1]) ** 2
         + (3 * PI / L[2]) ** 2) * u
    return u, f


def _hump(x, L):
    sx = [torch.sin(PI * x[a] / L[a]) for a in range(3)]
    cx = [torch.cos(PI * x[a] / L[a]) for a in range(3)]
    hump = sx[0] * sx[1] * sx[2]
    h_x = [PI / L[0] * cx[0] * sx[1] * sx[2],
           PI / L[1] * sx[0] * cx[1] * sx[2],
           PI / L[2] * sx[0] * sx[1] * cx[2]]
    h_xx = [-(PI / L[a]) ** 2 * hump for a in range(3)]

    t = torch.tanh(x[0] / L[0])
    bend = t + torch.log(1 + x[1] / L[1]) + torch.exp(-x[2] / L[2])
    b_x = [(1 - t * t) / L[0],
           1.0 / (L[1] * (1 + x[1] / L[1])),
           -torch.exp(-x[2] / L[2]) / L[2]]
    b_xx = [-(2 - 2 * t * t) * t / (L[0] ** 2),
            -1.0 / (L[1] ** 2 * (1 + x[1] / L[1]) ** 2),
            torch.exp(-x[2] / L[2]) / (L[2] ** 2)]

    u = hump * bend
    f = -sum(h_xx[a] * bend + 2 * h_x[a] * b_x[a] + hump * b_xx[a]
             for a in range(3))
    return u, f


def _wave1(t):
    u = t**4 - t**2 + 2 * t**3 - 2 * t**5
    uxx = 12 * t**2 - 2 + 12 * t - 40 * t**3
    return u, uxx


def _wave(x, L):
    us, uxxs = zip(*[_wave1(x[a] / L[a]) for a in range(3)])
    u = us[0] * us[1] * us[2]
    f = -(uxxs[0] * us[1] * us[2] / L[0] ** 2
          + us[0] * uxxs[1] * us[2] / L[1] ** 2
          + us[0] * us[1] * uxxs[2] / L[2] ** 2)
    return u, f


SOLUTIONS = {"sine": _sine, "hump": _hump, "wave": _wave}


def get_solution(name: str):
    if name not in SOLUTIONS:
        raise ValueError(f"unknown solution {name!r}; have {sorted(SOLUTIONS)}")
    return SOLUTIONS[name]
