"""The plain versions of K5/K7b and K8c (``stencils_r1.r1_stencil_plain``,
``r1_slab_plain``), which CPU tensors take and against which the card
tests hold the streaming kernel, at ragged shapes: against the JAX
package's radius-1 XLA apply (kernels="xla") in float64, every cell
compared, rel <= 1e-12 (rel = max|port - jax| / max|jax|).

K5/K7b at n = 9 (odd: apply, residual and the gsrb half-sweep) and n = 34
(fres too; neither a multiple of the 16 x 32 column tile); K8c on the four
blocks of a 2x2 split of those levels, (5, 4) x (5, 4) x 9 and 17 x 17 x
34 (odd, uneven and thin against the tile), its slabs cut from the ghost
-filled level (the neighbours' cells, or the Dirichlet or periodic
ghosts at a domain face), the blocks' results assembled. The fv7pt (p1,
with a*alpha*x), fv2 (v2) and 27pt (a = 1.5) bodies, Dirichlet and
periodic. The JAX results are made once a module. Also: the plain
half-sweeps leave the other colour's cells equal to x bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.core.config import BC as JBC
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.core.level import Level as JLevel
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.ops.transfer import restrict_cell as jrestrict
from hpgmg_tpu_torch.core.config import BC, SolverConfig
from hpgmg_tpu_torch.core.level import Level, rb_mask
from hpgmg_tpu_torch.kernels import stencils_r1 as K

TOL = 1e-12
CPU = torch.device("cpu")
SIZES = (9, 34)
# (op, taps, var7, helmholtz, a)
BODIES = [("fv7pt", "p1", True, True, 1.5), ("fv2", "v2", True, False, 0.0),
          ("27pt", "27pt", False, False, 1.5)]


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def cases():
    """Per (n, bc, op): the port's level, x, rhs and its config, and the
    JAX XLA A x on the same arrays."""
    out = {}
    for n in SIZES:
        rng = np.random.default_rng(900 + n)
        b = [1.0 + 0.25 * rng.random(s) for s in
             ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1))]
        alpha = 0.5 + rng.random((n, n, n))
        dinv = (0.5 + rng.random((n, n, n))) / (8.0 * n * n)
        x, rhs = rng.standard_normal((2, n, n, n))
        d = t(dinv)
        for op, _, var7, helm, a in BODIES:
            lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=t(b[0]), beta_j=t(b[1]),
                       beta_k=t(b[2]), alpha=t(alpha) if helm else None, dinv=d,
                       kdinv=tuple(rb_mask(n, p, torch.float64, CPU) * d for p in (0, 1)))
            jlv = JLevel(dim=n, h=1.0 / n, depth=0, beta_i=jnp.asarray(b[0]),
                         beta_j=jnp.asarray(b[1]), beta_k=jnp.asarray(b[2]),
                         alpha=jnp.asarray(alpha) if helm else None, dinv=jnp.asarray(dinv))
            for bc in ("dirichlet", "periodic"):
                jcfg = JConfig(op=op, a=a, b=1.0, helmholtz=helm, dtype=jnp.float64,
                               kernels="xla", bc=JBC(bc))
                cfg = SolverConfig(op=op, a=a, b=1.0, helmholtz=helm, dtype=torch.float64,
                                   bc=BC(bc))
                ax = np.asarray(jsuite(op).apply_op(jlv, jnp.asarray(x), jcfg))
                out[(n, bc, op)] = (lv, t(x), t(rhs), cfg, ax)
    return out


def _refs(lv, x, rhs, ax):
    """(mode, kwargs, reference) of every mode from the JAX A x: gsrb at
    parity 0, fres where n is even."""
    r = rhs.numpy() - ax
    out = [("apply", {}, ax), ("residual", {"rhs": rhs}, r),
           ("gsrb", {"rhs": rhs, "kdinv": lv.kdinv[0]}, x.numpy() + lv.kdinv[0].numpy() * r)]
    if lv.dim % 2 == 0:
        out.append(("fres", {"rhs": rhs}, np.asarray(jrestrict(jnp.asarray(r)))))
    return out


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("op,taps,var7", [b[:3] for b in BODIES])
@pytest.mark.parametrize("n", SIZES)
def test_r1_stencil_plain_ragged_matches_xla(cases, n, op, taps, var7, bc):
    lv, x, rhs, cfg, ax = cases[(n, bc, op)]
    for mode, kw, ref in _refs(lv, x, rhs, ax):
        par = {"parity": 0} if mode == "gsrb" else {}
        out = K.r1_stencil_plain(lv, x, cfg, mode, taps, var7, **kw, **par)
        assert rel(out, ref) <= TOL, mode


def _block(lv, x, rhs, i0, i1, j0, j1, xg):
    """The block [i0, i1) x [j0, j1) of the level: its level (faces cut),
    x, rhs and kdinv, and its 1-deep slabs cut from the ghost-filled xg."""
    def cut(a, di=0, dj=0):
        return None if a is None else a[i0:i1 + di, j0:j1 + dj].contiguous()

    blv = Level(dim=lv.dim, h=lv.h, depth=0, beta_i=cut(lv.beta_i, 1),
                beta_j=cut(lv.beta_j, 0, 1), beta_k=cut(lv.beta_k), alpha=cut(lv.alpha),
                kdinv=(cut(lv.kdinv[0]),) * 2)
    k = slice(1, -1)
    slabs = (xg[i0:i0 + 1, j0 + 1:j1 + 1, k], xg[i1 + 1:i1 + 2, j0 + 1:j1 + 1, k],
             xg[i0:i1 + 2, j0:j0 + 1, k], xg[i0:i1 + 2, j1 + 1:j1 + 2, k])
    return blv, cut(x), cut(rhs), tuple(s.contiguous() for s in slabs)


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("op,taps,var7", [b[:3] for b in BODIES])
@pytest.mark.parametrize("n", SIZES)
def test_r1_slab_plain_on_a_ragged_2x2_split_matches_xla(cases, n, op, taps, var7, bc):
    lv, x, rhs, cfg, ax = cases[(n, bc, op)]
    xg = K.ghost_fill_taps(x, taps, cfg.bc)
    cuts = (0, (n + 1) // 2, n)
    for mode, kw, ref in _refs(lv, x, rhs, ax):
        if mode == "fres" and n // 2 % 2:
            continue  # 17 x 17 x 34 blocks: fres needs even extents
        full = torch.zeros_like(t(ref))
        for i0, i1 in zip(cuts, cuts[1:]):
            for j0, j1 in zip(cuts, cuts[1:]):
                blv, bx, brhs, slabs = _block(lv, x, rhs, i0, i1, j0, j1, xg)
                bkw = {k: (brhs if k == "rhs" else blv.kdinv[0]) for k in kw}
                out = K.r1_slab_plain(blv, bx, slabs, cfg, mode, taps, var7, **bkw)
                f = 2 if mode == "fres" else 1
                full[i0 // f:i1 // f, j0 // f:j1 // f] = out
        assert rel(full, ref) <= TOL, mode



@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_r1_plain_gsrb_leaves_the_other_colour_as_x(cases, bc, parity):
    """The plain half-sweeps, the card tests' reference, change only their
    colour's cells: the others equal x bit for bit, on a level (K5/K7b)
    and on one block with the BC-fill slabs (K8c)."""
    for n in SIZES:
        for op, taps, var7, _, _ in BODIES:
            lv, x, rhs, cfg, _ = cases[(n, bc, op)]
            kd = lv.kdinv[parity]
            other = rb_mask(n, parity, torch.float64, CPU) == 0
            slabs = K.single_chip_slabs_r1(x, cfg.bc, taps)
            for out in (K.r1_stencil_plain(lv, x, cfg, "gsrb", taps, var7, rhs=rhs,
                                           kdinv=kd, parity=parity),
                        K.r1_slab_plain(lv, x, slabs, cfg, "gsrb", taps, var7, rhs=rhs,
                                        kdinv=kd)):
                assert torch.equal(out[other], x[other]), (n, op)
                assert not torch.equal(out[~other], x[~other]), (n, op)
