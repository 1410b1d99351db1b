"""The fv4 suite on ladders down to 2^3, the JAX CLI's default
(hpgmg_tpu/core/config.py: min_coarse_dim 2), against the JAX package's
XLA path (kernels="xla") on the CPU in float64.

The port computes its levels below 4^3 by the plain version on every
device (kernels/stencils.py:small_level, ``fv4_small``), where the
quartic Dirichlet ghosts fall back to the quadratic ones, as the JAX XLA
ops do. One fv4 F-cycle at 16^3 and 32^3 with the DIRECT and the
BiCGStab bottom holds u to the JAX package's to 1e-10 (max|port - jax| /
max|jax|, float64 rounding of a few hundred ops) and rel_res to 1e-8
relative; the radius-1 suites on the same ladder alike. The CLI's ladder is
32-16-8-4-2 by default; ``python -m hpgmg_tpu_torch.bench`` keeps 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.bench.driver import _build as jbuild_problem
from hpgmg_tpu.core.config import BottomSolver as JBottom
from hpgmg_tpu.core.config import SolverConfig as JConfig
from hpgmg_tpu.ops.base import get_suite as jsuite
from hpgmg_tpu.solve.mg import fmg_solve as jfmg
from hpgmg_tpu_torch.bench import __main__ as bench_main
from hpgmg_tpu_torch.bench.cli import parser, solver_config
from hpgmg_tpu_torch.bench.driver import build
from hpgmg_tpu_torch.core.config import BottomSolver, SolverConfig
from hpgmg_tpu_torch.core.hierarchy import level_dims
from hpgmg_tpu_torch.kernels import counts
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.ops.base import get_suite
from hpgmg_tpu_torch.solve.mg import fmg_solve

CPU = torch.device("cpu")
U_TOL, RES_TOL = 1e-10, 1e-8


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


def both_fcycles(op: str, n: int, bottom: str):
    """One F-cycle of ``op`` at n^3 on the 2^3 ladder in each package, each
    on its own build of the suite's problem: (port u, port rel_res, JAX u,
    JAX rel_res, the port's level dims, the launch counts of its solve)."""
    jcfg = JConfig(op=op, a=0.0, b=1.0, dtype=jnp.float64, kernels="xla",
                   bottom=JBottom(bottom), min_coarse_dim=2)
    jh, jf = jbuild_problem(n, jcfg)
    ju, jnr, jnf = jax.jit(lambda h, f: jfmg(jsuite(op), h, f, jcfg))(jh, jf)
    cfg = SolverConfig(op=op, a=0.0, b=1.0, dtype=torch.float64,
                       bottom=BottomSolver(bottom), min_coarse_dim=2)
    hier, f = build(n, cfg, CPU)
    counts.reset()
    u, nr, nf = fmg_solve(get_suite(op), hier, f, cfg)
    return (u, float(nr) / float(nf), ju, float(jnr) / float(jnf),
            [lv.dim for lv in hier.levels], counts.read()[0])


@pytest.mark.parametrize("n,bottom", [(16, "direct"), (16, "bicgstab"),
                                      (32, "direct"), (32, "bicgstab")])
def test_fv4_fcycle_down_to_2_matches_jax(n, bottom):
    u, res, ju, jres, dims, launched = both_fcycles("fv4", n, bottom)
    assert dims[-2:] == [4, 2]
    # the BiCGStab bottom applies the 2^3 level's operator through
    # fv4_small (the DIRECT bottom is one matvec)
    assert (launched["fv4_small"] > 0) == (bottom == "bicgstab")
    assert rel(u, ju) <= U_TOL
    assert abs(res - jres) <= RES_TOL * jres


@pytest.mark.parametrize("op", ["fv7pt", "fv2", "27pt"])
def test_radius1_fcycle_down_to_2_matches_jax(op):
    u, res, ju, jres, dims, launched = both_fcycles(op, 16, "direct")
    assert dims == [16, 8, 4, 2]
    assert launched["fv4_small"] == 0
    assert rel(u, ju) <= U_TOL
    assert abs(res - jres) <= RES_TOL * jres


def test_cli_ladder_defaults():
    """bench/cli.py takes the JAX CLI's min_coarse_dim of 2 (the ladder
    32-16-8-4-2 at 32^3); python -m hpgmg_tpu_torch.bench keeps bench.py's
    8."""
    args = parser().parse_args(["--n", "32", "--device", "cpu"])
    cfg = solver_config(args)
    assert cfg.min_coarse_dim == 2
    assert level_dims(32, cfg.min_coarse_dim) == [32, 16, 8, 4, 2]
    assert bench_main.parser().parse_args([]).min_coarse_dim == 8


def test_small_levels_take_no_kernel():
    """A level below 4^3 is the plain version's on every device; the
    kernels' CUDA entries refuse it, and K2c's gate does not take it."""
    lv = build(16, SolverConfig(op="fv4", a=0.0, b=1.0, dtype=torch.float64,
                                bottom=BottomSolver.BICGSTAB, min_coarse_dim=2),
               CPU)[0].levels[-1]
    assert lv.dim == 2 and S.small_level(lv)
    cfg = SolverConfig(a=0.0, b=1.0, dtype=torch.float64)
    x = torch.zeros((2, 2, 2), dtype=torch.float64)
    for launch in (lambda: S.fv4_stencil_cuda(lv, x, cfg, "apply"),
                   lambda: S.fv4_subtile_cuda(lv, x, cfg, "apply")):
        with pytest.raises(ValueError, match="n >= 4"):
            launch()
    counts.reset()
    out = get_suite("fv4").gsrb_smooth(lv, x, x + 1.0, cfg, 6)
    launched, plains = counts.read()
    assert launched["fv4_small"] == 6 and plains["fv4_gsrb2_plain"] == 0
    assert torch.isfinite(out).all()
