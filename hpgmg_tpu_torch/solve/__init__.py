"""Smoothers, bottom solvers and multigrid cycles."""

from hpgmg_tpu_torch.solve.mg import MGSolver, fmg_solve, mg_solve  # noqa: F401
