"""FE action CLI (counterpart of hpgmg_tpu/fe/cli.py; the ``hpgmg-fe
<action>`` analog, fefas.c:28-73).

Actions: fmg (RunFMG), mgv (RunMGV: V-cycles only), sample (RunSample),
and the test-* bodies test-kspsolve, test-grid, test-fespace and
test-feinject. The options and defaults are the JAX CLI's, plus
``-device`` (default ``cuda``; with no CUDA device, pass ``-device cpu``)
and, for sample, the ranks: ``-ranks N`` spawns N processes in one
``torch.distributed`` group (parallel/launch.py; ``-backend nccl``, the
default, one card each; ``gloo`` lets them share one card or the CPU, its
exchanges staged through host memory) and runs the sampler on their
``make_mesh`` grid, the JAX sampler on all devices (``P[  2  2  2]`` on
8); rank 0's lines are printed here. Started by torchrun (``RANK`` and
``WORLD_SIZE`` set), each process is one rank of torchrun's group.

    python -m hpgmg_tpu_torch.fe.cli fmg -M 8,16,24 -op_type poisson2 -mg_monitor
    python -m hpgmg_tpu_torch.fe.cli sample -op_type poisson2 -local 50,10000
    python -m hpgmg_tpu_torch.fe.cli sample -local 8,8 -ranks 8 -backend gloo -device cpu
"""

from __future__ import annotations

import argparse
import sys

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _sample_rank(device: torch.device, kw: dict):
    """The sampler on the group's ranks (fe/sampler.py:run_sample)."""
    from hpgmg_tpu_torch.fe.op import get_fe_op
    from hpgmg_tpu_torch.fe.sampler import run_sample

    kw = dict(kw)
    op = get_fe_op(kw.pop("op_type"))
    return run_sample(op, degree=op.degree, device=device, **kw)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m hpgmg_tpu_torch.fe.cli",
        description="HPGMG-FE actions on a CUDA device (PyTorch)",
        epilog="The remaining fefas-test.c bodies (test-fetransfer, "
               "test-op, test-opdiagonal, test-sampler) run as pytest "
               "goldens: tests/test_torch_fe_modules.py, "
               "tests/test_torch_fe_fas.py, tests/test_torch_fe_cli.py.")
    p.add_argument("action", choices=["fmg", "mgv", "sample",
                                      "test-kspsolve", "test-grid",
                                      "test-fespace", "test-feinject"])
    p.add_argument("-M", default="8,8,8", help="global elements per axis")
    p.add_argument("-op_type", default="poisson2",
                   choices=["poisson1", "poisson2", "poisson2affine"])
    p.add_argument("-poisson_solution", default="sine",
                   choices=["sine", "hump", "wave"])
    p.add_argument("-smooth", default="2,3", help="pre,post smooths")
    p.add_argument("-mg_eig_target", default="1.4,0.4",
                   help="max,min Chebyshev eigenvalue targets (fmg.c:91-94)")
    p.add_argument("-solve_type", default="fmg", choices=["fmg", "ksp"],
                   help="sampler solve path (sampler.c:151-154)")
    p.add_argument("-ksp_type", default="chebyshev",
                   choices=["chebyshev", "cg"])
    p.add_argument("-ksp_rtol", type=float, default=1e-5)
    p.add_argument("-ksp_chebyshev_eigenvalues", default="0.2,2")
    p.add_argument("-mg_monitor", action="store_true")
    p.add_argument("-coord_distort", type=float, default=0.0)
    p.add_argument("-add_quad_pts", type=int, default=0)
    p.add_argument("-local", default="50,10000",
                   help="sampler min,max local elements")
    p.add_argument("-maxsamples", type=int, default=8)
    p.add_argument("-repeat", type=int, default=3)
    p.add_argument("-mintime", type=float, default=0.1)
    p.add_argument("-dtype", default="float64", choices=sorted(_DTYPES))
    p.add_argument("-cycles", type=int, default=5, help="mgv cycle count")
    p.add_argument("-device", default="cuda")
    p.add_argument("-ranks", "--ranks", type=int, default=1,
                   help="sampler: processes to spawn, one rank each")
    p.add_argument("-backend", "--backend", choices=["nccl", "gloo"], default="nccl",
                   help="the ranks' torch.distributed backend")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device available (pass -device cpu to run on the CPU)",
              file=sys.stderr)
        return 1

    from hpgmg_tpu_torch.fe.fas import (build_fe_level, build_fe_levels,
                                        diagnostics, fas_vcycle, run_fmg,
                                        run_ksp)
    from hpgmg_tpu_torch.fe.grid import FEGrid
    from hpgmg_tpu_torch.fe.op import get_fe_op
    from hpgmg_tpu_torch.parallel.launch import spawn_ranks, torchrun_rank, under_torchrun

    op = get_fe_op(args.op_type)
    dtype = _DTYPES[args.dtype]
    pre, post = (int(s) for s in args.smooth.split(","))

    if args.action == "sample":
        kw = dict(op_type=args.op_type, local=tuple(int(s) for s in args.local.split(",")),
                  maxsamples=args.maxsamples, repeat=args.repeat, mintime=args.mintime,
                  dtype=dtype)
        if under_torchrun():
            torchrun_rank(args.backend, device.type, _sample_rank, (kw,))
        elif args.ranks > 1:
            spawn_ranks(args.ranks, args.backend, device, _sample_rank, (kw,))
        else:
            _sample_rank(device, kw)
        return 0

    M = tuple(int(s) for s in args.M.split(","))
    mmax = max(M)
    L = tuple(m / mmax for m in M)
    grid = FEGrid(M=M, degree=op.degree, L=L, addquadpts=args.add_quad_pts)

    emax, emin = (float(s) for s in args.mg_eig_target.split(","))

    if args.action == "test-grid":
        # TestGrid (fefas-test.c:95-109) / GridView: print the coarsening
        # ladder (one device: no per-rank element ranges)
        g = grid
        lev = 0
        while True:
            print(f"Level {lev}: M [{g.M[0]} {g.M[1]} {g.M[2]}]  "
                  f"nodes [{g.nodes[0]} {g.nodes[1]} {g.nodes[2]}]  "
                  f"neq {g.neq}")
            if not g.can_coarsen():
                break
            g = g.coarsen()
            lev += 1
        return 0

    if args.action == "test-fespace":
        # TestFESpace (fefas-test.c:110-141): fill the global vector with
        # its own global numbering and print it with the node coordinates
        # (the global array IS the function space: no halo copies)
        c = build_fe_level(grid, op, dtype, device=device).coords.cpu()
        nx, ny, nz = grid.nodes
        g = torch.arange(nx * ny * nz, dtype=dtype).reshape(nx, ny, nz)
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    print(f"u[{int(g[i, j, k]):3d}] at "
                          f"{float(c[0, i, j, k]):5.2f} "
                          f"{float(c[1, i, j, k]):5.2f} "
                          f"{float(c[2, i, j, k]):5.2f}")
        return 0

    if args.action == "test-feinject":
        # TestFEInject (fefas-test.c:210-268): u = 1e6 x + 1e3 y + z on the
        # fine nodes; inject (state restriction Rhat) to the coarse grid;
        # print coarse values with coordinates — injected values encode
        # their coordinates, making misrouted injection visible.
        c = build_fe_level(grid, op, dtype, device=device).coords
        u = 1e6 * c[0] + 1e3 * c[1] + c[2]
        if not grid.can_coarsen():
            print("grid cannot coarsen; nothing to inject")
            return 0
        gc = grid.coarsen()
        uc = grid.inject(u).cpu()
        cc = build_fe_level(gc, op, dtype, device=device).coords.cpu()
        nx, ny, nz = gc.nodes
        idx = 0
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    print(f"coarse u[{idx:2d}] = {float(uc[i, j, k]):10.1f} "
                          f"at {float(cc[0, i, j, k]):4.1f} "
                          f"{float(cc[1, i, j, k]):4.1f} "
                          f"{float(cc[2, i, j, k]):4.1f}")
                    idx += 1
        return 0

    if args.action == "fmg":
        run_fmg(grid, op, args.poisson_solution, dtype=dtype,
                distort=args.coord_distort, pre=pre, post=post,
                monitor=True, eig=(emin, emax), device=device)
        return 0

    if args.action == "test-kspsolve":
        ce1, ce2 = (float(s) for s in
                    args.ksp_chebyshev_eigenvalues.split(","))
        run_ksp(grid, op, args.poisson_solution, dtype=dtype,
                ksp_type=args.ksp_type, rtol=args.ksp_rtol,
                eig=(min(ce1, ce2), max(ce1, ce2)), device=device)
        return 0

    # mgv: RunMGV (fmg.c:336-419) — V-cycles from a zero guess
    levels = build_fe_levels(grid, op, dtype, args.coord_distort, device)
    f = op.forcing(levels[0].grid, levels[0].coords, args.poisson_solution)
    u = torch.zeros(grid.nodes, dtype=dtype, device=device)
    for _ in range(args.cycles):
        u = fas_vcycle(op, levels, 0, f, u, pre, post, (emin, emax))
        r2, e_max, el2 = [float(x) for x in diagnostics(
            op, levels[0], f, u, args.poisson_solution)]
        print(f"V({pre},{post}) Q{grid.degree} "
              f"G[{M[0]:5d}{M[1]:5d}{M[2]:5d}] e_max {e_max:8.2e} "
              f"e_L2 {el2:8.2e} r_2 {r2:8.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
