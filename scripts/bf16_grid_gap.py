#!/usr/bin/env python3
"""Where a decomposed solve parts from the one-rank solve of the same
problem: each operation of the V- and F-cycles on each decomposed level of
a process grid (ranks sharing one device over gloo) against the same
operation on the whole level, cell by cell, and the F-cycles themselves,
through the kernels and through the plain versions.

    PYTHONPATH=. python scripts/bf16_grid_gap.py [--n 256] [--ops fv4,fv7pt]
        [--dtypes bfloat16,float32] [--bc dirichlet] [--ranks 4] [--fcycle-n 256]
        [--device cuda] [--json FILE]

``--ranks`` picks the grid (parallel/mesh.py:make_mesh: 4 the 2x2 grid, 8
the (2,2,2) one); ``--fcycle-n 0`` skips the F-cycles.

Per operation it prints the cells whose bits differ from the whole level's
(by where they lie: within two cells of a domain face, of a block face, or
inside), and the largest gap in units in the last place of the whole
level's cell; per F-cycle pair the gap in units of 2^-8 max|u| (bf16) as
bench/weak.py's ``serial_u_units``. The operations are the suite's own
(``op.apply_op``, ``residual``, ``gsrb_sweep``, ``smooth``,
``restrict_residual``, the V- and F-cycle interpolations); on a CUDA
device both sides run the kernels, on the CPU their plain versions.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spacing(r: torch.Tensor) -> torch.Tensor:
    """The spacing of r's dtype at each |r| (the smallest normal's at 0)."""
    info = torch.finfo(r.dtype)
    a = r.float().abs().clamp_min(info.tiny)
    bits = {torch.bfloat16: 7, torch.float32: 23, torch.float64: 52}[r.dtype]
    return torch.exp2(torch.floor(torch.log2(a)) - bits)


def where_cells(mask: torch.Tensor, offsets, dim: int, part) -> dict:
    """The cells of ``mask`` (a block at ``offsets`` of a dim^3 level) by
    where they lie: near a domain face, near a block face, inside."""
    idx = mask.nonzero()
    if idx.numel() == 0:
        return {"domain": 0, "block": 0, "inside": 0}
    g = idx + torch.tensor(offsets, device=idx.device)
    dom = ((g < 2) | (g >= dim - 2)).any(dim=1)
    blk = torch.zeros_like(dom)
    if part is not None:
        for a in range(3):
            if part.axes[a]:
                e = part.extents[a]
                loc = g[:, a] % e
                blk |= (loc < 2) | (loc >= e - 2)
    return {"domain": int(dom.sum()), "block": int((blk & ~dom).sum()),
            "inside": int((~blk & ~dom).sum())}


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, offsets, dim: int, part):
    diff = got != ref
    gap = ((got.double() - ref.double()).abs() / spacing(ref).double()).max()
    return {"what": name, "cells": int(diff.sum()), "of": got.numel(),
            "ulps": float(gap), **where_cells(diff, offsets, dim, part)}


def level_ops(suite, cfg, hd, h1, mesh, seed: int):
    """Each operation on each decomposed level against the whole level's."""
    from hpgmg_tpu_torch.ops.transfer import get_interpolation
    from hpgmg_tpu_torch.parallel.mesh import active_mesh
    from hpgmg_tpu_torch.solve.smoothers import smooth

    rows = []
    gen = torch.Generator().manual_seed(seed)
    dev = h1.levels[0].beta_i.device

    def field(m):
        return (torch.rand((m,) * 3, generator=gen, dtype=torch.float64) - 0.5).to(
            dev, cfg.dtype)

    for lev, (ld, l1) in enumerate(zip(hd.levels, h1.levels)):
        part = ld.part
        if part is None:
            break
        m = l1.dim
        x, rhs = field(m), field(m)
        xb, rb = part.block(x), part.block(rhs)
        off = part.offsets
        ops = {"apply": (lambda lv, a, r: suite.apply_op(lv, a, cfg)),
               "residual": (lambda lv, a, r: suite.residual(lv, a, r, cfg)),
               "gsrb0": (lambda lv, a, r: suite.gsrb_sweep(lv, a, r, cfg, 0)),
               "gsrb1": (lambda lv, a, r: suite.gsrb_sweep(lv, a, r, cfg, 1)),
               "smooth": (lambda lv, a, r: smooth(suite, lv, a, r, cfg))}
        for name, fn in ops.items():
            with active_mesh(mesh):
                got = fn(ld, xb, rb)
            rows.append({"level": m, **compare(name, got, part.block(fn(l1, x, rhs)), off, m,
                                               part)})
        with active_mesh(mesh):
            got = suite.restrict_residual(ld, xb, rb, cfg)
        cp = part.coarsen()
        rows.append({"level": m, **compare("restrict_residual", got,
                                           cp.block(suite.restrict_residual(l1, x, rhs, cfg)),
                                           cp.offsets, m // 2, cp)})
        if lev + 1 < len(hd.levels):
            coarse = hd.levels[lev + 1].part
            ec = field(m // 2)
            ecb = ec if coarse is None else coarse.block(ec)
            for kind, name, pre in (("V", suite.interpolation_vcycle, 1.0),
                                    ("F", suite.interpolation_fcycle, 0.0)):
                interp = get_interpolation(name)
                with active_mesh(mesh):
                    got = interp(ecb, pre, xb if pre else None, cfg.bc, coarse=coarse,
                                 fine=part)
                ref = interp(ec, pre, x if pre else None, cfg.bc)
                rows.append({"level": m, **compare(f"interp {kind} ({name})", got,
                                                   part.block(ref), off, m, part)})
    return rows


def units(a: torch.Tensor, b: torch.Tensor) -> float:
    top = float(b.float().abs().max())
    return float((a.float() - b.float()).abs().max()) / (2.0 ** -8 * top)


def fcycles(suite, cfg, n: int, mesh, device) -> dict:
    """The F-cycle gaps (units of 2^-8 max|u|): decomposed against one
    rank, through the kernels (one rank twice, and with the tail's fusion
    off) and through the plain versions (chip_smoke.plain_path); rank 0's."""
    import chip_smoke
    from hpgmg_tpu_torch.bench.driver import build
    from hpgmg_tpu_torch.kernels import tail
    from hpgmg_tpu_torch.parallel.mesh import active_mesh, gather
    from hpgmg_tpu_torch.solve.mg import fmg_solve

    hd, fd = build(n, cfg, device, mesh=mesh)
    part = hd.levels[0].part

    def dec():
        with active_mesh(mesh):
            u = fmg_solve(suite, hd, fd, cfg)[0]
        return gather(u, part) if part is not None else u

    u_d = dec()
    with chip_smoke.plain_path():
        u_dp = dec()
    out = {}
    if mesh.rank == 0:
        h1, f1 = build(n, cfg, device)
        u_1 = fmg_solve(suite, h1, f1, cfg)[0]
        u_1b = fmg_solve(suite, h1, f1, cfg)[0]
        tail.TAIL_FUSE = False
        try:
            u_1nt = fmg_solve(suite, h1, f1, cfg)[0]
        finally:
            tail.TAIL_FUSE = True
        with chip_smoke.plain_path():
            u_1p = fmg_solve(suite, h1, f1, cfg)[0]
        out = {"decomposed vs one rank": units(u_d, u_1),
               "one rank twice": units(u_1b, u_1),
               "decomposed vs one rank without the tail fusion": units(u_d, u_1nt),
               "one rank without vs with the tail fusion": units(u_1nt, u_1),
               "plain: decomposed vs one rank": units(u_dp, u_1p),
               "decomposed: kernels vs plain": units(u_d, u_dp),
               "one rank: kernels vs plain": units(u_1, u_1p)}
    return out


def rank_body(device, opts):
    import torch.distributed as dist

    from hpgmg_tpu_torch.bench import weak
    from hpgmg_tpu_torch.bench.driver import build
    from hpgmg_tpu_torch.ops.base import get_suite
    from hpgmg_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device)
    out = {"grid": list(mesh.shape), "levels": {}, "fcycles": {}}
    for op in opts["ops"]:
        suite = get_suite(op)
        for dt in opts["dtypes"]:
            cfg = weak._config(op, dt, opts["bc"], "bicgstab")
            hd, _ = build(opts["n"], cfg, device, mesh=mesh)
            h1, _ = build(opts["n"], cfg, device)
            rows = level_ops(suite, cfg, hd, h1, mesh, 11)
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, rows)
            merged = []
            for i, row in enumerate(rows):
                r = dict(row)
                for key in ("cells", "of", "domain", "block", "inside"):
                    r[key] = sum(e[i][key] for e in every)
                r["ulps"] = max(e[i]["ulps"] for e in every)
                merged.append(r)
                if mesh.rank == 0:
                    print(f"{op} {opts['bc']} {dt} {r['level']}^3 {r['what']}: {r['cells']} "
                          f"of {r['of']} cells differ (domain face {r['domain']}, block face "
                          f"{r['block']}, inside {r['inside']}), at most {r['ulps']:.3f} ulps",
                          flush=True)
            out["levels"][f"{op} {dt}"] = merged
            del hd, h1
            if dt == "bfloat16" and opts["fcycle_n"]:
                fc = fcycles(suite, cfg, opts["fcycle_n"], mesh, device)
                if mesh.rank == 0:
                    for k, v in fc.items():
                        print(f"{op} {opts['bc']} {dt} {opts['fcycle_n']}^3 F-cycle, {k}: "
                              f"{v:.3f} units", flush=True)
                out["fcycles"][f"{op} {dt} {opts['fcycle_n']}"] = fc
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--ops", default="fv4,fv7pt")
    p.add_argument("--dtypes", default="bfloat16,float32")
    p.add_argument("--bc", default="dirichlet", choices=("dirichlet", "periodic"))
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--fcycle-n", type=int, default=256)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None, help="write the results there too")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from hpgmg_tpu_torch.parallel.launch import spawn_ranks

    if device.type == "cuda":
        from hpgmg_tpu_torch.kernels import build

        build.build()
        build.library()
    opts = dict(n=a.n, ops=a.ops.split(","), dtypes=a.dtypes.split(","), bc=a.bc,
                fcycle_n=a.fcycle_n)
    res = spawn_ranks(a.ranks, "gloo", device, rank_body, (opts,), timeout=1500.0)
    if a.json:
        os.makedirs(os.path.dirname(a.json) or ".", exist_ok=True)
        with open(a.json, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res["fcycles"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
