"""Parse and summarize sampler / benchmark logs (counterpart of
hpgmg_tpu/bench/analyze.py; the hpgmg-analyze.py analog).

The reference script regex-parses the FE sampler's stdout and plots
time-vs-DOFs efficiency curves (hpgmg-analyze.py:1-40). This version
parses the FE sampler's lines (``python -m hpgmg_tpu_torch.fe.cli
sample``) and the port's FV benchmark lines (``  {op} F-cycle on {device}:
...``, bench/driver.py) and prints an efficiency table; plotting
(matplotlib) is optional.

    python -m hpgmg_tpu_torch.bench.analyze run.log [--plot out.png]
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import List, Tuple

FE_LINE = re.compile(
    r"Q(?P<degree>\d+)\s+G\[\s*(?P<g0>\d+)\s+(?P<g1>\d+)\s+(?P<g2>\d+)\]"
    r".*?(?P<time>[0-9.eE+-]+)\s+s\s+(?P<gf>[0-9.eE+-]+)\s+GF\s+"
    r"(?P<meqs>[0-9.eE+-]+)\s+MEq/s")
FV_LINE = re.compile(
    r"(?P<op>\w+) F-cycle on (?P<device>[^:]+): (?P<n>\d+)\^3 grid.*?"
    r"(?P<time>[0-9.eE+-]+) s/solve, (?P<dofs>[0-9.eE+-]+) DOF/s")


def parse(lines) -> Tuple[List[dict], List[dict]]:
    fe, fv = [], []
    for line in lines:
        m = FE_LINE.search(line)
        if m:
            d = m.groupdict()
            eqs = (int(d["g0"]) * int(d["g1"]) * int(d["g2"]))
            fe.append(dict(degree=int(d["degree"]), elements=eqs,
                           time=float(d["time"]), gf=float(d["gf"]),
                           meqs=float(d["meqs"])))
        m = FV_LINE.search(line)
        if m:
            d = m.groupdict()
            fv.append(dict(op=d["op"], device=d["device"], n=int(d["n"]),
                           time=float(d["time"]), dofs=float(d["dofs"])))
    return fe, fv


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m hpgmg_tpu_torch.bench.analyze")
    p.add_argument("log", nargs="?", help="log file (default: stdin)")
    p.add_argument("--plot", help="write a time-vs-size PNG (needs matplotlib)")
    args = p.parse_args(argv)
    if args.log:
        with open(args.log) as fh:
            lines = fh.readlines()
    else:
        lines = sys.stdin.readlines()
    fe, fv = parse(lines)

    if fe:
        best = max(r["meqs"] for r in fe)
        print("FE samples (efficiency = MEq/s relative to best):")
        for r in fe:
            print(f"  Q{r['degree']} elements={r['elements']:>10d} "
                  f"t={r['time']:.6f}s {r['gf']:8.2f} GF "
                  f"{r['meqs']:8.3f} MEq/s  eff={r['meqs'] / best:5.2f}")
    if fv:
        for r in fv:
            print(f"FV {r['op']} on {r['device']} n={r['n']}^3 "
                  f"t={r['time']:.4f}s {r['dofs']:.3e} DOF/s")

    if args.plot and fe:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xs = [r["elements"] for r in fe]
        ys = [r["time"] for r in fe]
        plt.loglog(xs, ys, "o-")
        plt.xlabel("elements")
        plt.ylabel("F-cycle seconds")
        plt.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
