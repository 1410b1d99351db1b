#!/usr/bin/env python3
"""Run chip_smoke.py's phases 13, 14 and 15 in the order the whole script
runs them, several times on one card, and count the rounds in which a
phase failed (phase 15c's trace check, chip_smoke.tooling_trace, among
them; a failing 15c prints the events of its empty tail range).

    PYTHONPATH=. python scripts/tooling_repeat.py [rounds]

Needs a CUDA device; builds the kernels first and takes K1's 512^3 gsrb
time from chip_smoke.time_kernels, as the whole script's phase 3 does.
"""

import sys
import time
import traceback

import torch

import chip_smoke as C


def main(rounds: int) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from hpgmg_tpu_torch.kernels import build

    print(C.card_line())
    build.build()
    build.library()
    gsrb_ms = C.time_kernels(sizes=(512,))[512]["gsrb"]["ms"]
    failed = []
    for r in range(rounds):
        t0 = time.perf_counter()
        try:
            C.phases_13_to_15(gsrb_ms, f"round {r}: ")
        except AssertionError:
            traceback.print_exc()
            failed.append(r)
        print(f"round {r}: {time.perf_counter() - t0:.1f} s, "
              f"{'failed' if failed and failed[-1] == r else 'passed'}", flush=True)
    print(f"rounds {rounds}, failed {len(failed)}: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
