"""Tracing and profiling utilities (counterpart of
hpgmg_tpu/utils/profiler.py; the reference's timer subsystem analog).

FV hand-rolls hierarchical timers (timers.h:11-23, level.h:162-196) and FE
uses PetscLogStage/Event (fmg.c:180-196). On the card the native
equivalent is a ``torch.profiler`` trace with named ranges: ``scope``
marks the cycle's phases (``solve/mg.py``: ``mg.L{lev}.{phase}``) so the
trace shows the same per-level structure the reference's tables do. Flop
accounting (the PetscLogFlops analog) is analytic, from the stencils'
shapes.

``scope`` costs nothing outside ``trace``: it is then a ``nullcontext``
(the JAX ``named_scope`` costs nothing at run time either, and a
``record_function`` on each of an F-cycle's ~300 phases would add host
time to a path that is host-bound on its coarse levels).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch

# set by ``trace`` while it records: (active, the run is on CUDA)
_TRACING = False
_CUDA = False
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def _ranges(name: str):
    with torch.profiler.record_function(name):
        if _CUDA:
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def scope(name: str):
    """Named range for a solver phase: inside an active ``trace`` a
    ``torch.profiler.record_function`` (plus an NVTX range on CUDA),
    outside one a ``nullcontext``."""
    return _ranges(name) if _TRACING else _NULL


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace (CPU and, where there is a CUDA
    device, CUDA activity) around a block, with ``scope`` ranges on, and
    write it to ``log_dir/trace.json`` (Chrome trace format); without
    ``log_dir``, to a new temporary directory of its own. Yields the
    directory."""
    global _TRACING, _CUDA
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="hpgmg_tpu_torch_trace_")
    os.makedirs(log_dir, exist_ok=True)
    prev = _TRACING, _CUDA
    with profile(activities=activities) as prof:
        _TRACING, _CUDA = True, cuda
        try:
            yield log_dir
        finally:
            if cuda:
                torch.cuda.synchronize()
            _TRACING, _CUDA = prev
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class WallTimer:
    """getTime() analog (timers.h:11-23): an accumulating wall-clock
    timer. With a CUDA ``device`` it synchronises the device on enter and
    on exit, so ``total`` holds the device's work inside the block."""

    def __init__(self, device=None):
        self.total = 0.0
        self._t0: Optional[float] = None
        self.device = None if device is None else torch.device(device)

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.total += time.perf_counter() - self._t0
        return False


# -- analytic flop accounting (PetscLogFlops analog) -------------------------

def stencil_flops_per_cell(op_name: str) -> int:
    """FLOPs per cell for one operator application (counted from the
    stencil expressions, matching the reference's hand counts)."""
    return {
        "fv7pt": 13,  # 6 face terms: 6 mul + 6 add/sub pairs + scale
        "fv2": 13,
        "fv4": 73,  # 6 high-order fluxes (5 ops each) + 12 mixed terms
        "27pt": 30,
    }.get(op_name, 0)


def fcycle_dof_per_solve(n: int) -> int:
    return n ** 3


# -- reading a trace ---------------------------------------------------------
# ``trace`` writes Kineto's Chrome trace: complete events ("ph": "X", ts
# and dur in microseconds on one clock for host and device) with a
# category: "user_annotation" for a ``scope`` range, "cpu_op" for an aten
# or c10d op, "cuda_runtime" / "cuda_driver" for a launch call on the host
# and "kernel" for its kernel on the device, the two linked by
# args["correlation"].

# host ranges and ops of the process group's communication: the ``comm.``
# scopes around the port's collectives and point-to-point exchanges
# (core/blas.py, parallel/halo.py, parallel/mesh.py) and c10d's own ops
COMM_PATTERNS = ("comm.", "gloo", "c10d", "nccl", "record_param_comms")


def read_trace(log_dir: str) -> list:
    """The complete events of ``log_dir/trace.json``."""
    import json

    with open(os.path.join(log_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _span(events: list, name: str):
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] == name:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise KeyError(f"no range {name!r} in the trace")


def _union(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a or b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _kernels(events: list):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "kernel"]


def _intervals(events: list, cats, patterns):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("cat") in cats and any(p in e["name"] for p in patterns)]


def wall_shares(events: list, span: str) -> dict:
    """How the wall time of the range ``span`` divides: the shares in the
    process group's communication (the union of the host events matching
    ``COMM_PATTERNS``), in kernels (the union of the device's kernel
    intervals) and in neither; ``overlap_share`` is the part counted in
    both, and ``host_wait_share`` the part of neither that the host spends
    in CUDA copies and synchronizations (waiting on the device)."""
    lo, hi = _span(events, span)
    wall = hi - lo
    comm = _intervals(events, ("user_annotation", "cpu_op"), COMM_PATTERNS)
    kern = _kernels(events)
    wait = _intervals(events, ("cuda_runtime", "cuda_driver"), ("Memcpy", "Synchronize"))
    c, k, both = _union(comm, lo, hi), _union(kern, lo, hi), _union(comm + kern, lo, hi)
    w = _union(comm + kern + wait, lo, hi) - both
    return {"wall_ms": wall / 1e3, "comm_share": c / wall, "kernel_share": k / wall,
            "neither_share": 1.0 - both / wall, "overlap_share": (c + k - both) / wall,
            "host_wait_share": w / wall}


def kernel_ms_by_range(events: list, prefix: str = "mg.L"):
    """Device ms of the kernels launched inside each ``scope`` range whose
    name starts with ``prefix``, each kernel counted in the innermost range
    around its launch call on the launching thread. Returns ({name:
    (device ms, calls of the range)}, device ms of every kernel, device ms
    of the kernels inside a range)."""
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
               e.get("pid"), e.get("tid"))
              for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith(prefix)]
    launch = {e["args"]["correlation"]: (float(e["ts"]), e.get("pid"), e.get("tid"))
              for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = {}
    for a, b, name, _, _ in ranges:
        ms, calls = out.get(name, (0.0, 0))
        out[name] = (ms, calls + 1)
    total = inside = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ms = float(e["dur"]) / 1e3
        total += ms
        host = launch.get(e.get("args", {}).get("correlation"))
        if host is None:
            continue
        ts, pid, tid = host
        around = [r for r in ranges if r[0] <= ts <= r[1] and r[3] == pid and r[4] == tid]
        if around:
            name = min(around, key=lambda r: r[1] - r[0])[2]
            out[name] = (out[name][0] + ms, out[name][1])
            inside += ms
    return out, total, inside
