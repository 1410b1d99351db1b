"""Memory usage reporting (counterpart of hpgmg_tpu/utils/memory.py; the
MemoryGetUsage analog, memusage.c:7-26).

The reference queries PETSc/kernel RSS per rank; here we report both host
RSS and, per visible CUDA device, the caching allocator's statistics.
"""

from __future__ import annotations

import resource
from typing import Dict

import torch


def host_rss_bytes() -> int:
    """Resident set size of this process (the per-rank number the FE
    sampler prints, sampler.c:119-131)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per CUDA device (``cuda:i``): the numeric entries of
    ``torch.cuda.memory_stats(i)``, plus ``bytes_in_use`` (the tensors
    allocated, ``memory_allocated``) and ``bytes_limit`` (the device's
    total memory, ``mem_get_info``). ``{}`` without CUDA."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = {k: int(v) for k, v in torch.cuda.memory_stats(i).items()
                 if isinstance(v, (int, float))}
        stats["bytes_in_use"] = int(torch.cuda.memory_allocated(i))
        stats["bytes_limit"] = int(torch.cuda.mem_get_info(i)[1])
        out[f"cuda:{i}"] = stats
    return out


def format_memory_report() -> str:
    lines = [f"host rss: {host_rss_bytes() / 2**20:.1f} MiB"]
    for dev, stats in device_memory_stats().items():
        used = stats.get("bytes_in_use", 0)
        limit = stats.get("bytes_limit", 0)
        lines.append(f"{dev}: {used / 2**20:.1f} MiB in use"
                     + (f" / {limit / 2**20:.1f} MiB" if limit else ""))
    return "\n".join(lines)
