"""Start the ranks of a ``torch.distributed`` group: ``spawn_ranks`` spawns
them from one process, ``torchrun_rank`` joins a group that ``torchrun``
started. One process per rank; ``backend`` nccl puts each rank on a card
of its own, gloo lets the ranks share one card (or the CPU), its
exchanges staged through host memory. Used by bench/weak.py and by
fe/cli.py's sample action."""

from __future__ import annotations

import os
import tempfile
import time
from contextlib import redirect_stdout

import torch


def rank_device(rank: int, backend: str, device_type: str) -> torch.device:
    """This rank's device: its own card under NCCL, card 0 under gloo, or
    the CPU (one intra-op thread a rank)."""
    if device_type != "cuda":
        torch.set_num_threads(1)
        return torch.device("cpu")
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    return device


def _rank_main(rank: int, world: int, tmp: str, backend: str, device_type: str,
               body, args):
    """One spawned rank: join the group through a file in ``tmp``, run
    ``body(device, *args)``; rank 0's stdout goes to ``tmp/rank0.out``
    and its result to ``tmp/rank0.pt``."""
    import torch.distributed as dist

    device = rank_device(rank, backend, device_type)
    dist.init_process_group(backend, init_method=f"file://{tmp}/init", rank=rank,
                            world_size=world)
    try:
        if rank == 0:
            with open(f"{tmp}/rank0.out", "w", buffering=1) as fh, redirect_stdout(fh):
                out = body(device, *args)
            torch.save(out, f"{tmp}/rank0.pt")
        else:
            body(device, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(ranks: int, backend: str, device, body, args=(),
                timeout: float = 1800.0):
    """Run ``body(device, *args)`` on ``ranks`` spawned processes of one
    group of ``backend`` (each on its ``rank_device``), echo rank 0's
    stdout here line by line as it comes, and return rank 0's result. A
    rank that fails, or a job that outlives ``timeout`` seconds, raises;
    no rank outlives the call."""
    import torch.multiprocessing as mp

    device = torch.device(device)
    if backend == "nccl" and (device.type != "cuda"
                              or ranks > torch.cuda.device_count()):
        raise ValueError(f"nccl puts each rank on a card of its own: {ranks} ranks, "
                         f"{torch.cuda.device_count() if device.type == 'cuda' else 0} "
                         "cards (use -backend gloo)")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, args=(ranks, tmp, backend, device.type,
                                                   body, tuple(args)),
                                 nprocs=ranks, start_method="spawn", join=False)
        deadline, seen = time.monotonic() + timeout, 0

        def echo():
            nonlocal seen
            try:
                with open(f"{tmp}/rank0.out", "rb") as fh:
                    fh.seek(seen)
                    text = fh.read()
            except FileNotFoundError:
                return
            done = text[:text.rfind(b"\n") + 1]
            seen += len(done)
            print(done.decode(), end="", flush=True)

        try:
            while not ctx.join(timeout=0.5):
                echo()
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {ranks}-rank job outlived {timeout} s")
            echo()
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return torch.load(f"{tmp}/rank0.pt", weights_only=False)


def torchrun_rank(backend: str, device_type: str, body, args=()):
    """A rank started by torchrun (``RANK``, ``WORLD_SIZE`` and, where
    set, ``LOCAL_RANK`` in the environment): join its group, run
    ``body(device, *args)`` and return its result."""
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    device = rank_device(int(os.environ.get("LOCAL_RANK", rank)), backend, device_type)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    try:
        return body(device, *args)
    finally:
        dist.destroy_process_group()


def under_torchrun() -> bool:
    """Whether torchrun started this process as a rank of its group."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ
