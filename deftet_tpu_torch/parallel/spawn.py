"""Run a function on R ranks of a fresh world, from one process.

``run_ranks(fn, n, *args)`` spawns ``n`` processes that meet through a
``FileStore`` in a fresh directory (no port to collide on), calls
``fn(world, *args)`` on each and returns their results, rank by rank.
A rank that raises fails the call with its traceback, and the other
ranks are stopped.  Ranks on the CPU split the host's cores between
them.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from .mesh import init_world


# a collective that waits longer than this fails its rank
_TIMEOUT = datetime.timedelta(seconds=900)


def _rank_main(index, fn, n, args, device, share_device, store_dir):
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    world = init_world(device, init_method=f"file://{store_dir}/store",
                       rank=index, size=n, local_rank=index,
                       share_device=share_device, timeout=_TIMEOUT)
    try:
        result = fn(world, *args)
        torch.save(result, os.path.join(store_dir, f"rank{index}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, *args, device: str = "cuda"):
    """``[fn(world, *args) for each rank]``, run as ``n`` processes.

    ``fn`` must be importable (a module-level function) and return
    something ``torch.save`` takes (CPU tensors, numbers, dicts).  On
    ``cuda`` (the default; it raises without a CUDA device) the ranks
    share ``cuda:0`` over gloo when the machine has fewer cards than
    ranks, else rank r takes card r over NCCL; ``device="cpu"`` runs
    gloo ranks on the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device='cuda') needs a CUDA device; "
                           "pass device='cpu' to run the ranks on the CPU")
    share_device = (torch.device(device).type == "cuda"
                    and n > torch.cuda.device_count())
    with tempfile.TemporaryDirectory(prefix="deftet_ranks_") as store_dir:
        torch.multiprocessing.start_processes(
            _rank_main,
            args=(fn, n, args, device, share_device, store_dir),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(store_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
