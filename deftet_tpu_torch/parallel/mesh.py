"""Data parallelism over ``torch.distributed`` (the port's counterpart of
deftet_tpu/parallel/mesh.py).

The JAX step on an N-device mesh is one SPMD program that computes the
one-device step on the global batch.  Here R processes compute it
together, and the contract is the same: an R-rank step equals the
one-process step on the global batch.

* ``World``: rank, size, local device and backend of the processes
  (``init_world`` reads torchrun's environment or takes them explicitly).
* ``World.shard(batch_size)``: the divisor clamp of ``make_mesh`` — the
  step runs on the first ``n`` ranks, ``n`` the largest count not above
  the world's size that divides the batch; the others take no rows and
  no part in the step's collectives (a subgroup of the first ``n``).
* ``Shard``: a rank's place in that group, made active with ``sharded``;
  BatchNorm reads it for its global statistics, the per-example random
  draws for the rank's rows of a draw at the global shape (``draw_rows``),
  the train step for its gradient ``psum``.
* ``shard_rows``: a rank's rows of a global batch, microbatch-major as the
  JAX step reshapes the batch before sharding it.
* ``replicate``: rank 0's parameters and buffers broadcast to every rank.
* ``all_reduce_sum``: a differentiable sum over the group;
  ``mean_over_shard``: the global batch's mean from the ranks' (equal
  shards), with or without a gradient.

The tensors move by ``all_reduce`` and ``broadcast`` only (with
``barrier``, and ``broadcast_object_list`` on broadcasts): gloo offers
nothing else on CUDA tensors, and two ranks sharing one card run on gloo.  Importing
this module starts no process group and touches no CUDA.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("parallel_shard",
                                                        default=None)


def largest_divisor(n_ranks: int, batch_size: int) -> int:
    """The largest rank count ``<= n_ranks`` that divides ``batch_size``
    (make_mesh's clamp: a batch of 2 on 3 ranks trains on 2)."""
    n = max(int(n_ranks), 1)
    while n > 1 and batch_size % n:
        n -= 1
    return n


@dataclass(frozen=True)
class Shard:
    """A rank's place in the step's group: ``index`` of ``size`` ranks
    (``group`` None: the default group)."""

    group: Any
    index: int
    size: int


@dataclass
class World:
    """The processes of one data-parallel run."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str
    _groups: dict = field(default_factory=dict, repr=False)

    def shard(self, batch_size: int) -> Optional[Shard]:
        """This rank's ``Shard`` of a ``batch_size`` step, or None for a
        rank past the divisor clamp.  Collective: every rank calls it."""
        n = largest_divisor(self.size, batch_size)
        if n not in self._groups:
            # new_group is collective over the default group even for
            # ranks that are not members
            self._groups[n] = (None if n == self.size
                               else dist.new_group(list(range(n))))
        if self.rank >= n:
            return None
        return Shard(self._groups[n], self.rank, n)


def world_from_env() -> dict | None:
    """torchrun's RANK / WORLD_SIZE / LOCAL_RANK, or None outside it."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    return {"rank": int(os.environ["RANK"]),
            "size": int(os.environ["WORLD_SIZE"]),
            "local_rank": int(os.environ.get("LOCAL_RANK", 0))}


def init_world(device: str = "cuda", init_method: str | None = None,
               rank: int | None = None, size: int | None = None,
               local_rank: int | None = None, share_device: bool = False,
               timeout=None) -> World:
    """Join (or start) the default process group and return the world.

    Rank, size and local rank default to torchrun's environment; the
    rendezvous to ``init_method`` (``env://`` under torchrun).  On
    ``cuda`` rank r runs on ``cuda:<local rank>``, or with
    ``share_device`` every rank on ``cuda:0``; the backend is NCCL there
    (gloo where ranks share the card: NCCL refuses two ranks on one
    device) and gloo on the CPU.  A rank whose device does not
    exist raises.  ``timeout`` (a timedelta) bounds each collective."""
    env = world_from_env() or {}
    rank = env.get("rank", 0) if rank is None else rank
    size = env.get("size", 1) if size is None else size
    local_rank = env.get("local_rank", rank) if local_rank is None \
        else local_rank
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run on the CPU")
        index = 0 if share_device else local_rank
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: no CUDA device {index} (the machine has "
                f"{torch.cuda.device_count()})")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        backend = "gloo" if share_device else "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        if timeout is not None:
            kw["timeout"] = timeout
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=size, **kw)
    return World(rank=dist.get_rank(), size=dist.get_world_size(),
                 local_rank=local_rank, device=dev,
                 backend=dist.get_backend())


# ------------------------------------------------------------------ shard
def active() -> Optional[Shard]:
    """The shard of the step running now, or None (one process)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sharded(shard: Optional[Shard]):
    """Run the enclosed step as ``shard``'s part of the global step (None:
    one process)."""
    token = _ACTIVE.set(shard)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def shard_rows(batch, index: int, n: int, microbatches: int = 1):
    """Rank ``index`` of ``n``'s rows of a global batch (a dict of arrays
    or tensors with the batch first; lists are indexed the same way).

    With ``microbatches = a`` the global batch splits into ``a``
    microbatches of ``m = B / a`` rows before it is sharded, as the JAX
    step reshapes it to (a, m) first: the rank's microbatch i is global
    rows ``i m + index m / n ... i m + (index + 1) m / n``, and its rows
    come back microbatch-major, so its own ``a`` contiguous microbatches
    are those."""
    def rows(x):
        b = len(x)
        if b % microbatches or (b // microbatches) % n:
            raise ValueError(
                f"a batch of {b} rows does not split into grad_accum="
                f"{microbatches} microbatches over {n} ranks")
        k = b // microbatches // n
        if isinstance(x, list):
            return [x[i * k * n + index * k + j]
                    for i in range(microbatches) for j in range(k)]
        if microbatches == 1:
            return x[index * k:(index + 1) * k]
        tail = tuple(x.shape[1:])
        return x.reshape((microbatches, n, k) + tail)[:, index].reshape(
            (microbatches * k,) + tail)

    return {key: rows(v) for key, v in batch.items()}


def rows_of(x: torch.Tensor) -> torch.Tensor:
    """The active rank's rows of ``x``, given at the global (micro)batch
    shape (an injected per-example draw); ``x`` itself in one process."""
    shard = active()
    if shard is None:
        return x
    k = x.shape[0] // shard.size
    return x[shard.index * k:(shard.index + 1) * k]


def embed_rows(x: torch.Tensor, fill: float) -> torch.Tensor:
    """``x`` at the active rank's rows of a global-shape tensor filled with
    ``fill`` elsewhere; ``x`` itself in one process."""
    shard = active()
    if shard is None:
        return x
    k = x.shape[0]
    full = torch.full((k * shard.size,) + tuple(x.shape[1:]), fill,
                      dtype=x.dtype, device=x.device)
    full[shard.index * k:(shard.index + 1) * k] = x
    return full


def draw_rows(shape, draw: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
    """A per-example random draw: ``draw(shape)`` in one process; under a
    shard, the draw at the global shape (first axis times the group's
    size), from a generator seeded the same on every rank, and this
    rank's rows of it.  Every rank so consumes what the one-process step
    would, and keeps the rows the one-process step gives its examples."""
    shard = active()
    if shard is None:
        return draw(tuple(shape))
    b = shape[0]
    full = draw((b * shard.size,) + tuple(shape[1:]))
    return full[shard.index * b:(shard.index + 1) * b]


# ------------------------------------------------------------ collectives
class _AllReduceSum(torch.autograd.Function):
    """Sum over the group in the forward; the backward sums the cotangents
    over the group, since each rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable."""
    return _AllReduceSum.apply(x, group)


def mean_over_shard(x: torch.Tensor,
                    differentiable: bool = False) -> torch.Tensor:
    """The mean over the active group's ranks of ``x``, element by
    element; ``x`` itself in one process.  Every rank holds the same
    number of rows, so the mean of the ranks' means over their rows is
    the mean over the global batch.  Differentiable through
    ``all_reduce_sum`` when asked, else taken without a gradient."""
    shard = active()
    if shard is None:
        return x
    if differentiable:
        return all_reduce_sum(x, shard.group) / shard.size
    return sum_over_shard(x) / shard.size


@torch.no_grad()
def sum_over_shard(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active group's ranks (no gradient); ``x``
    itself in one process."""
    shard = active()
    if shard is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=shard.group)
    return x


@torch.no_grad()
def replicate(tensors, src: int = 0, group=None) -> None:
    """Broadcast rank ``src``'s values of ``tensors`` (a module's
    parameters and buffers, or a list of tensors) into every rank's."""
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    for t in tensors:
        dist.broadcast(t.data, src=src, group=group)

