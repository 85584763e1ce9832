"""Rematerialization that keeps named no-grad results (the port's
counterpart of ``jax.checkpoint`` with ``save_only_these_names``,
deftet_tpu/train/step.py:394-408).

The train step's forward runs as segments (the encoders; the position
decoder's probe and initial layer, each GCN block and its MLP head; the
occupancy decoder; the losses), each under
``torch.utils.checkpoint`` (non-reentrant): the forward keeps only the
tensors that pass between segments, and the backward recomputes one
segment at a time, so only that segment's activations are alive at once.
``segmented(generator)`` opens one microbatch; inside it
``segment(fn, *modules)`` runs one segment (outside, it just calls
``fn``).  ``checkpoint(fn, generator, module)`` is the one-segment form.
Three things make each recompute replay the forward exactly:

* results wrapped in ``saved(names, compute)`` — the K2 and K3 argmins,
  the boundary compaction, the occupancy labels — are recorded in the
  forward on the microbatch's one tape and handed back in the recompute,
  so their scans (and the kernels behind them) run once;
* the explicit ``torch.Generator`` (which ``torch.utils.checkpoint``
  does not replay) is reset to its state at the start of the segment, so
  dropout, the center subsample and the chamfer barycentrics draw the
  same numbers, and set back after;
* the buffers of the modules the segment runs (BatchNorm running
  statistics, updated in place in training) are restored after the
  recompute, so they are updated once;
* the data-parallel shard active in the forward (``parallel.sharded``)
  is active again in the recompute, which the autograd engine may run on
  another thread: BatchNorm's all-reduce and the per-example draws then
  replay as in the forward.  Every rank runs the same segments on the
  same graph, so the recomputes, and the collectives in them, come in
  the same order on every rank.

Outside a recording segment, ``saved`` just computes.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from . import parallel

_TAPE: contextvars.ContextVar = contextvars.ContextVar("remat_tape",
                                                       default=None)
_SESSION: contextvars.ContextVar = contextvars.ContextVar("remat_session",
                                                         default=None)


class _Tape:
    """The saved results of one microbatch, by segment and name."""

    def __init__(self):
        self.values: dict = {}
        self.cursor: dict = {}
        self.segment = 0
        self.replaying = False
        self.n_segments = 0

    def take(self, key, compute):
        key = (self.segment, key)
        if not self.replaying:
            value = compute()
            self.values.setdefault(key, []).append(value)
            return value
        i = self.cursor.get(key, 0)
        self.cursor[key] = i + 1
        return self.values[key][i]


def saved(*args):
    """``saved(name, ..., compute)``: ``compute()``, kept for the
    recompute of the segment it runs in under the given names."""
    *names, compute = args
    tape = _TAPE.get()
    if tape is None:
        return compute()
    return tape.take(tuple(names), compute)


@contextlib.contextmanager
def _recording(tape, segment):
    tape.segment, tape.replaying = segment, False
    token = _TAPE.set(tape)
    try:
        yield
    finally:
        _TAPE.reset(token)


@contextlib.contextmanager
def _replaying(tape, segment, generator, start_state, modules, shard):
    tape.segment, tape.replaying, tape.cursor = segment, True, {}
    after = generator.get_state() if generator is not None else None
    buffers = [(b, b.detach().clone()) for m in modules for b in m.buffers()]
    token = _TAPE.set(tape)
    try:
        if generator is not None:
            generator.set_state(start_state)
        with parallel.sharded(shard):
            yield
    finally:
        _TAPE.reset(token)
        if generator is not None:
            generator.set_state(after)
        with torch.no_grad():
            for buf, value in buffers:
                buf.copy_(value)


def _checkpoint(fn, tape, generator, modules):
    segment = tape.n_segments
    tape.n_segments += 1
    start = generator.get_state() if generator is not None else None
    shard = parallel.active()

    def contexts():
        return (_recording(tape, segment),
                _replaying(tape, segment, generator, start, modules, shard))

    return _torch_checkpoint(fn, use_reentrant=False, context_fn=contexts,
                             preserve_rng_state=False)


@contextlib.contextmanager
def segmented(generator: torch.Generator | None = None):
    """One microbatch's forward run as rematerialized segments: inside,
    each ``segment`` call is checkpointed on one shared tape."""
    token = _SESSION.set((_Tape(), generator))
    try:
        yield
    finally:
        _SESSION.reset(token)


def segment(fn, *modules: torch.nn.Module):
    """``fn()``; inside ``segmented``, with its activations recomputed in
    the backward and the buffers of ``modules`` restored after."""
    session = _SESSION.get()
    if session is None:
        return fn()
    tape, generator = session
    return _checkpoint(fn, tape, generator, modules)


def checkpoint(fn, generator: torch.Generator | None = None,
               module: torch.nn.Module | None = None):
    """``fn()`` as one segment, with its activations recomputed in the
    backward (see the module doc); returns what ``fn`` returns."""
    modules = (module,) if module is not None else ()
    return _checkpoint(fn, _Tape(), generator, modules)
