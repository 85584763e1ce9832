"""Rematerialization that keeps named no-grad results (the port's
counterpart of ``jax.checkpoint`` with ``save_only_these_names``,
deftet_tpu/train/step.py:394-408).

``checkpoint(fn, generator, module)`` runs ``fn`` under
``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
forward instead of keeping its activations.  Three things make the
recompute replay the forward exactly:

* results wrapped in ``saved(names, compute)`` — the K2 and K3 argmins,
  the boundary compaction, the occupancy labels — are recorded in the
  forward and handed back in the recompute, so their scans (and the
  kernels behind them) run once;
* the explicit ``torch.Generator`` (which ``torch.utils.checkpoint``
  does not replay) is reset to its state at the start of the forward, so
  dropout, the input noise, the center subsample and the chamfer
  barycentrics draw the same numbers, and set back after;
* the module's buffers (BatchNorm running statistics, updated in place in
  training) are restored after the recompute, so they are updated once.

Outside ``checkpoint``, ``saved`` just computes.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

_TAPE: contextvars.ContextVar = contextvars.ContextVar("remat_tape",
                                                       default=None)


class _Tape:
    def __init__(self):
        self.values: dict = {}
        self.cursor: dict = {}
        self.replaying = False

    def take(self, key, compute):
        if not self.replaying:
            value = compute()
            self.values.setdefault(key, []).append(value)
            return value
        i = self.cursor.get(key, 0)
        self.cursor[key] = i + 1
        return self.values[key][i]


def saved(*args):
    """``saved(name, ..., compute)``: ``compute()``, kept for the
    recompute inside ``checkpoint`` under the given names."""
    *names, compute = args
    tape = _TAPE.get()
    if tape is None:
        return compute()
    return tape.take(tuple(names), compute)


@contextlib.contextmanager
def _recording(tape):
    token = _TAPE.set(tape)
    try:
        yield
    finally:
        _TAPE.reset(token)


@contextlib.contextmanager
def _replaying(tape, generator, start_state, module):
    tape.replaying, tape.cursor = True, {}
    after = generator.get_state() if generator is not None else None
    buffers = ([(b, b.detach().clone()) for b in module.buffers()]
               if module is not None else [])
    token = _TAPE.set(tape)
    try:
        if generator is not None:
            generator.set_state(start_state)
        yield
    finally:
        _TAPE.reset(token)
        if generator is not None:
            generator.set_state(after)
        with torch.no_grad():
            for buf, value in buffers:
                buf.copy_(value)


def checkpoint(fn, generator: torch.Generator | None = None,
               module: torch.nn.Module | None = None):
    """``fn()`` with its activations recomputed in the backward (see the
    module doc); returns what ``fn`` returns."""
    tape = _Tape()
    start = generator.get_state() if generator is not None else None

    def contexts():
        return _recording(tape), _replaying(tape, generator, start, module)

    return _torch_checkpoint(fn, use_reentrant=False, context_fn=contexts,
                             preserve_rng_state=False)
