"""Idle milliseconds a traced training update in the device gaps that
start while the host is inside ``engine.read`` (the engine reading loss
terms to the host, which drains the queue of work), charged as in
``benchmark/spans.py``; over ``Trace.steps``."""

from benchmark import spans


def read(run, ctx):
    return spans.idle_ms_per_step(run, ctx, ("engine.read",))
