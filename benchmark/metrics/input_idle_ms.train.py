"""Idle milliseconds a traced training update in the device gaps that
start while the host is inside ``engine.next_batch`` (waiting on the
caller's batch iterator) or ``engine.prep_batch`` (the batch's copies to
the device), charged as in ``benchmark/spans.py``; over
``Trace.steps``."""

from benchmark import spans


def read(run, ctx):
    return spans.idle_ms_per_step(run, ctx, ("engine.next_batch",
                                             "engine.prep_batch"))
