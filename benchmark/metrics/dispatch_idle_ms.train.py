"""Idle milliseconds a traced training update in the device gaps that
start while the host is inside ``step.update`` and outside
``engine.read``: the device waiting on the step's Python and launches.
``benchmark/spans.py`` puts the program's spans on the trace's clock and
charges each gap whole to the span open at its start; over
``Trace.steps``."""

from benchmark import spans


def read(run, ctx):
    return spans.idle_ms_per_step(run, ctx, ("step.update",),
                                  ("engine.read",))
