"""Kernel launches a traced training update inside the optimizer: the
``LaunchKernel`` host events of the trace that start inside the
program's ``step.optimizer`` spans (gradient clipping and Adam), put on
the trace's clock by ``benchmark/spans.py``; over ``Trace.steps``."""

from benchmark import spans


def read(run, ctx):
    al, tr = spans.aligned(run, ctx), run.get("trace")
    if al is None or not tr.steps or not any(
            s.name == "step.optimizer" for s in al.spans):
        return None
    return spans.launches_in(tr, al, "step.optimizer") / tr.steps
