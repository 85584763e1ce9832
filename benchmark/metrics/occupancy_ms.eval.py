"""Stream milliseconds a traced inference step spends decoding the
occupancy of every tet (``decode_occ_full_grid``: the pyramid probe and
the occupancy MLP, chunk by chunk): the time between the CUDA events
that the program's ``eval.occupancy`` span records at its start and end
on the stream, summed over the window's spans, over ``Trace.steps``."""

from benchmark import spans


def read(run, ctx):
    tr = run.get("trace")
    got = spans.between("eval.occupancy", *spans.window_ns(run, ctx))
    if tr is None or not tr.steps or not got or any(
            "stream_ms" not in s for s in got):
        return None
    return sum(s["stream_ms"] for s in got) / tr.steps
