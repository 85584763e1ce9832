"""Milliseconds an inference step kept the device busy: the union of its
device intervals in the traced window, per step."""


def read(run, ctx):
    tr = run.get("trace")
    if tr is None or not tr.steps or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / tr.steps
