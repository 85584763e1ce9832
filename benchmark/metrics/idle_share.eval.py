"""Share of the traced evaluation window in which no operation ran on the
device: 100 (1 - union of device intervals / window)."""


def read(run, ctx):
    tr = run.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
