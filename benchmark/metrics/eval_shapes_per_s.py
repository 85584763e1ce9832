"""Shapes the evaluation window's inference steps evaluated, over the
window's wall time (host clock, first step's start to a synchronize
after the last)."""


def read(run, ctx):
    w = run["window"]
    if ctx.cell["traffic"] != "eval" or not w["steps"]:
        return None
    return w["shapes"] / w["seconds"]
