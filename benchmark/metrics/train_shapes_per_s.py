"""Shapes the training window's completed updates consumed, over the
window's wall time (host clock, first update's start to a synchronize
after the last)."""


def read(run, ctx):
    w = run["window"]
    if ctx.cell["traffic"] != "train" or not w["steps"]:
        return None
    return w["shapes"] / w["seconds"]
