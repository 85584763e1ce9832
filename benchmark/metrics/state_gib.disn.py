"""GiB the optimizer's layer holds on the device between updates: the
parameters and Adam's two moments (``ClippedAdam.mu`` and ``nu``), read
from the program's tensors after the window.  Part of every update's
peak memory, whatever the batch; a fused or flattened optimizer moves
it."""


def read(run, ctx):
    held = run.get("state_bytes")
    return held / 2**30 if held else None
