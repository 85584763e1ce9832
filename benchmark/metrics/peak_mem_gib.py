"""``torch.cuda.max_memory_allocated()`` over the measured window (peak
statistics reset at its start), in GiB."""


def read(run, ctx):
    peak = run["window"]["peak_bytes"]
    return peak / 2**30 if peak else None
