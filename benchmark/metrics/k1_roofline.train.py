"""K1's share of its roofline in training: the least time of an update's
stencil work (``counts.train_stencil_bound_ms``: the graph convolutions'
neighbour means forward and backward, and the Laplacian term's, fixed by
the configuration whatever implements them) over the device time of the
kernels named ``stencil_kernel`` an update."""

from benchmark import counts


def read(run, ctx):
    tr = run.get("trace")
    if tr is None or not tr.steps:
        return None
    spent = tr.seconds_of("stencil_kernel")
    if spent <= 0:
        return None
    bound = counts.train_stencil_bound_ms(ctx.config) * 1e-3 * tr.steps
    return 100.0 * bound / spent
