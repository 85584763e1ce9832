"""K2's share of its roofline in evaluation: the least time of an
inference step's eight (B, eval_points) against (B, eval_points)
nearest-neighbour queries (``counts.eval_nearest_bound_ms``) over the
device time of the kernels named ``nearest_kernel`` a step."""

from benchmark import counts


def read(run, ctx):
    tr = run.get("trace")
    if tr is None or not tr.steps:
        return None
    spent = tr.seconds_of("nearest_kernel")
    if spent <= 0:
        return None
    cfg = {**ctx.config, "eval_points": int(ctx.params["eval_points"])}
    b = int(ctx.params["n_shapes"])
    bound = counts.eval_nearest_bound_ms(cfg, b) * 1e-3 * tr.steps
    return 100.0 * bound / spent
