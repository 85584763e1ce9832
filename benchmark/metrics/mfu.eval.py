"""Model FLOP utilization of an inference step: the network's forward
FLOPs with the occupancy MLP on every tet (``counts.
inference_step_flops``) times the traced steps, over the traced window,
as a share of the H100's dense bf16 peak (989 TFLOP/s at 700 W)."""

from benchmark import counts


def read(run, ctx):
    tr = run.get("trace")
    if tr is None or not tr.steps or tr.window_s <= 0:
        return None
    b = int(ctx.params["n_shapes"])
    flops = counts.inference_step_flops(ctx.config, b) * tr.steps
    return 100.0 * flops / tr.window_s / counts.PEAK_BF16
