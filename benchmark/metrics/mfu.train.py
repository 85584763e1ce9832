"""Model FLOP utilization of a training update: the network's matmul
and convolution FLOPs an update (``counts.train_step_flops``, three
times the forward, from the configuration's shapes alone) times the
traced updates, over the traced window, as a share of the H100's dense
bf16 peak (989 TFLOP/s at 700 W; the run's power limit is in
``device``)."""

from benchmark import counts


def read(run, ctx):
    tr = run.get("trace")
    if tr is None or not tr.steps or tr.window_s <= 0:
        return None
    flops = counts.train_step_flops(ctx.config) * tr.steps
    return 100.0 * flops / tr.window_s / counts.PEAK_BF16
