"""Start of the process to the start of the measured window: imports,
inputs, engine and statics, weights, the kernels' builds where the
checkout has none, and the warm-up."""


def read(run, ctx):
    return run["setup_s"]
