"""CUDA kernel launches a training update in the traced window (the
profiler's kernel events; copies are not launches).  The hand-written
kernels' launches are held against the port's wrapper counter
(``_cuda.launch_counts``); a mismatch is reported on standard error."""

import sys

OURS = {"stencil": "stencil_kernel", "nearest": "nearest_kernel",
        "tri_argmin": "tri_argmin_kernel"}


def read(run, ctx):
    tr = run.get("trace")
    if tr is None or not tr.steps:
        return None
    for name, pattern in OURS.items():
        traced, counted = tr.count_of(pattern), run["launch_counts"][name]
        if traced != counted:
            print(f"launches_per_step: {pattern} {traced} traced, "
                  f"{counted} counted by the wrapper", file=sys.stderr)
    return len(tr.kernels()) / tr.steps
