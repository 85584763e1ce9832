"""The readings that a DISN cell's limits are set from, on the CUDA
device, in one process (``calibrate.py`` for cells of traffic
``disn_train``; the benchmark's own runs never call this):

    python3 -m benchmark.calibrate_disn --workload disn.train \
        --seeds 201-212 --controls 301-303 --seconds 2

For each of ``--seeds``, one run of the cell as ``benchmark.run`` makes
it (a short window), and its numbers compared: the lower readings.  For
each of ``--controls``, on the cell's inputs and weights at its own
size, the reference against itself, then against the reference with a
planted fault: the heads without their local branch (``global_only``),
each update on the first half of its batch (``half_batch``), and the
DISN modules' convolutions and Dense layers in bfloat16 (``control``, a
step below the float32 the configuration states): the upper readings.
One JSON line each.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness
from benchmark.calibrate import _say, _seeds
from benchmark.run import CHECKOUT, _caches

FAULTS = {"global_only": {"global_only": True},
          "half_batch": {"half_batch": True},
          "control": {"lower": True}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.calibrate_disn")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--controls", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    _caches()
    import torch

    if not torch.cuda.is_available():
        print("calibrate_disn: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import compare, session
    from benchmark.reference import steps, steps_disn

    cell, config, _ = harness.load_cell(args.workload)
    with open(CHECKOUT / "BENCHMARK.json") as f:
        spec = json.load(f)

    def context(seed):
        return harness.Context(name=args.workload, cell=cell, config=config,
                               seed=seed, seconds=args.seconds, trace=False,
                               device="cuda", root=harness.ROOT,
                               t_start=time.perf_counter())

    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        out = harness.execute(context(seed), spec)
        _say(kind="program", seed=seed, seconds=time.perf_counter() - t0,
             correct=out["correct"], attempted=out["attempted"],
             failed=out["failed"],
             numbers={k: c["value"] for k, c in out["checks"].items()},
             unsteady=out.get("unsteady"))
        session.free("cuda")

    drv = harness.driver(cell["traffic"])
    grid = None
    for seed in _seeds(args.controls):
        t0 = time.perf_counter()
        ctx = context(seed)
        inp = drv.inputs(ctx)
        cfg = inp["config"]
        weights = {k: v.cpu() for k, v in drv.weights_for(inp, ctx).items()}
        grid = grid or steps.build_grid(cfg, "cuda")

        def readings(**kw):
            return steps_disn.train_readings(cfg, weights, inp["proof"],
                                             "cuda", grid=grid, **kw)

        base = readings()
        # the control last: a bfloat16 run that fails may leave the device
        # unusable, and it has then failed with no number
        for name, kw in [("reference_again", {}), *FAULTS.items()]:
            got = readings(**kw)
            _say(kind=name, seed=seed, seconds=time.perf_counter() - t0,
                 numbers=compare.train_numbers(got, base),
                 unsteady=compare.train_unsteady(got, base),
                 loss=got["loss"], reference_loss=base["loss"])
        session.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
