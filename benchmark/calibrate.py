"""The readings that a cell's limits are set from, on the CUDA device,
in one process (the benchmark's own runs never call this):

    python3 -m benchmark.calibrate --workload res50.train \
        --seeds 201-212 --controls 301-303 --seconds 2

For each of ``--seeds``, one run of the cell as ``benchmark.run`` makes
it (a short window), and its numbers compared: the lower readings.  For
each of ``--controls``, on the cell's inputs and weights at its own
size, the reference against itself computed a step lower in precision
(float8 for bfloat16: the control), and for a training cell against the
reference run on the first half of each batch (a planted fault): the
upper readings.  One JSON line each.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness
from benchmark.run import CHECKOUT, _caches


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out += range(int(lo), int(hi) + 1)
        elif part:
            out.append(int(part))
    return out


def _say(**fields) -> None:
    print(json.dumps(fields), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--controls", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    _caches()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import compare, session
    from benchmark.reference import steps as ref

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
        grid = grid or ref.build_grid(cfg, "cuda")
        if cell["traffic"] == "train":
            def readings(**kw):
                return ref.train_readings(cfg, weights, inp["proof"], "cuda",
                                          grid=grid, **kw)

            numbers, unsteady = compare.train_numbers, compare.train_unsteady
            faults = {"half_batch": {"half_batch": True}}
        else:
            def readings(**kw):
                return ref.inference(cfg, weights, inp["batch"], "cuda",
                                     grid=grid, **kw)

            def numbers(got, want):
                return compare.eval_numbers([got], want)

            unsteady, faults = None, {}
        base = readings()
        for name, kw in [("reference_again", {}), *faults.items(),
                         ("control", {"lower": True})]:
            # the control last: a float8 run that fails may leave the
            # device unusable, and it has then failed with no number
            got = readings(**kw)
            _say(kind=name, seed=seed, seconds=time.perf_counter() - t0,
                 numbers=numbers(got, base),
                 unsteady=unsteady(got, base) if unsteady else None,
                 **({"got": got, "reference": base}
                    if cell["traffic"] == "eval" else
                    {"loss": got["loss"], "reference_loss": base["loss"]}))
        session.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
