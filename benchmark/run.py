"""Run one benchmark cell once on the CUDA device and print its result.

    python3 -m benchmark.run --workload res50.train --seed 7 --seconds 51 \
        --trace 0

Run from the root of a checkout.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; ``checks`` last: each
number compared, with its limit); the numbers compared are also the
last lines of standard error.  Without a CUDA device, with fewer devices
than the cell asks for, or with JAX or the JAX package loaded, it exits
with a code other than 0 and prints no result.  ``--list`` prints the
configurations, cells, drivers and metrics it finds.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402

CHECKOUT = harness.ROOT.parent


def _caches() -> None:
    """Every compile cache at a fixed path inside the checkout (the
    port's own kernels build into ``build/kernels`` and ``build/native``
    there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.run")
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--list", action="store_true")
    args = parser.parse_args(argv)
    if args.list:
        print(json.dumps(harness.listing()))
        return 0
    if not args.workload:
        parser.error("--workload is required")
    _caches()
    cell, config, _ = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; the benchmark never runs on the "
              "CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    with open(CHECKOUT / "BENCHMARK.json") as f:
        spec = json.load(f)
    ctx = harness.Context(name=args.workload, cell=cell, config=config,
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda",
                          root=harness.ROOT, t_start=T_START)
    result = harness.execute(ctx, spec)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
