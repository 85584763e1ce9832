"""Where the time of the full-width train step goes on one NVIDIA GPU.

    python3 chip_profile.py [main|lap|disn|uncompacted|gather|ddp]

Builds bench.py's res-50 / batch-4 configuration through the port's
``Engine`` (as ``chip_smoke.py`` does; ``lap`` adds the lap layer,
``disn`` swaps in the DISN image branch at its default widths and feeds
it chip_smoke's rendered images, ``uncompacted`` sets
``max_boundary_faces=0``, ``gather`` runs on chip_smoke's res-25 grid
split 1->8, a non-lattice grid of the same size, through
``Engine(config, statics=...)``), runs two warm-up steps, then
traces three steps with ``torch.profiler`` and prints, after the card's
name and power limit, one JSON line:
the wall time per step, the device busy share (sum of kernel time over
wall time), the device time and share of each hand-written kernel (K1,
K2, K3) with its CUDA launches beside its wrapper calls per step (which
must agree), and the device time by kernel name, largest first.  The full table goes to
``chiprun_out/profile_table.txt`` when that directory exists.
With another configuration than ``main`` the table's file name ends in
its name (``_lap``, ``_disn``, ...).

``ddp`` traces the main configuration as two ranks of 2 rows sharing
the one card over gloo (``parallel.run_ranks``), and in the same call
one process at 2 rows (a rank's share) and at 4 (the global batch), so
that a rank's step splits into its own device work, the random draws it
takes at the global batch's shape, the host time inside the
collectives, and the rest (the other rank's kernels on the shared card).
Each trace adds ``rng_ms_per_step`` (the kernels that draw numbers),
``copy_ms_per_step`` (device copies, gloo's included) and
``collectives`` (host milliseconds and calls per step of each
all-reduce and broadcast op).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from chip_smoke import bench_batch, bench_config, header

STEPS = 3
# hand-written kernel -> (launch counter, the name its CUDA kernels carry)
OURS = {"K1 stencil": ("stencil", "stencil_kernel"),
        "K2 nearest": ("nearest", "nearest_kernel"),
        "K3 tri_argmin": ("tri_argmin", "tri_argmin_kernel")}
# device kernels that draw random numbers (philox, distributions,
# multinomial, randperm), and device copies
RNG = ("distribution", "philox", "multinomial", "randperm", "bernoulli",
       "normal_kernel", "uniform_kernel")
COPY = ("memcpy", "memset")
# host-side ops of the collectives
COLLECTIVES = ("allreduce", "all_reduce", "broadcast")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from deftet_tpu_torch.train import Engine

    which = sys.argv[1] if len(sys.argv) > 1 else "main"
    configs = {"main": bench_config, "lap": chip_smoke.lap_config,
               "disn": chip_smoke.disn_config,
               "uncompacted": chip_smoke.uncompacted_config,
               "gather": bench_config, "ddp": bench_config}
    if which not in configs:
        print(f"chip_profile: unknown configuration {which!r} "
              f"({', '.join(configs)})", file=sys.stderr)
        return 2
    header()
    if which == "ddp":
        return _ddp()
    config = configs[which]()
    statics = None
    if which == "gather":
        from deftet_tpu_torch.train import build_grid_statics

        grid, _ = chip_smoke.split_grid_50()
        statics = build_grid_statics(config.res, grid=grid, device="cuda")
    engine = Engine(config, device="cuda", statics=statics)
    batch = bench_batch(config)
    if config.use_disn:
        batch = chip_smoke.image_batch(batch, range(config.batch_size))
    table = "profile_table.txt" if which == "main" else \
        f"profile_table_{which}.txt"
    report = _trace(engine, engine._prep_batch(batch), table)
    print(json.dumps({"config": which, **report}), flush=True)
    return 0


def _trace(engine, batch, table: str, sync=None) -> dict:
    """Two warm-up steps, then ``STEPS`` traced ones; the report of
    ``main``'s JSON line (its table written to ``chiprun_out/table``).
    ``sync``, where given, runs before each step (the ranks' barrier)."""
    from deftet_tpu_torch.ops import _cuda

    sync = sync or (lambda: None)
    for _ in range(2):
        sync()
        engine.train_step(batch)
    torch.cuda.synchronize()
    sync()
    _cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            engine.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    # the port's spans show on the device timeline as user annotations:
    # not device work
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    by_name = sorted(((e.key, e.self_device_time_total / 1e3 / STEPS,
                       e.count // STEPS) for e in events),
                     key=lambda t: -t[1])
    device_ms = sum(t for _, t, _ in by_name)
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    ours = {
        label: {"ms_per_step": ms, "share_of_device": ms / device_ms,
                "launches_per_step": sum(c for k, _, c in by_name
                                         if pat in k),
                "wrapper_calls_per_step": _cuda.launch_counts[name] / STEPS}
        for label, (name, pat) in OURS.items()
        for ms in [sum(t for k, t, _ in by_name if pat in k)]
    }
    # each wrapper call launches one kernel of its name (a memset of merge
    # scratch, where a call makes one, is no kernel launch)
    for label, row in ours.items():
        if row["launches_per_step"] != row["wrapper_calls_per_step"]:
            raise RuntimeError(f"{label}: {row['launches_per_step']} CUDA "
                               "launches per step against "
                               f"{row['wrapper_calls_per_step']} wrapper "
                               "calls: the name pattern misses a kernel")
    ours_ms = sum(v["ms_per_step"] for v in ours.values())
    step_ms = wall * 1e3 / STEPS
    def device_ms_of(patterns):
        return sum(t for k, t, _ in by_name
                   if any(p in k.lower() for p in patterns))

    collectives = {
        e.key: {"host_ms_per_step": e.cpu_time_total / 1e3 / STEPS,
                "calls_per_step": e.count / STEPS}
        for e in averages
        if e.device_type == torch.autograd.DeviceType.CPU
        and any(p in e.key.lower() for p in COLLECTIVES)}
    out = Path("chiprun_out")
    if out.is_dir():
        (out / table).write_text(averages.table(
            sort_by="self_device_time_total", row_limit=60))
    return {
        "device": torch.cuda.get_device_name(0),
        "steps": STEPS,
        "step_ms": step_ms, "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / step_ms,
        "hand_written_kernels_ms_per_step": ours_ms,
        "hand_written_kernels": ours,
        "kernels_per_step": sum(c for _, _, c in by_name),
        "rng_ms_per_step": device_ms_of(RNG),
        "copy_ms_per_step": device_ms_of(COPY),
        "collectives": collectives,
        "top": [{"name": k[:90], "ms_per_step": t, "launches_per_step": c}
                for k, t, c in by_name[:25]],
    }


def _ddp_rank(world, config, batch_np):
    from deftet_tpu_torch.train import Engine

    engine = Engine(config, world=world)
    report = _trace(engine, engine._prep_batch(batch_np),
                    f"profile_table_ddp_rank{world.rank}.txt",
                    sync=torch.distributed.barrier)
    return {"rank": world.rank, "backend": world.backend, **report}


def _ddp() -> int:
    """One process at 2 rows and at 4, then two ranks of 2 rows sharing
    the card over gloo, each traced; one JSON line with the three."""
    import dataclasses

    from deftet_tpu_torch import parallel
    from deftet_tpu_torch.train import Engine

    config = bench_config()
    batch = bench_batch(config)
    single = {}
    # the one-process runs also build the kernels before the ranks start
    for rows in (2, 4):
        cfg = dataclasses.replace(config, batch_size=rows)
        engine = Engine(cfg, device="cuda")
        part = {k: v[:rows] for k, v in batch.items()}
        single[f"one_process_{rows}_rows"] = _trace(
            engine, engine._prep_batch(part),
            f"profile_table_ddp_single{rows}.txt")
        del engine
        torch.cuda.empty_cache()
    ranks = parallel.run_ranks(_ddp_rank, 2, config, batch, device="cuda")
    print(json.dumps({"config": "ddp",
                      "note": "two ranks share one card: not a scaling "
                              "number",
                      **single, "ranks": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
