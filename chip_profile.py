"""Where the time of the full-width train step goes on one NVIDIA GPU.

    python3 chip_profile.py [main|lap|disn]

Builds bench.py's res-50 / batch-4 configuration through the port's
``Engine`` (as ``chip_smoke.py`` does; ``lap`` adds the lap layer,
``disn`` swaps in the DISN image branch at its default widths and feeds
it chip_smoke's rendered images), runs two warm-up steps, then
traces three steps with ``torch.profiler`` and prints, after the card's
name and power limit, one JSON line:
the wall time per step, the device busy share (sum of kernel time over
wall time), the device time and share of each hand-written kernel (K1,
K2, K3) with its CUDA launches beside its wrapper calls per step (which
must agree), and the device time by kernel name, largest first.  The full table goes to
``chiprun_out/profile_table.txt`` when that directory exists.
With ``lap`` or ``disn`` the table's file name ends in ``_lap`` or
``_disn``.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from deftet_tpu_torch.ops import _cuda
    from deftet_tpu_torch.train import Engine

    which = sys.argv[1] if len(sys.argv) > 1 else "main"
    configs = {"main": bench_config, "lap": chip_smoke.lap_config,
               "disn": chip_smoke.disn_config}
    if which not in configs:
        print(f"chip_profile: unknown configuration {which!r} "
              f"({', '.join(configs)})", file=sys.stderr)
        return 2
    header()
    config = configs[which]()
    engine = Engine(config, device="cuda")
    batch = bench_batch(config)
    if config.use_disn:
        batch = chip_smoke.image_batch(batch, range(config.batch_size))
    batch = engine._prep_batch(batch)
    for _ in range(2):
        engine.train_step(batch)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            engine.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
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
    out = Path("chiprun_out")
    if out.is_dir():
        table = "profile_table.txt" if which == "main" else \
            f"profile_table_{which}.txt"
        (out / table).write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    print(json.dumps({
        "config": which, "device": torch.cuda.get_device_name(0),
        "steps": STEPS,
        "step_ms": step_ms, "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / step_ms,
        "hand_written_kernels_ms_per_step": ours_ms,
        "hand_written_kernels": ours,
        "kernels_per_step": sum(c for _, _, c in by_name),
        "top": [{"name": k[:90], "ms_per_step": t, "launches_per_step": c}
                for k, t, c in by_name[:25]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
