"""What the drivers share: the program's engine, the run's weights, the
device's description and the run's scratch directory."""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import subprocess
import tempfile

import torch

from .reference import steps as ref
from .weights import seeded_state


def program_engine(fields: dict, device: str, logdir: str):
    """The port's ``Engine`` for the configuration ``fields``, its
    experiment log under ``logdir``."""
    from deftet_tpu_torch.config import TrainConfig
    from deftet_tpu_torch.train import Engine

    names = {f.name for f in dataclasses.fields(TrainConfig)}
    config = TrainConfig(**{k: v for k, v in fields.items() if k in names})
    config.logdir = logdir
    return Engine(config, device=device)


def weights(config, seed: int, device: str) -> dict:
    """The run's parameters and buffers (see ``weights.py``), made on the
    device from the seed, named as the network names them."""
    return seeded_state(ref.state_shapes(config), seed, device)


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device: str) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def power_limit_w():
    """The card's power limit in watts, from ``nvidia-smi``; None where
    it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(device: str, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak,
            "power_limit_w": power_limit_w()}


def free(device: str) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def scratch_dir():
    """A directory under the run's TMPDIR for the engine's experiment
    log, removed when the run ends."""
    path = tempfile.mkdtemp(prefix="deftet-bench-")
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)
