"""Named timers with device synchronization and rolling statistics (torch
port of deftet_tpu/utils/timing.py).

A region's time is the host clock from its start to the end of the work it
queued: ``stop`` synchronizes the CUDA device first (``torch.cuda.
synchronize``), since PyTorch returns before the card finishes.  Keeps at
most ``max_samples`` samples and reports a trimmed mean and the median;
``TimingRegistry.save`` writes them as JSON.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

import torch


class Timer:
    def __init__(self, name: str, max_samples: int = 500):
        self.name = name
        self.max_samples = max_samples
        self.samples = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, device=None) -> float:
        """Ends the region; with a CUDA ``device`` the card is synchronized
        first, so that the work queued in the region is included."""
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        if self._t0 is None:
            raise RuntimeError(f"timer {self.name} not started")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.samples.append(dt)
        if len(self.samples) > self.max_samples:
            self.samples = self.samples[-self.max_samples:]
        return dt

    def trimmed_mean(self, trim: float = 0.1) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        k = int(len(s) * trim)
        trimmed = s[k: len(s) - k] or s
        return sum(trimmed) / len(trimmed)

    def median(self) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[len(s) // 2]

    def summary(self) -> Dict[str, float]:
        return {
            "count": len(self.samples),
            "mean": self.trimmed_mean(),
            "median": self.median(),
            "last": self.samples[-1] if self.samples else 0.0,
        }


class TimingRegistry:
    """Named timers and their JSON snapshot."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = device
        self.timers: Dict[str, Timer] = {}

    def timer(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    @contextlib.contextmanager
    def region(self, name: str):
        """Times the block, synchronizing the registry's device on exit."""
        if not self.enabled:
            yield
            return
        t = self.timer(name)
        t.start()
        try:
            yield
        finally:
            t.stop(self.device)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {k: t.summary() for k, t in self.timers.items()}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
