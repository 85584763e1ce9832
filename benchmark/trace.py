"""The traced window's reduction: ``torch.profiler`` events to device
intervals, busy time, time by device operation and idle gaps named by
the CUDA runtime call the host was in (the aggregation of ``chip_profile.py``, kept
here so that the program cannot change it)."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Tuple

WINDOW = "benchmark.window"  # the record_function span of the window
_COPIES = ("memcpy", "memset")


@dataclasses.dataclass
class Trace:
    """Device operations (name, start s, end s) and host operations of
    one traced window, times from the window's start."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window_s: float
    steps: int

    def kernels(self):
        """Device operations that are kernel launches (no copies)."""
        return [d for d in self.device
                if not d[0].lower().startswith(_COPIES)]

    def busy_intervals(self):
        """The union of device operation intervals, in order."""
        out = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def seconds_of(self, pattern: str) -> float:
        """Device seconds of the operations whose name holds ``pattern``."""
        return sum(e - s for n, s, e in self.device if pattern in n)

    def count_of(self, pattern: str) -> int:
        return sum(1 for n, _, _ in self.device if pattern in n)

    def device_ops(self, top: int = 10):
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10):
        """The ``top`` longest gaps between device operations (the window's
        edges included), each named by the host event (a CUDA runtime
        call) running at its start, or else ``after <call>``, the last
        one that began before it (the host was in Python since)."""
        busy = self.busy_intervals()
        edges = [0.0] + [x for iv in busy for x in iv] + [self.window_s]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        host = sorted(self.host, key=lambda h: h[1])
        out = []
        for length, start in gaps:
            name = "(no host event before it)"
            for n, s, e in host:
                if s > start:
                    break
                name = n if e >= start else f"after {n}"
            out.append([name, length])
        return out


@contextlib.contextmanager
def traced(steps: int, sync):
    """Profile the enclosed window of ``steps`` steps; yields a list that
    holds the ``Trace`` once the block has ended.  ``sync`` waits for the
    device before the window closes.  Only CUDA activity is recorded
    (kernels, copies, and the runtime calls on the host that launch and
    wait for them), so the profiler adds little host time to each
    launch; the window spans the ``WINDOW`` span where the profiler
    keeps it, else every event recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    box: list = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield box
            sync()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = [e for e in events
              if e.name == WINDOW and e.device_type != cuda]
    if window:
        t0, t1 = window[0].time_range.start, window[0].time_range.end
    elif events:
        t0 = min(e.time_range.start for e in events)
        t1 = max(e.time_range.end for e in events)
    else:
        raise RuntimeError("the profiler recorded no event")
    device, host = [], []
    for e in events:
        if e.name == WINDOW or getattr(e, "is_user_annotation", False):
            continue  # spans, on the host and their copies on the device
        item = (e.name, (e.time_range.start - t0) * 1e-6,
                (e.time_range.end - t0) * 1e-6)
        (device if e.device_type == cuda else host).append(item)
    box.append(Trace(device, host, (t1 - t0) * 1e-6, steps))
