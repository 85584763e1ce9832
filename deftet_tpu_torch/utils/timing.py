"""Spans of the port's layers: one process-wide recorder, ``RECORDER``
(torch port of deftet_tpu/utils/timing.py, rebuilt).

A span is a named host interval (``time.perf_counter_ns``) with the id
of the span it runs inside and the id of the update or inference step it
belongs to (a span opened with ``new_step=True`` starts the next step).
Spans nest on one thread::

    with span("step.update", new_step=True):
        with span("step.forward"):
            ...

The recorder keeps the latest ``capacity`` closed spans in memory and,
per name, running aggregates of count, total and self time (a span's
duration less its children's); ``summary`` adds the median of the spans
still held, ``export`` hands out the spans, ``save`` writes the summary
as JSON (``Engine.save``'s ``timing.json``).  It never synchronizes.

Off the device path a span costs two host stamps and an append.  On it
(a ``torch.profiler`` recording, or ``device_events`` set, which
``Engine`` sets from ``config.timing``) each span also records a CUDA
event on the current stream at its start and end, where CUDA is in use.
Their stream time is read only once the end event has completed
(``resolve``, which queries, never waits).  The host clock is stamped
around every such ``cudaEventRecord`` (``anchors``): a profiler trace
that records the calls can be put on this clock by them.  While a
profiler records, each span also opens ``torch.profiler.record_function``
under its name, so exported traces show the spans.
"""

from __future__ import annotations

import collections
import json
import statistics
import time
from typing import Dict, List

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 65_536  # closed spans held; the oldest go first


class Timer:
    """One span of a ``TimingRegistry`` (``registry.span(name)``), used
    as a context manager; once closed, ``seconds`` is its host
    duration."""

    __slots__ = ("registry", "name", "new_step", "id", "parent", "step",
                 "start", "end", "child_ns", "events", "annotation")

    def __init__(self, registry: "TimingRegistry", name: str,
                 new_step: bool = False):
        self.registry = registry
        self.name = name
        self.new_step = new_step
        self.end = None

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter_ns()
        rec = self.registry
        stack = rec._stack
        self.parent = stack[-1].id if stack else -1
        if self.new_step:
            rec.step += 1
        self.step = rec.step
        self.id = rec._next_id
        rec._next_id += 1
        self.child_ns = 0
        self.annotation = self.events = None
        if _profiler._is_profiler_enabled or rec.device_events:
            rec._open_device(self)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.registry
        stack = rec._stack
        while stack and stack.pop() is not self:
            pass  # a child left open by an exception closes with it
        if self.events is not None or self.annotation is not None:
            rec._close_device(self)
        end = self.end = time.perf_counter_ns()
        ns = end - self.start
        if stack:
            stack[-1].child_ns += ns
        name = self.name
        rec.spans.append((self.id, name, self.parent, self.step, self.start,
                          end))
        agg = rec.stats.get(name)
        if agg is None:
            agg = rec.stats[name] = [0, 0, 0, 0]
        agg[0] += 1
        agg[1] += ns
        agg[2] += ns - self.child_ns
        agg[3] = ns
        return False

    @property
    def seconds(self) -> float:
        if self.end is None:
            raise RuntimeError(f"span {self.name} is still open")
        return (self.end - self.start) * 1e-9


class TimingRegistry:
    """The span recorder (see the module doc)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.device_events = False
        self.reset()

    def reset(self) -> None:
        """Forget every span, aggregate, anchor and pending event."""
        # (id, name, parent id or -1, step, start ns, end ns)
        self.spans: collections.deque = collections.deque(
            maxlen=self.capacity)
        # (ns before, ns after) around each cudaEventRecord, in call order
        self.anchors: collections.deque = collections.deque(
            maxlen=2 * self.capacity)
        self.device_ms: collections.deque = collections.deque(
            maxlen=self.capacity)  # (span id, stream ms)
        # name -> [count, total ns, self ns, the latest span's ns]
        self.stats: Dict[str, list] = {}
        self.step = 0
        self._next_id = 0
        self._stack: List[Timer] = []
        self._pending: list = []  # (span id, start event, end event)
        self._free: list = []  # resolved events, recorded again

    def span(self, name: str, new_step: bool = False) -> Timer:
        return Timer(self, name, new_step)

    def _record(self):
        event = (self._free.pop() if self._free
                 else torch.cuda.Event(enable_timing=True))
        before = time.perf_counter_ns()
        event.record()
        self.anchors.append((before, time.perf_counter_ns()))
        return event

    def _open_device(self, t: Timer) -> None:
        if _profiler._is_profiler_enabled:
            t.annotation = torch.profiler.record_function(t.name)
            t.annotation.__enter__()
        if torch.cuda.is_initialized():
            t.events = self._record()

    def _close_device(self, t: Timer) -> None:
        if t.events is not None:
            self._pending.append((t.id, t.events, self._record()))
            if len(self._pending) >= 1024:
                self.resolve()
        if t.annotation is not None:
            t.annotation.__exit__(None, None, None)

    def last(self, name: str) -> float:
        """Host seconds of the latest closed span ``name``."""
        return self.stats[name][3] * 1e-9

    def resolve(self) -> None:
        """Stream milliseconds of the spans whose end event has completed
        (queried in the order recorded, which is the stream's)."""
        done = 0
        for sid, start, end in self._pending:
            if not end.query():
                break
            self.device_ms.append((sid, start.elapsed_time(end)))
            self._free += (start, end)
            done += 1
        del self._pending[:done]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per name: count, total and self seconds, the median seconds of
        the spans held, and the summed stream ms of those with events."""
        self.resolve()
        held: Dict[str, list] = {}
        names = {}
        for sid, name, _, _, start, end in self.spans:
            held.setdefault(name, []).append(end - start)
            names[sid] = name
        stream: Dict[str, list] = {}
        for sid, ms in self.device_ms:
            if sid in names:
                stream.setdefault(names[sid], []).append(ms)
        out = {}
        for name, (count, ns, self_ns, _) in self.stats.items():
            out[name] = {"count": count, "total_s": ns * 1e-9,
                         "self_s": self_ns * 1e-9,
                         "median_s": statistics.median(held[name]) * 1e-9
                         if name in held else None}
            if name in stream:
                out[name]["stream_ms"] = sum(stream[name])
                out[name]["stream_count"] = len(stream[name])
        return out

    def export(self) -> Dict[str, list]:
        """The spans held (dicts: ``id``, ``name``, ``parent``, ``step``,
        ``start_ns``, ``end_ns`` and, where resolved, ``stream_ms``), the
        anchors, and the count of spans dropped from the buffer."""
        self.resolve()
        stream = dict(self.device_ms)
        spans = [{"id": sid, "name": name, "parent": parent, "step": step,
                  "start_ns": start, "end_ns": end,
                  **({"stream_ms": stream[sid]} if sid in stream else {})}
                 for sid, name, parent, step, start, end in self.spans]
        return {"spans": spans, "anchors": [list(a) for a in self.anchors],
                "dropped": self._next_id - len(self._stack) - len(spans)}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


RECORDER = TimingRegistry()
span = RECORDER.span

