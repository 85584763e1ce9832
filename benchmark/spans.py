"""The program's spans on the clock of a traced window.

The port records its spans in one process-wide recorder
(``deftet_tpu_torch.utils.timing.RECORDER``) on the host clock
(``time.perf_counter_ns``), which is the clock of ``ctx.t_start`` and of
the window's start (``ctx.t_start + run["setup_s"]``).  ``trace.Trace``
keeps the profiler's clock and drops user annotations, so the two are
joined by anchors: while a profiler records, every span records a CUDA
event at its start and end, and the recorder stamps the host clock
around each of those calls; the profiler records the same calls as host
events (``cudaEventRecordWithFlags`` on the H100's PyTorch).  The k-th
anchor of the window is matched to the k-th such event, the stamp after
the call to the call's end (the stamp before it also holds the event's
creation, where one is made: up to milliseconds at the window's first
call); the offset is their median difference, and the largest
difference from it is reported as the residual.  Where the counts differ, or the
program records no spans (a checkout before them), nothing is aligned,
standard error says why, and every reader here returns None: a metric is
never read from a guessed alignment.

Idle time: each gap between busy device intervals of the window
(``Trace.busy_intervals``, the window's edges included) is charged whole
to the innermost program span open on the host at the gap's start.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
import sys
from typing import Dict, List, Optional

ANCHOR = "cudaEventRecord"  # the runtime call's name starts so
LAUNCH = "LaunchKernel"


@dataclasses.dataclass
class Span:
    """A program span, its times in seconds on the trace's clock."""

    id: int
    name: str
    parent: int
    step: int
    start: float
    end: float
    stream_ms: Optional[float] = None


@dataclasses.dataclass
class Aligned:
    """The window's spans on the trace's clock (``spans``, by start),
    every span the recorder holds by id (``by_id``, for the parents),
    the fitted offset (host clock less trace clock, s) and the largest
    residual of an anchor from it (s)."""

    spans: List[Span]
    by_id: Dict[int, Span]
    offset_s: float
    residual_s: float
    anchors: int

    def __post_init__(self):
        self.starts = [s.start for s in self.spans]

    def names(self, span: Optional[Span]) -> set:
        """Names of ``span`` and of every span it runs inside."""
        out = set()
        while span is not None:
            out.add(span.name)
            span = self.by_id.get(span.parent)
        return out

    def innermost_at(self, t: float) -> Optional[Span]:
        """The innermost window span open at ``t``: of those containing
        it, the one that started last."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[i].end > t:
                return self.spans[i]
        return None


def recorded():
    """The program's recorder's export, or None where it has none."""
    try:
        from deftet_tpu_torch.utils import timing
    except ImportError:
        return None
    recorder = getattr(timing, "RECORDER", None)
    return None if recorder is None else recorder.export()


def window_ns(run, ctx):
    """(start, end) of the measured window on the host clock, in ns."""
    t0 = ctx.t_start + run["setup_s"]
    return (round(t0 * 1e9), round((t0 + run["window"]["seconds"]) * 1e9))


def between(name: str, t0_ns: int, t1_ns: int) -> Optional[list]:
    """The recorder's spans ``name`` (export dicts) that lie in [t0_ns,
    t1_ns] on the host clock, or None where the program records none."""
    export = recorded()
    if export is None:
        return None
    return [s for s in export["spans"] if s["name"] == name
            and t0_ns <= s["start_ns"] and s["end_ns"] <= t1_ns]


def align(trace, export, t0_ns: int, t1_ns: int) -> Optional[Aligned]:
    """The spans of ``export`` that lie in [t0_ns, t1_ns] on the clock of
    ``trace``, or None where the anchors do not match one to one."""
    anchors = [a for a in export["anchors"] if t0_ns <= a[0] and a[1]
               <= t1_ns]
    calls = sorted((h for h in trace.host if h[0].startswith(ANCHOR)),
                   key=lambda h: h[1])
    if not anchors or len(anchors) != len(calls):
        print(f"spans: {len(anchors)} event recordings in the window, "
              f"{len(calls)} {ANCHOR} calls traced: not aligned",
              file=sys.stderr)
        return None
    diffs = [b * 1e-9 - e for (_, b), (_, _, e) in zip(anchors, calls)]
    offset = statistics.median(diffs)
    residual = max(abs(d - offset) for d in diffs)
    by_id = {}
    for s in export["spans"]:
        by_id[s["id"]] = Span(s["id"], s["name"], s["parent"], s["step"],
                              s["start_ns"] * 1e-9 - offset,
                              s["end_ns"] * 1e-9 - offset,
                              s.get("stream_ms"))
    spans = sorted((by_id[s["id"]] for s in export["spans"]
                    if t0_ns <= s["start_ns"] and s["end_ns"] <= t1_ns),
                   key=lambda s: (s.start, s.id))  # a parent first
    return Aligned(spans, by_id, offset, residual, len(anchors))


_LAST: list = [None, None]  # the trace aligned last, and its spans


def aligned(run, ctx) -> Optional[Aligned]:
    """The traced run's aligned spans (computed once a run), or None."""
    trace = run.get("trace")
    if trace is None:
        return None
    if _LAST[0] is not trace:
        export = recorded()
        got = None if export is None else align(trace, export,
                                                *window_ns(run, ctx))
        _LAST[:] = [trace, got]
        if export is None:
            print("spans: the program records no spans", file=sys.stderr)
        elif got is not None:
            print(f"spans: {got.anchors} anchors, offset {got.offset_s!r} "
                  f"s, largest residual {got.residual_s * 1e6!r} us",
                  file=sys.stderr)
    return _LAST[1]


def idle_gaps(trace):
    """Every gap (start, length) between busy device intervals of the
    window, its edges included."""
    edges = [0.0] + [x for iv in trace.busy_intervals() for x in iv]
    edges.append(trace.window_s)
    return [(edges[i], edges[i + 1] - edges[i])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def idle_by_span(trace, al: Aligned) -> List[tuple]:
    """(names of the innermost span open at the gap's start and of its
    ancestors, or an empty set, gap seconds) for every gap."""
    return [(al.names(al.innermost_at(start)), length)
            for start, length in idle_gaps(trace)]


def idle_ms_per_step(run, ctx, inside, outside=()) -> Optional[float]:
    """Idle ms a traced step in gaps that start inside a span named in
    ``inside`` and inside none named in ``outside``."""
    al = aligned(run, ctx)
    trace = run.get("trace")
    if al is None or not trace.steps:
        return None
    total = sum(length for names, length in idle_by_span(trace, al)
                if names & set(inside) and not names & set(outside))
    return 1e3 * total / trace.steps


def launches_in(trace, al: Aligned, name: str) -> int:
    """Kernel launches on the host (``LAUNCH`` events) that start inside
    a window span ``name``."""
    spans = [s for s in al.spans if s.name == name]
    starts = [s.start for s in spans]
    n = 0
    for h, s, _ in trace.host:
        if LAUNCH not in h:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < spans[i].end:
            n += 1
    return n


def launch_coverage(trace, al: Aligned) -> Optional[float]:
    """Share of the window's ``LAUNCH`` host events that start inside
    some program span (no metric: PERF.md reports it per cell)."""
    launches = [s for h, s, _ in trace.host if LAUNCH in h]
    if not launches:
        return None
    inside = sum(1 for t in launches if al.innermost_at(t) is not None)
    return inside / len(launches)
