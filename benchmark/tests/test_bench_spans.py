"""The program's spans on a traced window's clock (``benchmark/spans.py``)
and the metrics that read them, on a hand-made trace and hand-made
spans: the alignment's fit, its refusal when the anchors do not match one
to one, and each idle gap charged to the span open at its start."""

import dataclasses
import statistics
from pathlib import Path

import pytest

from benchmark import harness, spans
from benchmark.trace import Trace

OFFSET_NS = 5_000_000_000  # the host clock at the trace's zero
JITTER_NS = (0, 40, -40, 10)  # each anchor's error, ns


def _ns(t):
    return OFFSET_NS + round(t * 1e9)


def _span(sid, name, parent, step, start, end, **extra):
    return {"id": sid, "name": name, "parent": parent, "step": step,
            "start_ns": _ns(start), "end_ns": _ns(end), **extra}


def _window():
    """One update on a 1 s window: the host is in ``step.update``
    (forward, then the optimizer) from 0.1 to 0.5, then reads the terms
    from 0.5 to 0.8 and waits on its next batch from 0.8 to 0.9.  Each
    span records an event at its start and end (the anchors), and the
    device runs 0.2-0.3, 0.4-0.6 and 0.85-0.95."""
    export = {"spans": [
        _span(0, "engine.statics", -1, 0, -2.0, -1.0),
        _span(2, "step.forward", 1, 1, 0.1, 0.3, stream_ms=150.0),
        _span(3, "step.optimizer", 1, 1, 0.35, 0.45),
        _span(1, "step.update", -1, 1, 0.1, 0.5),
        _span(4, "engine.read", -1, 1, 0.5, 0.8),
        _span(5, "engine.next_batch", -1, 1, 0.8, 0.9),
    ], "dropped": 0}
    calls = sorted(t for s in export["spans"][1:]
                   for t in ((s["start_ns"] - OFFSET_NS) * 1e-9,
                             (s["end_ns"] - OFFSET_NS) * 1e-9))
    # each stamp pair brackets its call, the stamp after it by JITTER_NS
    # past the call's end; the window's first call also made its event
    export["anchors"] = [[_ns(t) - (3_000_000 if i == 0 else 500),
                          _ns(t) + JITTER_NS[i % 4] + 200]
                         for i, t in enumerate(calls)]
    host = [("cudaEventRecordWithFlags", t - 2e-7, t + 2e-7) for t in calls]
    host += [("cudaLaunchKernel", t, t + 1e-6)
             for t in (0.15, 0.36, 0.37, 0.44, 0.96)]
    device = [("k1", 0.2, 0.3), ("k2", 0.4, 0.6), ("k3", 0.85, 0.95)]
    return Trace(device, host, 1.0, steps=1), export


@dataclasses.dataclass
class Ctx:
    t_start: float


def _run(trace):
    # the window starts at the trace's zero; the process 3 s before it
    return {"trace": trace, "setup_s": 3.0,
            "window": {"seconds": 1.0}}, Ctx(OFFSET_NS * 1e-9 - 3.0)


def test_alignment_fits_the_offset_and_reports_the_residual():
    trace, export = _window()
    al = spans.align(trace, export, _ns(0.0), _ns(1.0))
    jitter = [JITTER_NS[i % 4] for i in range(10)]
    median = statistics.median(jitter)
    assert al.offset_s == pytest.approx((OFFSET_NS + median) * 1e-9,
                                        abs=2e-9)
    worst = max(abs(j - median) for j in jitter)
    assert al.residual_s == pytest.approx(worst * 1e-9, abs=2e-9)
    assert [s.name for s in al.spans] == [
        "step.update", "step.forward", "step.optimizer", "engine.read",
        "engine.next_batch"]  # the statics lie outside the window
    assert al.spans[1].start == pytest.approx(0.1, abs=1e-7)
    assert al.names(al.spans[2]) == {"step.optimizer", "step.update"}


def test_a_count_mismatch_aligns_nothing(capsys):
    trace, export = _window()
    export["anchors"] = export["anchors"][1:]
    assert spans.align(trace, export, _ns(0.0), _ns(1.0)) is None
    assert "9 event recordings in the window, 10" in capsys.readouterr().err
    assert spans.align(Trace(trace.device, [], 1.0, 1), export, _ns(0.0),
                       _ns(1.0)) is None


def test_each_gap_goes_to_the_span_open_at_its_start():
    trace, export = _window()
    al = spans.align(trace, export, _ns(0.0), _ns(1.0))
    got = [(sorted(names), round(length, 9))
           for names, length in spans.idle_by_span(trace, al)]
    assert got == [([], 0.2),  # before the update
                   (["step.update"], 0.1),  # 0.3-0.4, between its children
                   (["engine.read"], 0.25),  # 0.6-0.85, into next_batch
                   ([], 0.05)]  # 0.95-1.0, after the last span
    assert spans.launches_in(trace, al, "step.optimizer") == 3
    assert spans.launch_coverage(trace, al) == pytest.approx(0.8)


def test_the_readers(monkeypatch):
    trace, export = _window()
    monkeypatch.setattr(spans, "recorded", lambda: export)
    run, ctx = _run(trace)

    def read(name):
        return harness.reader(name).read(run, ctx)

    assert read("dispatch_idle_ms.train") == pytest.approx(100.0)
    assert read("read_idle_ms.train") == pytest.approx(250.0)
    assert read("input_idle_ms.train") == pytest.approx(0.0)
    assert read("optimizer_launches.train") == 3
    assert read("statics_s") == pytest.approx(1.0)
    assert read("pit_ms.eval") is None  # no such span
    export["spans"].append(_span(6, "eval.points_in_tets", -1, 2, 0.91,
                                 0.92, stream_ms=42.5))
    assert read("pit_ms.eval") == 42.5
    export["spans"][-1].pop("stream_ms")
    assert read("pit_ms.eval") is None  # an event not yet resolved


def test_readers_find_nothing_without_the_programs_spans(monkeypatch):
    trace, _ = _window()
    monkeypatch.setattr(spans, "recorded", lambda: None)
    run, ctx = _run(trace)
    for path in sorted(Path(harness.ROOT / "metrics").glob("*.py")):
        if "spans" in path.read_text():
            assert harness.reader(path.stem).read(run, ctx) is None, path
