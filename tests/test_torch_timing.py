"""The port's span recorder (``deftet_tpu_torch/utils/timing.py``) on the
CPU: nesting, parents and steps, self time, the bounded buffer, the CUDA
event path with its clock anchors (a fake event), no synchronize on any
path, and the spans mirrored into a ``torch.profiler`` trace.  Fit's
epoch seconds against their spans: ``test_torch_engine.py``."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deftet_tpu_torch.utils import timing


class FakeClock:
    """``perf_counter_ns`` advancing by ``step`` on every read."""

    def __init__(self, step=10):
        self.now, self.step = 0, step

    def __call__(self):
        self.now += self.step
        return self.now


class FakeEvent:
    """A CUDA event on a stream that completes everything at once."""

    recorded = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self):
        FakeEvent.recorded += 1
        self.at = FakeEvent.recorded

    def query(self):
        return True

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.fixture
def no_sync(monkeypatch):
    """Counts ``torch.cuda.synchronize`` calls (there must be none)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    return calls


def test_nesting_parents_steps_and_self_time(monkeypatch, no_sync):
    monkeypatch.setattr(timing.time, "perf_counter_ns", FakeClock())
    rec = timing.TimingRegistry()
    with rec.span("outer", new_step=True) as outer:
        with rec.span("a"):
            pass
        with rec.span("b"):
            with rec.span("a"):
                pass
    with rec.span("after"):
        pass
    with rec.span("next", new_step=True):
        pass
    spans = {(s["name"], s["id"]): s for s in rec.export()["spans"]}
    by_id = {s["id"]: s for s in spans.values()}
    ids = {name: sid for name, sid in spans}
    assert by_id[ids["outer"]]["parent"] == -1
    assert by_id[ids["b"]]["parent"] == ids["outer"]
    inner_a = [s for s in spans.values() if s["name"] == "a"]
    assert sorted(by_id[s["parent"]]["name"] for s in inner_a) == [
        "b", "outer"]
    assert [by_id[ids[n]]["step"] for n in ("outer", "after", "next")] == [
        1, 1, 2]
    assert all(s["step"] == 1 for s in inner_a)
    # every clock read advances 10 ns: a leaf span lasts 10 ns
    summary = rec.summary()
    assert summary["a"]["count"] == 2
    assert summary["a"]["total_s"] == pytest.approx(20e-9)
    assert summary["b"]["self_s"] == pytest.approx(
        summary["b"]["total_s"] - 10e-9)
    children = summary["a"]["total_s"] + summary["b"]["total_s"] - 10e-9
    assert summary["outer"]["self_s"] == pytest.approx(
        summary["outer"]["total_s"] - children)
    assert outer.seconds == pytest.approx(summary["outer"]["total_s"])
    assert rec.last("a") == pytest.approx(10e-9)
    assert summary["a"]["median_s"] == pytest.approx(10e-9)
    assert no_sync == []


def test_buffer_keeps_the_newest_and_the_aggregates_all(no_sync):
    rec = timing.TimingRegistry(capacity=4)
    for i in range(10):
        with rec.span(f"s{i % 2}"):
            pass
    out = rec.export()
    assert [s["id"] for s in out["spans"]] == [6, 7, 8, 9]
    assert out["dropped"] == 6
    summary = rec.summary()
    assert summary["s0"]["count"] == summary["s1"]["count"] == 5
    rec.reset()
    assert rec.export() == {"spans": [], "anchors": [], "dropped": 0}
    assert no_sync == []


def test_exception_closes_the_span_and_its_open_children(no_sync):
    rec = timing.TimingRegistry()
    with pytest.raises(ValueError):
        with rec.span("outer"):
            rec.span("left_open").__enter__()
            raise ValueError
    with rec.span("later"):
        pass
    names = [s["name"] for s in rec.export()["spans"]]
    assert names == ["outer", "later"]
    assert rec.export()["spans"][1]["parent"] == -1


def test_device_events_anchor_and_resolve_without_waiting(monkeypatch,
                                                           no_sync,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    rec = timing.TimingRegistry()
    with rec.span("off"):
        pass
    assert rec.export()["anchors"] == []  # off the device path
    rec.device_events = True
    with rec.span("outer"):
        with rec.span("inner"):
            pass
    out = rec.export()
    # two recordings a span, each stamped before and after on the host
    assert len(out["anchors"]) == 4
    assert all(a <= b for a, b in out["anchors"])
    stream = {s["name"]: s.get("stream_ms") for s in out["spans"]}
    # FakeEvent's clock counts recordings: outer 1..4, inner 2..3
    assert stream == {"off": None, "outer": 3.0, "inner": 1.0}
    rec.save(str(tmp_path / "timing.json"))
    saved = json.loads((tmp_path / "timing.json").read_text())
    assert saved["outer"]["stream_ms"] == 3.0
    assert saved["off"]["count"] == 1 and "stream_ms" not in saved["off"]
    assert no_sync == []


def test_spans_mirror_into_a_profiler_trace(no_sync):
    rec = timing.TimingRegistry()
    with rec.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("outer.span"):
            with rec.span("inner.span"):
                torch.ones(4).sum()
    with rec.span("after"):
        pass
    events = {e.name: e for e in prof.events()}
    assert {"outer.span", "inner.span"} <= set(events)
    assert not {"before", "after"} & set(events)
    outer, inner = events["outer.span"], events["inner.span"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert rec.export()["anchors"] == []  # no CUDA on the CPU
    assert no_sync == []
