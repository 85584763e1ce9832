"""A configuration, a cell and a metric added as new files are found by
name, with no edit to the harness's code."""

import json

from benchmark import harness
from benchmark.tests import tiny


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    before = harness.listing(root)
    cfg = json.loads((root / "configs" / "deftet_res50.json").read_text())
    (root / "configs" / "deftet_res60.json").write_text(
        json.dumps({**cfg, "res": 60}))
    (root / "workloads" / "res60.train.json").write_text(json.dumps(
        {"config": "deftet_res60", "traffic": "train", "chips": 1,
         "why": "a later cell", "params": {}, "limits": {}}))
    (root / "metrics" / "steps_seen.train.py").write_text(
        "def read(run, ctx):\n    return run['window']['steps']\n")
    after = harness.listing(root)
    assert set(after["configs"]) - set(before["configs"]) == {"deftet_res60"}
    assert set(after["workloads"]) - set(before["workloads"]) == {
        "res60.train"}
    assert set(after["metrics"]) - set(before["metrics"]) == {
        "steps_seen.train"}
    cell, fields, meta = harness.load_cell("res60.train", root)
    assert fields["res"] == 60 and cell["traffic"] == "train"
    assert meta["source"] == cfg["source"]
    reader = harness.reader("steps_seen.train", root)
    assert reader.read({"window": {"steps": 7}}, None) == 7


def test_cell_metrics_follow_benchmark_json():
    spec = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    listed = set(harness.listing()["metrics"])
    for cell in (w["name"] for w in spec["workloads"]):
        e2e = {m["name"] for m in harness.cell_metrics(spec, cell, False)}
        layer = harness.cell_metrics(spec, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert e2e <= listed and {m["name"] for m in layer} <= listed
        assert all(m["moves"] in e2e for m in layer)
