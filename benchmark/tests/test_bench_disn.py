"""The DISN cell's files: its driver's inputs are a function of the
seed, the harness finds the configuration, cell, driver and reader by
name, and the cell runs end to end on the CPU at a tiny size, its
program and reference agreeing."""

import json
import math

import numpy as np

from benchmark import harness
from benchmark.reference import steps, steps_disn
from benchmark.tests import tiny

DISN_TINY = {"use_disn": True, "disn_width": 0.05, "disn_encoding_dim": 64,
             "disn_image_size": 32, "disn_local_feature_size": 16}
PARAMS = {"n_shapes": 4, "level": 1, "n_surface": 128, "occ_res": 16,
          "n_views": 2, "image_res": 40, "proof_steps": 3, "trace_steps": 2}


def _root(tmp_path):
    root = tiny.make_root(tmp_path)
    base = json.loads((harness.ROOT / "configs" /
                       "deftet_disn50.json").read_text())
    (root / "configs" / "tinydisn.json").write_text(json.dumps(
        {**base, **tiny.TINY, **DISN_TINY}))
    (root / "workloads" / "tiny.disn.json").write_text(json.dumps(
        {"config": "tinydisn", "traffic": "disn_train", "chips": 1,
         "why": "tiny DISN cell for the CPU tests", "params": PARAMS,
         "limits": {"loss_gap": 1e-5, "surface_gap": 1e-5,
                    "update_gap": 1e-4}}))
    return root


def _stream(root, seed, n=6):
    ctx = tiny.context(root, "tiny.disn", seed=seed)
    inp = harness.driver("disn_train", root).inputs(ctx)
    return inp["proof"] + [next(inp["stream"]) for _ in range(n - 3)]


def test_records_and_views_follow_the_seed(tmp_path):
    root = _root(tmp_path)
    big = 2**31 + 11
    a, b, c = _stream(root, big), _stream(root, big), _stream(root, big + 1)
    for x, y in zip(a, b):
        assert set(x) == {"surface_points", "occ_grid", "imgs", "cam_matrix"}
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert a[0]["imgs"].shape == (2, 40, 40, 3)
    for k in ("surface_points", "imgs", "cam_matrix"):
        assert not all(np.array_equal(x[k], y[k]) for x, y in zip(a, c))
    # a pass's two batches hold four shapes, each seen from one view
    views = {round(float(cam.sum()), 5) for x in a[:2]
             for cam in x["cam_matrix"]}
    assert len(views) == 4


def test_listing_shows_the_disn_files():
    got = harness.listing()
    assert "deftet_disn50" in got["configs"]
    assert "disn.train" in got["workloads"]
    assert "disn_train" in got["drivers"]
    assert "state_gib.disn" in got["metrics"]
    cell, fields, meta = harness.load_cell("disn.train")
    assert cell["traffic"] == "disn_train" and fields["use_disn"]
    assert fields["disn_width"] == 1.0 and meta["reduced"] == [
        "res", "batch_size"]


def test_tiny_disn_cell_runs_on_the_cpu(tmp_path):
    root = _root(tmp_path)
    ctx = tiny.context(root, "tiny.disn", seconds=0.5)
    out = harness.execute(ctx, tiny.spec_of(root))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s"}  # no CUDA: no peak memory
    run = harness.driver("disn_train", root).run(ctx)
    # the network has no buffers: every entry is a parameter, held three
    # times (itself, Adam's mu and nu) in float32
    shapes = steps_disn.state_shapes(steps.make_config(ctx.config))
    n_params = sum(math.prod(s) for _, s in shapes)
    got = harness.reader("state_gib.disn", root).read(run, ctx)
    assert got == 3 * 4 * n_params / 2**30
