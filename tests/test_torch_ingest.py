"""Mesh-directory ingestion: the port's watertight remesh and
build_dataset_from_meshes against the JAX package's on the three bundled
OBJ meshes (exactly), and ``cli preprocess`` -> ``train --mesh_dir
--use_disn --use_lap_layer`` -> ``eval`` in-process on the CPU at res 4."""

import glob
import json
import os

import numpy as np
import pytest

from deftet_tpu.data import pipeline as jax_pipeline
from deftet_tpu.data import watertight as jax_watertight
from deftet_tpu_torch import cli
from deftet_tpu_torch.data import pipeline, watertight
from deftet_tpu_torch.utils import load_obj

ASSETS = os.path.join(os.path.dirname(__file__), "assets", "meshes")
MESHES = sorted(glob.glob(os.path.join(ASSETS, "*.obj")))
SHARD = dict(n_surface=300, n_sdf=200, seed=3, watertight_res=24,
             num_workers=1, occ_grid_res=16)


@pytest.mark.parametrize("path", MESHES, ids=os.path.basename)
def test_watertight_matches_reference(path):
    verts, faces = load_obj(path)
    ref = jax_watertight.watertight_from_mesh(verts, faces, res=32)
    got = watertight.watertight_from_mesh(verts, faces, res=32)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[1].shape[0] > 100


def test_mesh_shards_match_reference(tmp_path):
    """Every shard, key for key and bit for bit, images and cameras
    included, and the category from the directory's name."""
    ref = jax_pipeline.build_dataset_from_meshes(
        str(tmp_path / "jax"), ASSETS, with_images=True, **SHARD)
    got = pipeline.build_dataset_from_meshes(
        str(tmp_path / "port"), ASSETS, with_images=True, **SHARD)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref] and len(got) == 3
    for a, b in zip(got, ref):
        with np.load(a) as da, np.load(b) as db:
            assert set(da.files) == set(db.files)
            assert {"imgs", "cam_matrix", "category"} <= set(da.files)
            for key in db.files:
                np.testing.assert_array_equal(da[key], db[key], err_msg=key)
                assert da[key].dtype == db[key].dtype, key
            assert str(da["category"]) == "meshes"
    batch = next(pipeline.batch_iterator(pipeline.ShapeDataset(got), 2))
    assert batch["imgs"].shape == (2, 64, 64, 3)
    assert batch["cam_matrix"].shape == (2, 4, 4)


def test_cli_preprocess_train_eval_disn_lap_on_cpu(tmp_path, capsys):
    """The user path end to end on the CPU: ingest the meshes with images,
    train the image-conditioned network with the lap layer on them, then
    evaluate the experiment."""
    cache = str(tmp_path / "cache")
    assert cli.main(["preprocess", "--mesh_dir", ASSETS, "--dataset_root",
                     cache, "--n_surface", "256", "--n_sdf", "256",
                     "--watertight_res", "24", "--with_images",
                     "--num_workers", "1"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["n_shards"] == 3
    logdir = str(tmp_path / "exp")
    assert cli.main([
        "train", "--device", "cpu", "--res", "4", "--batch_size", "2",
        "--n_point", "128", "--num_sample_points", "256",
        "--occ_sample", "128", "--per_face_samples", "4", "--epochs", "1",
        "--use_disn", "--use_lap_layer", "--disn_width", "0.05",
        "--disn_encoding_dim", "64", "--disn_image_size", "32",
        "--disn_local_feature_size", "16", "--mesh_dir", ASSETS,
        "--watertight_res", "24", "--dataset_root", cache,
        "--logdir", logdir]) == 0
    assert "best occupancy IoU" in capsys.readouterr().out
    (exp,) = glob.glob(os.path.join(logdir, "*"))
    config = json.load(open(os.path.join(exp, "config.json")))
    assert config["use_disn"] and config["use_lap_layer"]
    assert cli.main(["eval", "--device", "cpu", "--experiment_path", exp,
                     "--eval_points", "2000"]) == 0
    report = json.load(open(os.path.join(exp, "result_update.json")))
    for key in ("occ_iou", "val_iou_max", "f_score", "chamfer",
                "hausdorff"):
        assert np.isfinite(report["metrics"][key]), key
    assert "meshes" in report["per_category"]
