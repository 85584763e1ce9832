"""The uncompacted surface path (``max_boundary_faces=0``) on the regular
lattice: ``forward_losses`` with gradients against the JAX package at
res 4 (float32: terms rtol 1e-4, gradients 1e-3), and ``cli train
--max_boundary_faces 0`` then ``eval`` in process."""

import json

import numpy as np

import test_torch_gather_step as gs
from deftet_tpu_torch import cli


def test_forward_losses_lattice_budget0_match_reference():
    gs.check_forward_losses("lattice_budget0")


def test_cli_train_uncompacted_then_eval(tmp_path):
    small = ["--device", "cpu", "--res", "4", "--batch_size", "2",
             "--n_point", "128", "--num_sample_points", "256",
             "--occ_sample", "128", "--per_face_samples", "4",
             "--encoder_blocks", "8,1,8;16,1,4", "--gcn_hidden", "16,8",
             "--pos_mlp_hidden", "8", "--occ_mlp_hidden", "16,8",
             "--epochs", "1", "--n_shapes", "6", "--max_boundary_faces", "0"]
    assert cli.main(["train", *small, "--dataset_root",
                     str(tmp_path / "data"), "--logdir",
                     str(tmp_path / "exp")]) == 0
    (exp,) = (tmp_path / "exp").iterdir()
    assert json.loads((exp / "config.json").read_text())[
        "max_boundary_faces"] == 0
    assert cli.main(["eval", "--device", "cpu", "--experiment_path",
                     str(exp), "--eval_points", "2000"]) == 0
    report = json.loads((exp / "result_update.json").read_text())
    for key in ("occ_iou", "f_score", "chamfer", "hausdorff",
                "n_boundary", "boundary_overflow"):
        assert np.isfinite(report["metrics"][key]), key
    assert report["metrics"]["boundary_overflow"] == 0.0
