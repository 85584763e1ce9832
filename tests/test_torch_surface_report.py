"""``scripts/torch_surface_report.py``: the pieces of a predicted surface,
and the per-shape Hausdorff maxima whose mean is what ``cli eval``
reports at the same point count."""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import torch

from deftet_tpu_torch import cli
from deftet_tpu_torch.config import Experiment
from deftet_tpu_torch.data import batch_iterator
from deftet_tpu_torch.evals.harness import _predict
from deftet_tpu_torch.train import Engine

ROOT = Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location(
    "torch_surface_report", ROOT / "scripts" / "torch_surface_report.py")
surface_report = importlib.util.module_from_spec(spec)
spec.loader.exec_module(surface_report)

SMALL = ["--res", "4", "--batch_size", "2", "--n_point", "128",
         "--num_sample_points", "256", "--occ_sample", "128",
         "--per_face_samples", "4", "--encoder_blocks", "8,1,8;16,1,4",
         "--gcn_hidden", "16,8", "--pos_mlp_hidden", "8",
         "--occ_mlp_hidden", "16,8", "--epochs", "1", "--n_shapes", "6"]


def test_face_pieces():
    # a chain listed against the label order (it joins over several
    # rounds), a pair, and a lone face; equal sizes keep face order
    chain = [[8, 9, 10], [6, 7, 8], [4, 5, 6], [2, 3, 4], [0, 1, 2]]
    faces = np.array([[30, 31, 32], [20, 21, 22], *chain, [22, 23, 24]])
    assert surface_report.face_pieces(faces).tolist() == \
        [2, 1, 0, 0, 0, 0, 0, 1]
    assert surface_report.face_pieces(
        np.array([[5, 6, 7], [1, 2, 3]])).tolist() == [0, 1]
    assert surface_report.face_pieces(np.zeros((0, 3), int)).size == 0


def _split_the_grid(exp: Path) -> None:
    """Rescale the best checkpoint's occupancy head so that its threshold
    splits the validation batch's tets in half: one epoch of the tiny
    network predicts nearly the same logit everywhere, and no surface."""
    ckpt = exp / "ckpt" / "best.pt"
    experiment = Experiment.load(str(exp))
    config = experiment.config
    engine = Engine(config, device=torch.device("cpu"),
                    experiment=experiment)
    engine.restore("best")
    (batch,) = batch_iterator(cli._eval_val_set(str(exp), config),
                              config.batch_size)
    _, _, logits = _predict(engine.model, engine._prep_batch(batch),
                            engine.statics, config)
    tree = torch.load(ckpt, weights_only=False)
    head = "decoder_occ.classifier."
    tree["model"][head + "weight"] *= 100.0
    tree["model"][head + "bias"] = 100.0 * (tree["model"][head + "bias"]
                                            - logits.float().median())
    torch.save(tree, ckpt)


def test_report_matches_the_eval(tmp_path):
    """At 64 points (the stored GT samples) and at 512 (the GT mesh
    resampled) the mean of the per-shape maxima is the eval's
    ``hausdorff_max``; every piece is listed with its faces."""
    assert cli.main(["train", "--device", "cpu", *SMALL, "--dataset_root",
                     str(tmp_path / "data"), "--logdir",
                     str(tmp_path / "exp")]) == 0
    (exp,) = (tmp_path / "exp").iterdir()
    _split_the_grid(exp)
    out = surface_report.report(str(exp), points=(64, 512), device="cpu")
    assert len(out["shapes"]) == 2  # the one full validation batch
    for n in (64, 512):
        assert cli.main(["eval", "--device", "cpu", "--experiment_path",
                         str(exp), "--eval_points", str(n)]) == 0
        metrics = json.loads((exp / "result_update.json").read_text())
        assert math.isclose(out["hausdorff_max"][str(n)],
                            metrics["metrics"]["hausdorff_max"],
                            rel_tol=1e-5)
    for shape in out["shapes"]:
        assert shape["faces"] > 0
        assert sum(shape["piece_faces"].values()) <= shape["faces"]
        if shape["pieces"] <= surface_report.MAX_PIECES // 2:
            assert sum(shape["piece_faces"].values()) == shape["faces"]
        for at in shape["points"].values():
            assert math.isclose(at["hausdorff_max"], (
                at["gt_to_pred_max"] + at["pred_to_gt_max"]) / 2,
                rel_tol=1e-6)
            assert 0 <= at["gt_to_pred_piece"] < shape["pieces"]
            assert 0 <= at["pred_to_gt_piece"] < shape["pieces"]
            assert at["pred_to_gt_max"] <= max(shape["piece_far"].values()) \
                or shape["pieces"] > surface_report.MAX_PIECES
