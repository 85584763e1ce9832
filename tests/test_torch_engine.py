"""The port's data pipeline, engine and CLI: the dataset copies against the
JAX package's originals, ``Engine.fit``, checkpoints, the warm start and
the two commands on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp
from deftet_tpu import cli as jax_cli
from deftet_tpu.data import pipeline as jax_pipeline
from deftet_tpu.data import shapes as jax_shapes
from deftet_tpu_torch import cli
from deftet_tpu_torch.data import pipeline, shapes
from deftet_tpu_torch.train import Engine

ROOT = Path(__file__).resolve().parents[1]

# the small network of the parity tests, at the verify recipe's sizes
TINY = dict(n_point=128, num_sample_points=256, occ_sample=128,
            per_face_samples=4, epochs=2, n_shapes=6, seed=1)


def _equal_trees(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], (str, list)):
            assert a[k] == b[k], k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize("level", [1, 4])  # <= 2048 faces, and the KD tree
def test_example_copies_match_reference(level):
    verts, faces = shapes.random_shape(3, level=level)
    jverts, jfaces = jax_shapes.random_shape(3, level=level)
    np.testing.assert_array_equal(verts, jverts)
    assert shapes.shape_family(3) == jax_shapes.shape_family(3)
    got = pipeline.make_example(verts, faces, 300, 300,
                                np.random.default_rng(7), occ_grid_res=16)
    ref = jax_pipeline.make_example(jverts, jfaces, 300, 300,
                                    np.random.default_rng(7), occ_grid_res=16)
    _equal_trees(got, ref)
    assert (got["sdf"] > 0).any() and (got["sdf"] < 0).any()


def test_dataset_batches_and_split_match_reference(tmp_path):
    kw = dict(n_shapes=5, n_surface=64, n_sdf=64, seed=2, level=1,
              num_workers=1, occ_grid_res=16)
    paths = pipeline.build_dataset(str(tmp_path / "port"), **kw)
    jpaths = jax_pipeline.build_dataset(str(tmp_path / "jax"), **kw)
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in jpaths]
    ds, jds = pipeline.ShapeDataset(paths), jax_pipeline.ShapeDataset(jpaths)
    got = list(pipeline.batch_iterator(ds, 2, rng=np.random.default_rng(0)))
    ref = list(jax_pipeline.batch_iterator(jds, 2,
                                           rng=np.random.default_rng(0)))
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        _equal_trees(a, b)
    for batch_size in (2, 1):
        split = cli._split(ds, batch_size)
        jsplit = jax_cli._split(jds, batch_size)
        for s, js in zip(split, jsplit):
            assert [os.path.basename(p) for p in s.paths] == \
                [os.path.basename(p) for p in js.paths]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A tiny engine after two epochs of Engine.fit on the CPU."""
    root = tmp_path_factory.mktemp("engine")
    _, cfg = tp.configs(**TINY, logdir=str(root / "exp"), timing=True)
    paths = pipeline.build_dataset(str(root / "data"), n_shapes=6,
                                   n_surface=256, n_sdf=256, seed=1, level=1,
                                   num_workers=1, occ_grid_res=16)
    train_set, val_set = cli._split(pipeline.ShapeDataset(paths),
                                    cfg.batch_size)
    engine = Engine(cfg, device="cpu")
    history = engine.fit(
        lambda: pipeline.batch_iterator(train_set, cfg.batch_size,
                                        rng=np.random.default_rng(
                                            cfg.seed + engine.epoch)),
        lambda: pipeline.batch_iterator(val_set, cfg.batch_size))
    return cfg, engine, history, train_set


def test_fit_validates_selects_and_logs(fitted):
    _, engine, history, _ = fitted
    assert [h["epoch"] for h in history] == [1, 2]
    for h in history:
        assert h["val"] and h["val_inference"]
        assert all(np.isfinite(v) for v in h["val_inference"].values())
    assert engine.best_iou > 0
    assert engine.best_iou == max(h["val_inference"]["val_iou_max"]
                                  for h in history)
    lines = Path(engine.experiment.file_path("metrics.jsonl")).read_text()
    kinds = [json.loads(ln)["kind"] for ln in lines.splitlines()]
    assert {"train", "val", "val_inference"} <= set(kinds)
    state = engine.experiment.read_state()
    assert state["epoch"] == 2 and state["best_iou"] == engine.best_iou
    assert os.path.exists(engine.experiment.file_path("ckpt/best.pt"))
    timing = json.loads(Path(engine.experiment.file_path("timing.json"))
                        .read_text())
    assert timing["train_step"]["count"] == engine.global_step


def test_restore_continues_bit_identically(fitted):
    cfg, engine, _, train_set = fitted
    batch = next(pipeline.batch_iterator(train_set, cfg.batch_size))
    engine.save()
    terms = engine.train_step(engine._prep_batch(batch))
    after = [p.detach().clone() for p in engine.model.parameters()]
    stats = [b.clone() for b in engine.model.buffers()]

    fresh = Engine(cfg, device="cpu", experiment=engine.experiment)
    fresh.restore("last")
    assert fresh.global_step == engine.global_step - 1
    terms2 = fresh.train_step(fresh._prep_batch(batch))
    for k in terms:
        assert torch.equal(terms[k], terms2[k]), k
    for a, b in zip(after, fresh.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(stats, fresh.model.buffers()):
        assert torch.equal(a, b)
    for a, b in zip(engine.optimizer.nu, fresh.optimizer.nu):
        assert torch.equal(a, b)
    assert fresh.optimizer.count == engine.optimizer.count


def test_pretrain_warm_start(fitted):
    cfg, engine, _, _ = fitted
    best = torch.load(engine.experiment.file_path("ckpt/best.pt"),
                      weights_only=True)
    _, cfg2 = tp.configs(**TINY, pretrain=engine.experiment.path,
                         logdir=cfg.logdir)
    warm = Engine(cfg2, device="cpu")
    for k, v in warm.model.state_dict().items():
        assert torch.equal(v, best["model"][k]), k
    assert warm.optimizer.count == 0
    assert all(not bool(m.any()) for m in warm.optimizer.mu)


def _run_cli(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-m", "deftet_tpu_torch.cli",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_train_then_eval_on_cpu(tmp_path):
    small = ["--res", "4", "--batch_size", "2", "--n_point", "128",
             "--num_sample_points", "256", "--occ_sample", "128",
             "--per_face_samples", "4", "--encoder_blocks", "8,1,8;16,1,4",
             "--gcn_hidden", "16,8", "--pos_mlp_hidden", "8",
             "--occ_mlp_hidden", "16,8", "--epochs", "2", "--n_shapes", "6",
             "--lr_decay_steps", "4", "--grad_accum", "2", "--remat"]
    out = _run_cli(["train", "--device", "cpu", *small, "--dataset_root",
                    str(tmp_path / "data"), "--logdir", str(tmp_path / "exp")],
                   tmp_path)
    assert out.returncode == 0, out.stderr
    assert "best occupancy IoU" in out.stdout
    (exp,) = (tmp_path / "exp").iterdir()
    out = _run_cli(["eval", "--device", "cpu", "--experiment_path", str(exp),
                    "--eval_points", "2000"], tmp_path)
    assert out.returncode == 0, out.stderr
    report = json.loads((exp / "result_update.json").read_text())
    for key in ("occ_iou", "val_iou_max", "f_score", "f_score_extend",
                "chamfer", "chamfer_l1", "hausdorff", "hausdorff_max",
                "n_boundary", "boundary_overflow"):
        assert np.isfinite(report["metrics"][key]), key
    assert report["val_losses"] and report["device"] == "cpu"
    assert "chamfer:" in (exp / "result_update.txt").read_text()
    assert sorted(p.name for p in (exp / "ckpt").iterdir()) == ["best.pt",
                                                                 "last.pt"]


def test_cli_refuses_cuda_without_a_card_and_unported_flags(tmp_path,
                                                             capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_cli(["train", "--res", "4", "--logdir", str(tmp_path)],
                   tmp_path)
    assert out.returncode != 0 and "CUDA" in out.stderr
    for argv in (["train", "--device", "cpu", "--mesh_dir", "meshes"],
                 ["train", "--device", "cpu", "--use_disn"],
                 ["render"]):
        with pytest.raises(SystemExit) as exit_info:
            sys.exit(cli.main(argv))
        assert exit_info.value.code != 0
        err = capsys.readouterr().err
        assert ("CUDA" in err) if argv == ["render"] else ("not ported" in err)
    assert not list(tmp_path.iterdir())  # refused before writing anything
