"""Command-line entry points (torch port of deftet_tpu/cli.py's ``train``
and ``eval``):

    python -m deftet_tpu_torch.cli train [--device cuda|cpu] [config flags]
    python -m deftet_tpu_torch.cli eval --experiment_path DIR [--device ...]

``train`` builds (or reuses) the procedural dataset, creates an
experiment, and runs the fit loop with best-IoU checkpoints.  ``eval``
restores an experiment's checkpoint and writes the validation losses and
the inference metrics to ``result_update*.json`` and
``result_update.txt``.  ``--device`` defaults to ``cuda`` and never falls
back to the CPU.  Not ported: ``preprocess``, ``render``, ``--mesh_dir``
and ``--use_disn``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from .config import Experiment, TrainConfig, add_config_args, config_from_args
from .data import ShapeDataset, batch_iterator, build_dataset
from .train import Engine


def _add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")


def _device(parser: argparse.ArgumentParser, name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {name} needs a CUDA device and none is "
                     "available; pass --device cpu to run on the CPU")
    return device


def _refuse_unported(parser: argparse.ArgumentParser,
                     config: TrainConfig) -> None:
    if config.mesh_dir:
        parser.error("--mesh_dir (mesh-directory ingestion) is not ported")
    if config.use_disn:
        parser.error("--use_disn (the DISN image branch) is not ported")


def _split(dataset: ShapeDataset, batch_size: int):
    """Train/val split; the val split is always at least one full batch.

    Val shapes are taken at a uniform stride through the sorted paths, so
    every category is held out; with fewer than two batches of shapes the
    val split reuses training shapes."""
    n = len(dataset)
    n_val = max(batch_size, n // 8)
    stride = max(1, n // n_val)
    val_idx = list(range(0, n, stride))[:n_val]
    # top up if the stride undershot (n not divisible)
    rest = [i for i in range(n) if i not in set(val_idx)]
    val_idx += rest[: n_val - len(val_idx)]
    val_set = set(val_idx)
    val_paths = [dataset.paths[i] for i in sorted(val_set)]
    if n >= n_val + batch_size:
        train_paths = [p for i, p in enumerate(dataset.paths)
                       if i not in val_set]
    else:
        train_paths = dataset.paths
    return ShapeDataset(train_paths), ShapeDataset(val_paths)


def _dataset(config: TrainConfig) -> ShapeDataset:
    paths = build_dataset(
        config.dataset_root,
        n_shapes=config.n_shapes,
        n_surface=max(config.num_sample_points, config.n_point),
        n_sdf=config.num_sample_points,
        seed=config.seed,
        occ_grid_res=config.resolved_occ_grid_res(),
    )
    return ShapeDataset(paths)


def train_main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="deftet_tpu_torch.cli train")
    add_config_args(parser)
    _add_device_arg(parser)
    args = parser.parse_args(argv)
    config = config_from_args(args)
    _refuse_unported(parser, config)
    device = _device(parser, args.device)

    dataset = _dataset(config)
    train_set, val_set = _split(dataset, config.batch_size)
    engine = Engine(config, device=device)
    # the split manifest, so that eval runs on the same held-out shapes;
    # `disjoint` is false where small datasets reuse training shapes
    with open(engine.experiment.file_path("split.json"), "w") as f:
        json.dump({
            "train": [os.path.abspath(p) for p in train_set.paths],
            "val": [os.path.abspath(p) for p in val_set.paths],
            "disjoint": not (set(train_set.paths) & set(val_set.paths)),
        }, f, indent=2)
    print(f"experiment: {engine.experiment.path}", flush=True)
    history = engine.fit(
        lambda: batch_iterator(
            train_set, config.batch_size,
            rng=np.random.default_rng(config.seed + engine.epoch)),
        lambda: batch_iterator(val_set, config.batch_size),
    )
    for rec in history:
        print(json.dumps(rec), flush=True)
    print(f"best occupancy IoU: {engine.best_iou:.4f}")
    return 0


def _write_reports(experiment: Experiment, report: dict, suffix: str) -> None:
    with open(experiment.file_path(f"result_update{suffix}.json"), "w") as f:
        json.dump(report, f, indent=2)
    # per-category ampersand-separated rows (metric x 100, then the mean)
    metrics, per_category = report["metrics"], report["per_category"]
    cats = sorted(per_category) or ["all"]
    with open(experiment.file_path("result_update.txt"), "a") as f:
        f.write("cats: " + " ".join(cats) + "\n")
        for k in sorted(metrics):
            f.write(k + ": ")
            vals = [per_category.get(c, metrics).get(k, metrics.get(k, 0.0))
                    for c in cats]
            for v in vals:
                f.write(f"{100 * v:2.2f} &")
            f.write(f"{100 * sum(vals) / len(vals):2.3f} &\n")


def eval_main(argv=None) -> int:
    """Full inference evaluation: surface extraction and the metrics
    (occupancy IoU, the IoU sweep and its maximum, F-score and its
    extended form, Chamfer, Chamfer-L1, Hausdorff mean and max) plus the
    validation losses."""
    from .evals.harness import save_predicted_surface_objs

    parser = argparse.ArgumentParser(prog="deftet_tpu_torch.cli eval")
    parser.add_argument("--experiment_path", required=True)
    parser.add_argument("--checkpoint", default="best",
                        choices=["best", "last"])
    parser.add_argument("--save_vis", action="store_true",
                        help="dump predicted-surface OBJs for one batch")
    parser.add_argument("--res", type=int, default=0,
                        help="tet-grid resolution for inference (0 = as "
                        "trained; the networks are grid-agnostic)")
    parser.add_argument("--eval_points", type=int, default=100_000,
                        help="surface samples per side for F-score, "
                        "Chamfer and Hausdorff")
    parser.add_argument("--batch_size", type=int, default=0,
                        help="eval batch size (0 = as trained)")
    _add_device_arg(parser)
    args = parser.parse_args(argv)
    device = _device(parser, args.device)

    experiment = Experiment.load(args.experiment_path)
    config = dataclasses.replace(experiment.config,
                                 eval_points=args.eval_points)
    if args.res:
        config = dataclasses.replace(config, res=args.res)
    if args.batch_size:
        config = dataclasses.replace(config, batch_size=args.batch_size)
    _refuse_unported(parser, config)
    engine = Engine(config, device=device, experiment=experiment)
    engine.restore(args.checkpoint)

    # the persisted split manifest when all its shapes exist, else the
    # split re-derived from the config
    split_file = os.path.join(args.experiment_path, "split.json")
    val_set = None
    if os.path.exists(split_file):
        with open(split_file) as f:
            manifest = json.load(f)
        val_paths = [p for p in manifest.get("val", []) if os.path.exists(p)]
        if val_paths and len(val_paths) == len(manifest.get("val", [])):
            val_set = ShapeDataset(val_paths)
    if val_set is None:
        _, val_set = _split(_dataset(config), config.batch_size)
    means = engine.validate(batch_iterator(val_set, config.batch_size))

    infer = engine.inference_step()
    sums, n = {}, 0
    per_cat: dict = {}
    vis_done = False
    for batch in batch_iterator(val_set, config.batch_size):
        prepped = engine._prep_batch(batch)
        # the same draws for every batch and every run
        gen = torch.Generator(device=device).manual_seed(config.seed)
        out = {k: float(v) for k, v in
               infer(prepped, engine.statics, gen).items()}
        for k, v in out.items():
            sums[k] = sums.get(k, 0.0) + v
        n += 1
        # batches are metric-averaged: attribute each to its majority
        # category
        cats = batch.get("category")
        if cats:
            cat = max(set(cats), key=cats.count)
            bucket = per_cat.setdefault(cat, {"n": 0})
            bucket["n"] += 1
            for k, v in out.items():
                bucket[k] = bucket.get(k, 0.0) + v
        if args.save_vis and not vis_done:
            save_predicted_surface_objs(
                engine.model, prepped, engine.statics, config,
                experiment.file_path("vis_surface"), **engine._lattice())
            vis_done = True
    metrics = {k: v / max(n, 1) for k, v in sums.items()}
    per_category = {cat: {k: v / b["n"] for k, v in b.items() if k != "n"}
                    for cat, b in per_cat.items()}
    report = {"checkpoint": args.checkpoint, "res": config.res,
              "device": str(device), "val_losses": means,
              "metrics": metrics, "per_category": per_category}
    # an override writes a suffixed report, so that the as-trained
    # result_update.json is never overwritten by a diagnostic run
    suffix = f"_res{config.res}" if args.res else ""
    if args.batch_size:
        suffix += f"_b{args.batch_size}"
    _write_reports(experiment, report, suffix)
    print(json.dumps(report, indent=2))
    return 0


COMMANDS = {"train": train_main, "eval": eval_main}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    cmd = argv[0] if argv else "train"
    if cmd not in COMMANDS:
        print(f"deftet_tpu_torch.cli: unknown or unported command {cmd!r} "
              f"(ported: {', '.join(COMMANDS)})", file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
