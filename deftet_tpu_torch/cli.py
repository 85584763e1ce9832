"""Command-line entry points (torch port of deftet_tpu/cli.py):

    python -m deftet_tpu_torch.cli train [--device cuda|cpu] [config flags]
    python -m deftet_tpu_torch.cli eval --experiment_path DIR [--device ...]
    python -m deftet_tpu_torch.cli preprocess --mesh_dir DIR --dataset_root DIR
    python -m deftet_tpu_torch.cli render --synthetic|--datadir DIR [...]

``train`` builds (or reuses) the procedural dataset, or with
``--mesh_dir`` the shards of a directory of OBJ meshes (with images when
``--use_disn``), creates an experiment, and runs the fit loop with
best-IoU checkpoints.  ``eval`` restores an experiment's checkpoint and
writes the validation losses and the inference metrics to
``result_update*.json`` and ``result_update.txt``.  ``preprocess``
ingests a mesh directory into shards on the host (numpy only, no device).
``render`` runs the 2D-supervision optimizer on a NeRF-synthetic scene or
a procedural one and writes ``records.json``, ``surface.obj`` and a
turntable video.  ``--device`` defaults to ``cuda`` and never falls back
to the CPU.
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
from .data import (
    ShapeDataset,
    batch_iterator,
    build_dataset,
    build_dataset_from_meshes,
)
from .train import Engine
from .train.engine import check_supported


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


def _refuse_unsupported(parser: argparse.ArgumentParser,
                        config: TrainConfig) -> None:
    """Refuse what the port does not run before anything is written."""
    try:
        check_supported(config)
    except NotImplementedError as e:
        parser.error(str(e))


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
    common = dict(n_surface=max(config.num_sample_points, config.n_point),
                  n_sdf=config.num_sample_points, seed=config.seed,
                  occ_grid_res=config.resolved_occ_grid_res(),
                  with_images=config.use_disn)
    if config.mesh_dir:
        paths = build_dataset_from_meshes(
            config.dataset_root, config.mesh_dir,
            watertight_res=config.watertight_res, **common)
    else:
        paths = build_dataset(config.dataset_root,
                              n_shapes=config.n_shapes, **common)
    return ShapeDataset(paths)


def train_main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="deftet_tpu_torch.cli train")
    add_config_args(parser)
    _add_device_arg(parser)
    args = parser.parse_args(argv)
    config = config_from_args(args)
    _refuse_unsupported(parser, config)
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
    _refuse_unsupported(parser, config)
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


def preprocess_main(argv=None) -> int:
    """Offline mesh-directory ingestion: each OBJ under --mesh_dir
    watertighted, surface- and SDF-sampled, its occupancy texture (and
    with --with_images a DISN image and camera) written to an npz shard
    under --dataset_root.  Host-only; touches no device."""
    parser = argparse.ArgumentParser(prog="deftet_tpu_torch.cli preprocess")
    parser.add_argument("--mesh_dir", required=True)
    parser.add_argument("--dataset_root", required=True)
    parser.add_argument("--n_surface", type=int, default=20000)
    parser.add_argument("--n_sdf", type=int, default=20000)
    parser.add_argument("--watertight_res", type=int, default=100)
    parser.add_argument("--occ_grid_res", type=int, default=64)
    parser.add_argument("--with_images", action="store_true",
                        help="also render DISN images and camera matrices")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=8)
    args = parser.parse_args(argv)
    paths = build_dataset_from_meshes(
        args.dataset_root, args.mesh_dir, n_surface=args.n_surface,
        n_sdf=args.n_sdf, seed=args.seed,
        watertight_res=args.watertight_res, num_workers=args.num_workers,
        occ_grid_res=args.occ_grid_res, with_images=args.with_images)
    print(json.dumps({"n_shards": len(paths), "paths": paths}, indent=2))
    return 0


def render_main(argv=None) -> int:
    """2D-supervision optimization (the reference's diff_render app):
    per sublevel a {mov, fix} stage pair, then subdivision; data from a
    NeRF-synthetic scene directory (--datadir) or the procedural scene
    (--synthetic).  Flag names follow the reference's expconfig.py."""
    from .render.optimize import (
        DEFAULT_WEIGHTS,
        RenderOptConfig,
        evaluate_psnr,
        export_turntable,
        load_blender,
        make_synthetic_scene,
        run_pipeline,
    )

    parser = argparse.ArgumentParser(prog="deftet_tpu_torch.cli render")
    parser.add_argument("--expname", default="scene")
    parser.add_argument("--savedir", default="./render_out")
    parser.add_argument("--datadir", default=None,
                        help="NeRF-synthetic scene dir (transforms_*.json)")
    parser.add_argument("--synthetic", action="store_true",
                        help="use the procedural GT scene instead of data")
    parser.add_argument("--n_views", type=int, default=16)
    parser.add_argument("--image_size", type=int, default=100)
    hr = parser.add_mutually_exclusive_group()
    hr.add_argument("--half_res", dest="half_res", action="store_true",
                    default=True)
    hr.add_argument("--no_half_res", dest="half_res", action="store_false")
    parser.add_argument("--tetres", type=int, default=40)
    parser.add_argument("--tet_file", default=None,
                        help="quartet-format .tet grid file (overrides "
                        "--tetres)")
    parser.add_argument("--tetcoef", type=float, default=2.5)
    parser.add_argument("--sublevel", type=int, default=2)
    parser.add_argument("--deletenum", type=int, default=1000)
    parser.add_argument("--deletethres", type=float, default=1e-3)
    parser.add_argument("--optfixnum", type=int, default=3000)
    parser.add_argument("--optmovnum", type=int, default=2000)
    parser.add_argument("--lrfix", type=float, default=5e-2)
    parser.add_argument("--lrmov", type=float, default=5e-4)
    parser.add_argument("--pixelsampling", type=float, default=0.04)
    parser.add_argument("--peel_k", type=int, default=300)
    parser.add_argument("--tet_budget", type=int, default=1_000_000,
                        help="post-subdivision tet budget; 0 = unlimited "
                        "(split every alive tet)")
    parser.add_argument("--seed", type=int, default=0)
    for name, default in (
        ("weights_im_loss", 1.0), ("weights_mask_loss", 2.0),
        ("weights_mask_reg", 1e-2), ("weights_occ_lap", 0.0),
        ("weights_color_reg", 0.0), ("weights_point_mov", 1e-2),
        ("weights_tetvariance", 0.0),
    ):
        parser.add_argument(f"--{name}", type=float, default=default)
    _add_device_arg(parser)
    args = parser.parse_args(argv)
    device = _device(parser, args.device)

    if args.datadir:
        images, poses, hwf, i_split = load_blender(args.datadir,
                                                   half_res=args.half_res)
    else:
        images, poses, hwf, i_split = make_synthetic_scene(
            n_views=args.n_views, height=args.image_size,
            width=args.image_size, seed=args.seed, coef=args.tetcoef,
            device=device)
    lap = (args.weights_color_reg,) * 3 + (args.weights_occ_lap,)
    weights = dict(DEFAULT_WEIGHTS)
    weights.update(
        weights_im_loss=args.weights_im_loss,
        weights_mask_loss=args.weights_mask_loss,
        weights_mask_reg=args.weights_mask_reg,
        weights_point_mov=args.weights_point_mov,
        weights_tetvariance=args.weights_tetvariance,
        weights_vector=lap,
        weights_vector_with_gridmov=lap + (args.weights_point_mov,) * 3,
    )
    cfg = RenderOptConfig(
        tet_res=args.tetres, tet_file=args.tet_file, coef=args.tetcoef,
        sublevels=args.sublevel, steps_fix=args.optfixnum,
        steps_mov=args.optmovnum, pixel_sampling=args.pixelsampling,
        lr_feat=args.lrfix, lr_mov=args.lrmov, delete_every=args.deletenum,
        delete_threshold=args.deletethres, k=args.peel_k,
        tet_budget=args.tet_budget, seed=args.seed,
    )
    outdir = os.path.join(args.savedir, args.expname)
    os.makedirs(outdir, exist_ok=True)
    scene, params, records = run_pipeline(images, poses, hwf, i_split, cfg,
                                          weights=weights, device=device)
    mse, psnr = evaluate_psnr(scene, params, images, poses, hwf, i_split[2],
                              cfg)
    with open(os.path.join(outdir, "records.json"), "w") as f:
        json.dump({"stages": records, "final_mse": mse,
                   "final_psnr": psnr}, f, indent=2)
    scene.save_surface_obj(params, os.path.join(outdir, "surface.obj"))
    export_turntable(scene, params, hwf, cfg, os.path.join(
        outdir, f"rgb-mse{mse:.3f}-psnr{psnr:.3f}.gif"))
    print(json.dumps({"mse": mse, "psnr": psnr, "outdir": outdir}))
    return 0


COMMANDS = {"train": train_main, "eval": eval_main,
            "preprocess": preprocess_main, "render": render_main}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    cmd = argv[0] if argv else "train"
    if cmd not in COMMANDS:
        print(f"deftet_tpu_torch.cli: unknown command {cmd!r} "
              f"(commands: {', '.join(COMMANDS)})", file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
