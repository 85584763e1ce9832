"""A reduced training campaign through both packages on the CPU, from the
same initial weights: the way to tell whether a campaign of the port that
lands outside its margin differs from the JAX package's by more than the
spread between seeds.

``init`` draws the JAX engine's initial flax variables (seed 0) and builds
the dataset (the port's pipeline, seed 0); ``run`` trains one package from
those weights (the port's through ``convert.load_flax_variables``) on the
same batches in the same order, its step draws seeded by ``--seed``;
``compare`` reads the runs' ``metrics.jsonl`` and prints, per logged
series, the mean distance between two runs' curves for each pair, so that
JAX-against-port reads beside port-against-port and JAX-against-JAX
(different step draws).

    python tests/torch_compare_campaign.py init --out DIR [--disn] [sizes]
    python tests/torch_compare_campaign.py run --out DIR --package torch \\
        --seed 0 [--disn] [sizes]
    python tests/torch_compare_campaign.py compare --out DIR

It imports both packages, as the parity tests do.  At its default sizes
a run takes minutes of CPU; ``--tiny`` swaps in the tests' tiny network,
at which ``tests/test_torch_compare_campaign.py`` runs all four commands.
"""

import argparse
import itertools
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the tiny network of the CLI tests (tests/test_torch_engine.py)
TINY = dict(occ_sample=128, per_face_samples=4, encoder_blocks="8,1,8;16,1,4",
            gcn_hidden="16,8", pos_mlp_hidden="8", occ_mlp_hidden="16,8")

SERIES = {"train": ("total", "occ", "occ_iou", "surf_chamfer"),
          "val": ("total", "occ", "occ_iou"),
          "val_inference": ("val_iou_max", "chamfer", "f_score")}


def config_kwargs(args, seed):
    kw = dict(res=args.res, batch_size=args.batch_size,
              n_point=args.n_point, num_sample_points=args.n_point,
              n_shapes=args.n_shapes, epochs=args.epochs,
              val_every=args.val_every, seed=seed,
              dataset_root=str(Path(args.out) / "data"),
              logdir=str(Path(args.out) / "runs"))
    if args.tiny:
        kw.update(TINY)
    if args.disn:
        kw.update(use_disn=True, disn_width=args.disn_width,
                  disn_encoding_dim=args.disn_encoding_dim)
    return kw


def datasets(args):
    from deftet_tpu_torch.cli import _dataset, _split
    from deftet_tpu_torch.config import TrainConfig

    cfg = TrainConfig(**config_kwargs(args, 0))
    return _split(_dataset(cfg), cfg.batch_size)


def jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def init(args) -> None:
    jax = jax_cpu()
    from deftet_tpu.config import TrainConfig as JaxConfig
    from deftet_tpu.train.engine import Engine as JaxEngine

    datasets(args)
    engine = JaxEngine(JaxConfig(**config_kwargs(args, 0)))
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": engine.state.params,
        "batch_stats": engine.state.batch_stats})
    np.save(Path(args.out) / "init.npy", variables, allow_pickle=True)


def engine_for(args):
    """The package's engine for ``run``, its weights the ``init`` ones."""
    variables = np.load(Path(args.out) / "init.npy", allow_pickle=True).item()
    kw = config_kwargs(args, args.seed)
    kw["experiment_id"] = f"{args.package}_s{args.seed}"
    if args.package == "jax":
        jax = jax_cpu()
        from deftet_tpu.config import TrainConfig as JaxConfig
        from deftet_tpu.parallel import replicate
        from deftet_tpu.train.engine import Engine
        from deftet_tpu.train.step import TrainState

        engine = Engine(JaxConfig(**kw))
        st = engine.state
        tree = jax.tree_util.tree_map(jax.numpy.asarray, variables)
        engine.state = TrainState(*replicate(
            (tree["params"], tree["batch_stats"], st.opt_state, st.step),
            engine.mesh))
    else:
        from deftet_tpu_torch.config import TrainConfig
        from deftet_tpu_torch.convert import load_flax_variables
        from deftet_tpu_torch.train import Engine

        engine = Engine(TrainConfig(**kw), device="cpu")
        load_flax_variables(engine.model, variables)
    return engine


def run(args) -> None:
    from deftet_tpu_torch.data import batch_iterator

    train_set, val_set = datasets(args)
    engine = engine_for(args)
    # the same batches in the same order for every run
    engine.fit(lambda: batch_iterator(
        train_set, args.batch_size,
        rng=np.random.default_rng(1000 + engine.epoch)),
        lambda: batch_iterator(val_set, args.batch_size))
    print(json.dumps({"run": engine.config.experiment_id,
                      "experiment": engine.experiment.path}))


def _curves(path: Path):
    out = {}
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        for name in SERIES.get(rec["kind"], ()):
            out.setdefault(f"{rec['kind']}.{name}", {})[rec["step"]] = \
                rec[name]
    return out


def compare(args) -> None:
    runs = {p.parent.name.split("_", 1)[-1]: _curves(p) for p in
            sorted((Path(args.out) / "runs").glob("*/metrics.jsonl"))}
    table = {}
    for a, b in itertools.combinations(sorted(runs), 2):
        row = {}
        for series in sorted(set(runs[a]) & set(runs[b])):
            steps = sorted(set(runs[a][series]) & set(runs[b][series]))
            x = np.array([runs[a][series][s] for s in steps])
            y = np.array([runs[b][series][s] for s in steps])
            row[series] = float(np.mean(np.abs(x - y)))
        table[f"{a} vs {b}"] = row
    last = {name: {series: c[max(c)] for series, c in curves.items()}
            for name, curves in runs.items()}
    print(json.dumps({"mean_abs_difference": table, "last": last},
                     indent=2))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=("init", "run", "compare"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--package", choices=("jax", "torch"), default="torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--disn", action="store_true")
    ap.add_argument("--disn_width", type=float, default=0.5)
    ap.add_argument("--disn_encoding_dim", type=int, default=512)
    ap.add_argument("--res", type=int, default=20)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--n_shapes", type=int, default=16)
    ap.add_argument("--n_point", type=int, default=5000,
                    help="surface points a shape and SDF samples")
    ap.add_argument("--epochs", type=int, default=67)
    ap.add_argument("--val_every", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help="the tests' tiny network instead of the default "
                    "widths")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    {"init": init, "run": run, "compare": compare}[args.command](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
