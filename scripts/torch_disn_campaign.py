"""DISN image-branch training campaign on the PyTorch port: train to a
measured result (the port of scripts/disn_campaign.py).

Trains ``--use_disn`` (VGG-16 image encoders and SDF decoders in place of
the point encoders) on the procedural dataset rendered with images, then
evaluates the best checkpoint at the 100,000-point protocol.  It calls
``python -m deftet_tpu_torch.cli train`` and then ``eval`` with the JAX
script's flags and defaults, on ``--device`` (default ``cuda``), and
writes the evaluation's output to ``<outdir>/eval_stdout.txt``; the
metrics land in the experiment's ``result_update.json``.

Everything the run writes (the dataset cache, the experiments, the
evaluation's output) goes under ``--outdir``, by default
``build/campaigns/disn`` inside this checkout (git-ignored), so two
checkouts never share a dataset or an experiment directory.

Usage:
  python scripts/torch_disn_campaign.py --res 50 --epochs 80
  python scripts/torch_disn_campaign.py --device cpu --res 8 --epochs 2 \\
      --n_shapes 8 --disn_width 0.125 --eval_points 2000   # a CPU smoke
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGNS = os.path.join(REPO, "build", "campaigns")


def cli_env() -> dict:
    """The environment for ``python -m deftet_tpu_torch.cli``: this
    checkout first on the module path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def experiment_dirs(logdir: str) -> set:
    """The experiment directories under ``logdir`` (none if it is not
    there yet)."""
    if not os.path.isdir(logdir):
        return set()
    return {p for e in os.listdir(logdir)
            if os.path.isdir(p := os.path.join(logdir, e))}


def train_then_eval(train_args, logdir: str, outdir: str, eval_points: int,
                    device: str, t0: float) -> int:
    """``cli train`` with ``train_args``, then ``cli eval`` of the
    experiment it made; the eval's stdout goes to ``<outdir>/eval_stdout.txt``."""
    env = cli_env()
    # a reused --outdir holds older runs: evaluate the one this call makes
    before = experiment_dirs(logdir)
    train_cmd = [sys.executable, "-m", "deftet_tpu_torch.cli", "train",
                 "--device", device, *train_args]
    print("+", " ".join(train_cmd), flush=True)
    rc = subprocess.call(train_cmd, env=env)
    if rc != 0:
        return rc
    made = experiment_dirs(logdir) - before
    if len(made) != 1:
        print(f"expected one new experiment under {logdir}, found "
              f"{sorted(made)}", file=sys.stderr)
        return 1
    (exp,) = made
    eval_cmd = [sys.executable, "-m", "deftet_tpu_torch.cli", "eval",
                "--device", device, "--experiment_path", exp,
                "--eval_points", str(eval_points)]
    print("+", " ".join(eval_cmd), flush=True)
    out = subprocess.run(eval_cmd, capture_output=True, text=True, env=env)
    print(out.stdout[-4000:])
    if out.returncode != 0:
        print(out.stderr[-2000:], file=sys.stderr)
        return out.returncode
    with open(os.path.join(outdir, "eval_stdout.txt"), "w") as f:
        f.write(out.stdout)
    print(f"[{time.time() - t0:.0f}s] done; experiment: {exp}", flush=True)
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default=os.path.join(CAMPAIGNS, "disn"),
                    help="where the run writes (default: build/campaigns/"
                    "disn in this checkout)")
    ap.add_argument("--data_root", default=None,
                    help="dataset cache (default: <outdir>/data)")
    ap.add_argument("--res", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--n_shapes", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval_points", type=int, default=100_000)
    ap.add_argument("--disn_width", type=float, default=0.5,
                    help="VGG width multiplier (1.0 = full VGG-16-D)")
    ap.add_argument("--disn_encoding_dim", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device of both calls (cpu runs the "
                    "kernels' plain versions)")
    ap.add_argument("--extra", default="",
                    help="extra train CLI flags, space separated")
    args = ap.parse_args(argv)
    if args.data_root is None:
        args.data_root = os.path.join(args.outdir, "data")
    return args


def main() -> int:
    args = parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    logdir = os.path.join(args.outdir, "exp")
    train_args = [
        "--use_disn",
        "--disn_width", str(args.disn_width),
        "--disn_encoding_dim", str(args.disn_encoding_dim),
        "--res", str(args.res), "--batch_size", str(args.batch_size),
        "--epochs", str(args.epochs), "--n_shapes", str(args.n_shapes),
        "--dataset_root", args.data_root,
        "--logdir", logdir, "--seed", str(args.seed),
    ] + args.extra.split()
    return train_then_eval(train_args, logdir, args.outdir, args.eval_points,
                           args.device, time.time())


if __name__ == "__main__":
    sys.exit(main())
