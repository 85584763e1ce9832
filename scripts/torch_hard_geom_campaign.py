"""Hard-geometry training campaign on the PyTorch port: real ingested
meshes, not blobs (the port of scripts/hard_geom_campaign.py).

Trains on the repository's bundled hard meshes (gear teeth, trefoil knot,
twisted box: tests/assets/meshes) expanded by rigid augmentations (random
rotations and anisotropic scales), one category directory per source
mesh, then evaluates the best checkpoint at the 100,000-point protocol on
the held-out augmentations.  For a seed it writes the same OBJ files as
the JAX script.  The train and eval calls go through
``python -m deftet_tpu_torch.cli`` on ``--device`` (default ``cuda``).

The meshes, the dataset cache and the experiments go under ``--outdir``,
by default ``build/campaigns/hard_geom`` inside this checkout
(git-ignored).

Usage:
  python scripts/torch_hard_geom_campaign.py --res 50 --epochs 500
  python scripts/torch_hard_geom_campaign.py --device cpu --res 8 \\
      --epochs 2 --n_aug 1 --eval_points 2000 \\
      --extra "--watertight_res 32"   # a CPU smoke
"""

import argparse
import os
import sys
import time

import numpy as np

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(SCRIPTS)
sys.path.insert(0, REPO)
sys.path.insert(0, SCRIPTS)

from torch_disn_campaign import CAMPAIGNS, train_then_eval  # noqa: E402


def random_rotation(rng) -> np.ndarray:
    """A uniform random rotation from a normalized Gaussian quaternion."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def make_augmented_meshes(out_dir: str, n_aug: int, seed: int) -> int:
    """Write n_aug rigid+scale augmentations of each bundled mesh, one
    category dir per source mesh (the ShapeNet class-dir convention the
    ingestion pipeline expects).  Returns the number of files written."""
    from deftet_tpu_torch.data.shapes import normalize_mesh
    from deftet_tpu_torch.utils.objio import load_obj, save_obj

    src_dir = os.path.join(REPO, "tests", "assets", "meshes")
    rng = np.random.default_rng(seed)
    n = 0
    for fname in sorted(os.listdir(src_dir)):
        if not fname.endswith(".obj"):
            continue
        verts, faces = load_obj(os.path.join(src_dir, fname))
        cat = os.path.splitext(fname)[0]
        cat_dir = os.path.join(out_dir, cat)
        os.makedirs(cat_dir, exist_ok=True)
        for a in range(n_aug):
            r = random_rotation(rng)
            scale = rng.uniform(0.7, 1.0, size=3)
            v = normalize_mesh((verts @ r.T) * scale)
            save_obj(os.path.join(cat_dir, f"{cat}_{a:02d}.obj"), v, faces)
            n += 1
    return n


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default=os.path.join(CAMPAIGNS, "hard_geom"),
                    help="where the run writes (default: build/campaigns/"
                    "hard_geom in this checkout)")
    ap.add_argument("--res", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n_aug", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval_points", type=int, default=100_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of both calls (cpu runs the "
                    "kernels' plain versions)")
    ap.add_argument("--extra", default="",
                    help="extra train CLI flags, space separated")
    return ap.parse_args(argv)


def main() -> int:
    args = parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    mesh_dir = os.path.join(args.outdir, "meshes")
    data_root = os.path.join(args.outdir, "data")
    logdir = os.path.join(args.outdir, "exp")

    t0 = time.time()
    n = make_augmented_meshes(mesh_dir, args.n_aug, args.seed)
    print(f"[{time.time() - t0:.0f}s] wrote {n} augmented meshes", flush=True)
    train_args = [
        "--res", str(args.res), "--batch_size", str(args.batch_size),
        "--epochs", str(args.epochs),
        "--mesh_dir", mesh_dir, "--dataset_root", data_root,
        "--logdir", logdir, "--seed", str(args.seed),
    ] + args.extra.split()
    return train_then_eval(train_args, logdir, args.outdir, args.eval_points,
                           args.device, t0)


if __name__ == "__main__":
    sys.exit(main())
