"""Where a trained experiment's Hausdorff max comes from: per validation
shape, the predicted surface's connected pieces and, at each point count,
the two one-sided maxima of the eval's Hausdorff with the piece that
holds the farthest point.

It restores the experiment's checkpoint as ``cli eval`` does and, batch by
batch, takes the eval's predicted surface (the boundary faces of the
thresholded occupancy) and its draws: both surfaces sampled from a
generator seeded with the config's seed, the predicted one first, the
stored GT samples where there are enough.  So at a point count the mean
of the per-shape ``hausdorff_max`` is what ``cli eval --eval_points``
that count reports: exactly on the CPU, and on the card where both
processes run with ``torch.use_deterministic_algorithms(True)``.
Without it the card's forward is not bitwise repeatable, a few tets
near the threshold flip and the area-weighted draws move: about 1 % of
the Hausdorff max on an H100, as between two ``cli eval`` runs.  The
surface is split into pieces joined by shared grid vertices, numbered
by face count (0 the largest), and each piece reports its farthest
corner from the GT mesh: a small piece far from the GT is a stray one.

Usage:
  python scripts/torch_surface_report.py EXPERIMENT_DIR \\
      [--checkpoint best] [--eval_points 5000 100000] [--out report.json]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MAX_PIECES = 8  # pieces listed a shape: the largest and the farthest


def face_pieces(faces_kx3: np.ndarray) -> np.ndarray:
    """(K,) piece of each face, the pieces joined by shared vertices and
    numbered by face count, largest first (ties by first face)."""
    if len(faces_kx3) == 0:
        return np.zeros(0, np.int64)
    _, inv = np.unique(faces_kx3, return_inverse=True)
    f = inv.reshape(-1, 3)
    label = np.arange(f.max() + 1)
    while True:
        # every vertex takes the least label among its faces' vertices,
        # then follows its label's label to the root
        new = label.copy()
        np.minimum.at(new, f.ravel(), np.repeat(label[f].min(axis=1), 3))
        while not np.array_equal(new[new], new):
            new = new[new]
        if np.array_equal(new, label):
            break
        label = new
    roots, first, counts = np.unique(label[f[:, 0]], return_index=True,
                                     return_counts=True)
    order = np.lexsort((first, -counts))
    rank = np.empty(len(roots), np.int64)
    rank[order] = np.arange(len(roots))
    return rank[np.searchsorted(roots, label[f[:, 0]])]


def _eval_draws(face_pos, mask, n, generator):
    """The eval's sampler draws (``sample_mesh_points``), returned so the
    face of every sample is known."""
    import torch

    from deftet_tpu_torch.evals.harness import _face_areas

    w = _face_areas(face_pos) * mask + 1e-20
    face_id = torch.multinomial(w, n, replacement=True, generator=generator)
    shape = (face_pos.shape[0], n, 1)
    u_raw = torch.rand(shape, generator=generator, device=face_pos.device)
    v = torch.rand(shape, generator=generator, device=face_pos.device)
    return face_id, u_raw, v


def batch_report(engine, batch, points):
    """Per shape of one prepared batch: its surface's pieces and, for each
    count in ``points``, the eval's one-sided maxima and their pieces."""
    import torch

    from deftet_tpu_torch.evals.harness import (
        extract_predicted_surface,
        sample_mesh_points,
    )
    from deftet_tpu_torch.evals.metrics import EPS
    from deftet_tpu_torch.ops.tri_distance import point_to_mesh_squared_distance

    config, dev = engine.config, engine.device
    pos, faces, mask = (torch.from_numpy(a).to(dev) for a in
                        extract_predicted_surface(
                            engine.model, batch, engine.statics, config))
    bsz = pos.shape[0]
    bidx = torch.arange(bsz, device=dev)[:, None, None]
    face_pos = pos[bidx, faces.long()]
    gt_faces = batch["faces"].long()
    gt_mask = (torch.arange(gt_faces.shape[1], device=dev)[None, :]
               < batch["n_faces"][:, None]).float()
    gt_tri = batch["verts"][bidx, gt_faces]

    shapes = []
    for i in range(bsz):
        keep = mask[i].cpu().numpy() > 0
        piece = np.full(len(keep), -1)
        piece[keep] = face_pieces(faces[i].cpu().numpy()[keep])
        n_pieces = int(piece.max()) + 1
        # every piece's farthest corner from the GT mesh
        corner = face_pos[i][torch.from_numpy(keep).to(dev)].reshape(1, -1, 3)
        d2, _ = point_to_mesh_squared_distance(corner, gt_tri[i:i + 1],
                                               gt_mask[i:i + 1])
        far = np.sqrt(d2.cpu().numpy().reshape(-1, 3).max(axis=1))
        kept_piece = piece[keep]
        sizes = np.bincount(kept_piece, minlength=n_pieces)
        reach = np.zeros(n_pieces)
        np.maximum.at(reach, kept_piece, far)
        listed = sorted(set(range(min(n_pieces, MAX_PIECES // 2)))
                        | set(np.argsort(-reach)[:MAX_PIECES // 2].tolist()))
        shapes.append({"faces": int(keep.sum()), "pieces": n_pieces,
                       "piece_faces": {int(p): int(sizes[p]) for p in listed},
                       "piece_far": {int(p): float(reach[p]) for p in listed},
                       "points": {}, "_piece": piece})

    for n in points:
        gen = torch.Generator(device=dev).manual_seed(config.seed)
        pred_draws = _eval_draws(face_pos, mask, n, gen)
        pred_pts = sample_mesh_points(face_pos, mask, n, draws=pred_draws)
        surface = batch["surface_points"]
        if n <= surface.shape[1]:
            gt_pts = surface[:, :n]
        else:
            gt_pts = sample_mesh_points(gt_tri, gt_mask, n, gen)
        # GT points to the predicted surface (the nearest face's piece),
        # predicted points to the GT mesh (the sampled face's piece)
        d2_a, near = point_to_mesh_squared_distance(gt_pts, face_pos, mask)
        d2_b, _ = point_to_mesh_squared_distance(pred_pts, gt_tri, gt_mask)
        da = torch.sqrt(d2_a + EPS).cpu().numpy()
        db = torch.sqrt(d2_b + EPS).cpu().numpy()
        near, face_id = near.cpu().numpy(), pred_draws[0].cpu().numpy()
        for i, shape in enumerate(shapes):
            a, b = int(da[i].argmax()), int(db[i].argmax())
            shape["points"][str(n)] = {
                "hausdorff_max": float((da[i, a] + db[i, b]) / 2),
                "gt_to_pred_max": float(da[i, a]),
                "gt_to_pred_piece": int(shape["_piece"][near[i, a]]),
                "pred_to_gt_max": float(db[i, b]),
                "pred_to_gt_piece": int(shape["_piece"][face_id[i, b]]),
            }
    for shape in shapes:
        del shape["_piece"]
    return shapes


def report(experiment_path: str, checkpoint: str = "best",
           points=(5000, 100_000), device: str = "cuda") -> dict:
    import torch

    from deftet_tpu_torch.cli import _eval_val_set
    from deftet_tpu_torch.config import Experiment
    from deftet_tpu_torch.data import batch_iterator
    from deftet_tpu_torch.train import Engine

    experiment = Experiment.load(experiment_path)
    config = experiment.config
    engine = Engine(config, device=torch.device(device),
                    experiment=experiment)
    engine.restore(checkpoint)
    val_set = _eval_val_set(experiment_path, config)
    shapes = []
    for batch in batch_iterator(val_set, config.batch_size):
        shapes += batch_report(engine, engine._prep_batch(batch), points)
    for i, shape in enumerate(shapes):
        shape["shape"] = os.path.basename(val_set.paths[i])
    return {"experiment": experiment_path, "checkpoint": checkpoint,
            "hausdorff_max": {
                str(n): float(np.mean([s["points"][str(n)]["hausdorff_max"]
                                       for s in shapes])) for n in points},
            "shapes_with_pieces": sum(s["pieces"] > 1 for s in shapes),
            "shapes": shapes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("experiment")
    ap.add_argument("--checkpoint", default="best", choices=["best", "last"])
    ap.add_argument("--eval_points", type=int, nargs="+",
                    default=[5000, 100_000])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    out = report(args.experiment, args.checkpoint, args.eval_points,
                 args.device)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
