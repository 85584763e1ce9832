"""The port's dry runs (its counterpart of the repository's
``__graft_entry__.py``):

* ``entry()`` — the flagship forward at __graft_entry__.py's sizes (res 20,
  2,048 input points, 4,096 occupancy centers, the default widths, float32,
  evaluation mode, the padded-gather adjacency): ``(fn, example_args)``;
* ``dryrun_multidevice(n)`` — one full data-parallel train step on ``n``
  ranks at __graft_entry__.py's multi-device configuration (res 20, the
  default encoder and decoder widths, 1,024 points, one example per
  rank): asserts a finite loss, equal on every rank, and prints one line.

The JAX dry run's 2-D ``(data, space)`` mesh shards the surface-point
axis too; that is a layout of the same function (tests/test_train.py
holds it equal to the 1-D mesh), and the port shards the batch only.

    python -m deftet_tpu_torch.dryrun [n] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from . import parallel
from .config import TrainConfig
from .convert import load_flax_variables
from .nn import DeformableTetNetwork
from .nn.gcn import VertexAdjacency
from .train.statics import build_grid_statics


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
    return dev


def entry(device="cuda", variables=None):
    """(fn, example_args): one network forward of the flagship model —
    the two PVCNN encoders, the GCN position decoder over the res-20 grid,
    the occupancy decoder at 4,096 centers — with parameters from a seed,
    or the flax ``variables`` (numpy trees) converted.  ``fn(inp,
    init_pos, centers)`` returns (delta, positions, raw delta, logits)."""
    dev = _device(device)
    if dev.type == "cuda":
        # float32 means float32, as the Engine sets it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = TrainConfig(res=20, n_point=2048, occ_sample=4096)
    statics = build_grid_statics(config.res, device=dev)
    model = DeformableTetNetwork(
        blocks=config.parsed_blocks(),
        generator=torch.Generator().manual_seed(config.seed))
    if variables is not None:
        load_flax_variables(model, variables)
    model = model.to(dev)
    adj = VertexAdjacency(idx=statics.vert_adj_idx,
                          mask=statics.vert_adj_mask,
                          degree=statics.vert_degree)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = 1
    inp = torch.rand((b, config.n_point, 3), generator=gen, device=dev) - 0.5
    init_pos = statics.init_pos_nx3[None].expand(b, -1, -1)
    centers = torch.rand((b, config.occ_sample, 3), generator=gen,
                         device=dev) - 0.5

    @torch.no_grad()
    def fn(inp, init_pos, centers):
        pyr_pos, pyr_occ = model.encode(inp, False)
        delta, pos, ori = model.decode_pos(init_pos, pyr_pos, None, False,
                                           adj)
        return delta, pos, ori, model.decode_occ(centers, pyr_occ, False)

    return fn, (inp, init_pos, centers)


def dryrun_config(n_ranks: int, **over) -> TrainConfig:
    """__graft_entry__.py's multi-device configuration: one example per
    rank, res 20, the default widths, 1,024 points, 4,096 centers."""
    kw = dict(res=20, batch_size=n_ranks, n_point=1024,
              num_sample_points=1024, occ_sample=4096, per_face_samples=4)
    kw.update(over)
    return TrainConfig(**kw)


def dryrun_batch(config: TrainConfig):
    """The dry run's global batch (__graft_entry__.py's): uniform surface
    points and one procedural mesh per example."""
    from .data.shapes import random_shape

    b = config.batch_size
    rng = np.random.default_rng(0)
    verts, faces = random_shape(0, level=0)
    return {
        "surface_points": rng.uniform(-0.4, 0.4, (b, config.n_point, 3)
                                      ).astype(np.float32),
        "verts": np.tile(verts.astype(np.float32)[None], (b, 1, 1)),
        "faces": np.tile(faces.astype(np.int32)[None], (b, 1, 1)),
        "n_faces": np.full((b,), faces.shape[0], np.int32),
    }


def _dryrun_rank(world, config: TrainConfig):
    from .ops import _cuda
    from .train import Engine

    engine = Engine(config, world=world)
    _cuda.reset_launch_counts()
    terms = engine.train_step(engine._prep_batch(dryrun_batch(config)))
    total = float(terms["total"])
    if not math.isfinite(total):
        raise AssertionError(f"rank {world.rank}: non-finite loss {total}")
    return {"total": total, "backend": world.backend,
            "device": str(world.device),
            "launches": dict(_cuda.launch_counts)}


def dryrun_multidevice(n: int, device="cuda",
                       config: TrainConfig | None = None):
    """One full train step on ``n`` ranks (spawned here); returns each
    rank's {"total", "backend", "device", "launches"}.  On ``cuda`` the
    kernels are built once before the ranks start; ranks share one card
    over gloo where the machine has fewer cards than ranks."""
    dev = _device(device)
    if dev.type == "cuda":
        from .ops import _cuda

        _cuda.build_all()
    config = config or dryrun_config(n)
    results = parallel.run_ranks(_dryrun_rank, n, config, device=dev.type)
    totals = {r["total"] for r in results}
    if len(totals) != 1:
        raise AssertionError(f"the ranks' losses differ: {sorted(totals)}")
    first = results[0]
    rows = config.batch_size // parallel.largest_divisor(n, config.batch_size)
    print(f"dryrun_multidevice({n}): ok, backend={first['backend']}, "
          f"devices={[r['device'] for r in results]}, rows per rank={rows}, "
          f"res={config.res}, loss={first['total']:.4f}", flush=True)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="deftet_tpu_torch.dryrun")
    parser.add_argument("n", type=int, nargs="?", default=2)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dryrun_multidevice(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
