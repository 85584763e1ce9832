"""Frozen operation and byte counts: the yardstick of the roofline and
MFU metrics, worked out from a configuration's shapes alone.

``bound_ms``, ``stencil_bound`` and ``nearest_bound`` are copies of the
arithmetic of ``chip_smoke.py`` (K1 and K2 at their inputs' shapes; H100
SXM peaks from NVIDIA's data sheet).  ``model_flops`` counts the matmuls
and convolutions of the network: the two PVCNN encoders, the GCN
position decoder with its heads, and the occupancy MLP, as
``torch.utils.flop_counter`` counts them (2 per multiply-add).
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12    # H100 SXM bf16 tensor cores, dense, FLOP/s

# the 14 neighbour offsets of the Kuhn lattice's vertex adjacency
LATTICE_OFFSETS = ((-1, -1, -1), (-1, -1, 0), (-1, 0, -1), (-1, 0, 0),
                   (0, -1, -1), (0, -1, 0), (0, 0, -1), (0, 0, 1),
                   (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0),
                   (1, 1, 1))
NEAREST_QUERY_TILE = 512  # K2 skips whole 512-query tiles past n_queries


def bound_ms(n_bytes: float, n_flops: float):
    """(least ms, "bytes" or "operations") at the float32 peaks."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def _in_lattice_reads(n: int, offsets) -> int:
    ijk = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    return sum(int(np.all((ijk + o >= 0) & (ijk + o < n), -1).sum())
               for o in np.asarray(offsets))


def stencil_bound(b: int, n: int, c: int, itemsize: int, n_scales: int = 1,
                  offsets=LATTICE_OFFSETS):
    """(bound ms, bound by) of one K1 call on (b, n^3, c): x read and out
    written once, each scale read once; one add per in-lattice neighbour
    read and one multiply per element for each scale."""
    v = n**3
    n_flops = b * c * (_in_lattice_reads(n, offsets) + n_scales * v)
    n_bytes = 2 * b * v * c * itemsize + n_scales * v * 4
    return bound_ms(n_bytes, n_flops)


def nearest_bound(b: int, p: int, m: int, n_valid=None, n_queries=None):
    """(pairs, bound ms, bound by) of one K2 call of (b, p) queries
    against (b, m) references: 8 flops (3 sub, 3 mul, 2 add) per scanned
    pair, i.e. per valid reference and query in a live 512-query tile;
    both clouds read and both outputs written once."""
    n_valid = np.full(b, m) if n_valid is None else np.asarray(n_valid)
    n_queries = np.full(b, p) if n_queries is None else np.asarray(n_queries)
    tile = NEAREST_QUERY_TILE
    live = np.clip((n_queries + tile - 1) // tile * tile, 0, p)
    valid = np.clip(n_valid, 0, m)
    pairs = int((live.astype(np.int64) * valid.astype(np.int64)).sum())
    n_bytes = b * p * 3 * 4 + b * m * 3 * 4 + 8 * b * p
    return (pairs, *bound_ms(n_bytes, 8 * pairs))


def _dense(rows: int, widths) -> int:
    """2 rows in out for each consecutive pair of ``widths``."""
    return sum(2 * rows * a * b for a, b in zip(widths[:-1], widths[1:]))


def _widths(hidden) -> list:
    return [int(float(h)) for h in hidden if float(h) >= 1]


def encoder_flops(cfg: dict, b: int) -> int:
    """One PVCNN encoder on b clouds of ``n_point`` points: per block the
    two 3^3 convolutions at its voxel resolution and the point MLP."""
    total, in_c = 0, 3
    for group in cfg["encoder_blocks"].split(";"):
        out_c, n_blocks, r = (int(x) for x in group.split(","))
        for _ in range(n_blocks):
            vox = b * r**3 * 27
            total += 2 * vox * in_c * out_c + 2 * vox * out_c * out_c
            total += 2 * b * cfg["n_point"] * in_c * out_c
            in_c = out_c
    return total


def feature_width(cfg: dict) -> int:
    """The probed pyramid's channels plus xyz (835 at the defaults)."""
    return sum(int(g.split(",")[0]) * int(g.split(",")[1])
               for g in cfg["encoder_blocks"].split(";")) + 3


def pos_decoder_flops(cfg: dict, rows: int) -> int:
    """The GCN position decoder on ``rows`` vertices: the initial Dense,
    each block's two graph convolutions (a self and a neighbour Dense
    each) and its shortcut, then the MLP head to xyz."""
    g = [int(x) for x in cfg["gcn_hidden"].split(",")]
    total = _dense(rows, [feature_width(cfg), g[0]])
    for i in range(len(g) - 1):
        total += 2 * _dense(rows, [g[i], g[i]])
        total += 2 * _dense(rows, [g[i], g[i + 1]])
        if g[i] != g[i + 1]:
            total += _dense(rows, [g[i], g[i + 1]])
    head = [g[-1]] + _widths(cfg["pos_mlp_hidden"].split(",")) + [3]
    return total + _dense(rows, head)


def occ_decoder_flops(cfg: dict, rows: int) -> int:
    """The occupancy MLP on ``rows`` tet centers."""
    widths = ([feature_width(cfg)] + _widths(cfg["occ_mlp_hidden"].split(","))
              + [1])
    return _dense(rows, widths)


def n_vertices(res: int) -> int:
    return (res + 1)**3


def n_tets(res: int) -> int:
    return 6 * res**3


def forward_flops(cfg: dict, b: int, occ_rows: int) -> int:
    """One forward of the network on b shapes, the occupancy MLP on
    ``occ_rows`` centers a shape."""
    encoders = 2 if cfg.get("use_two_encoder", True) else 1
    return (encoders * encoder_flops(cfg, b)
            + pos_decoder_flops(cfg, b * n_vertices(cfg["res"]))
            + occ_decoder_flops(cfg, b * occ_rows))


def train_step_flops(cfg: dict) -> int:
    """One optimizer update: three times the forward of each microbatch
    (forward, and the backward's two products), the occupancy MLP on
    ``occ_sample`` centers; recomputed work is not counted."""
    accum = max(int(cfg.get("grad_accum", 1)), 1)
    micro = cfg["batch_size"] // accum
    k = min(cfg["occ_sample"], n_tets(cfg["res"]))
    return 3 * accum * forward_flops(cfg, micro, k)


def inference_step_flops(cfg: dict, b: int) -> int:
    """One inference step: the forward with the occupancy MLP on every
    tet."""
    return forward_flops(cfg, b, n_tets(cfg["res"]))


def train_stencil_bound_ms(cfg: dict) -> float:
    """The least device ms of one update's stencil work, fixed by the
    configuration: per microbatch each graph convolution's neighbour mean
    at its input width in the compute dtype, forward and backward, and
    the Laplacian term's forward and backward at C=3 in float32."""
    accum = max(int(cfg.get("grad_accum", 1)), 1)
    micro = cfg["batch_size"] // accum
    n = cfg["res"] + 1
    item = 2 if cfg.get("precision", "bf16") == "bf16" else 4
    g = [int(x) for x in cfg["gcn_hidden"].split(",")]
    per = 0.0
    for i in range(len(g) - 1):
        per += 2 * 2 * stencil_bound(micro, n, g[i], item)[0]
    if cfg.get("lambda_lap", 0) and cfg.get("lambda_def", 0):
        per += 2 * stencil_bound(micro, n, 3, 4)[0]
    return accum * per


def eval_nearest_bound_ms(cfg: dict, b: int) -> float:
    """The least device ms of one inference step's nearest-neighbour
    work: F-score, extended F-score, Chamfer and Chamfer-L1, each both
    ways, of (b, eval_points) against (b, eval_points)."""
    p = cfg["eval_points"]
    return 8 * nearest_bound(b, p, p)[1]
