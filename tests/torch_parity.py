"""Shared set-up of the JAX-versus-port parity tests: the small network
configuration (and the DISN branch's tiny one), a JAX model with its flax
variables, the port's model holding the same variables, and a batch built
from a seed."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deftet_tpu.config import TrainConfig as JaxConfig
from deftet_tpu.nn import DeformableTetNetwork as JaxNet
from deftet_tpu.nn import VertexAdjacency
from deftet_tpu_torch.config import TrainConfig
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.nn import DeformableTetNetwork

# The small network of bench.py's BENCH_SMALL mode (no dropout slots),
# in float32, at a res-4 grid and batch 2.
SMALL = dict(
    res=4,
    batch_size=2,
    encoder_blocks="8,1,8;16,1,4",
    gcn_hidden="16,8",
    pos_mlp_hidden="8",
    occ_mlp_hidden="16,8",
    n_point=256,
    num_sample_points=256,
    per_face_samples=4,
    precision="f32",
)


def configs(**over):
    """(JAX TrainConfig, port TrainConfig) with the same fields."""
    kw = {**SMALL, **over}
    port = TrainConfig(**kw)
    jax_cfg = JaxConfig(**kw)
    return jax_cfg, port


# The DISN image branch at tests/test_disn.py's tiny width.
DISN_TINY = dict(use_disn=True, disn_width=0.05, disn_encoding_dim=64,
                 disn_image_size=32, disn_local_feature_size=16)


def _disn_fields(cfg):
    return dict(use_lap_layer=cfg.use_lap_layer, use_disn=cfg.use_disn,
                disn_image_size=cfg.disn_image_size,
                disn_local_feature_size=cfg.disn_local_feature_size,
                disn_encoding_dim=cfg.disn_encoding_dim,
                disn_width=cfg.disn_width)


def jax_model(cfg, statics):
    """The JAX network of ``cfg``, computing in bfloat16 where
    ``cfg.precision`` is "bf16" (as the JAX engine builds it)."""
    adj = VertexAdjacency(idx=statics.vert_adj_idx, mask=statics.vert_adj_mask,
                          degree=statics.vert_degree)
    return JaxNet(
        adj=adj, blocks=cfg.parsed_blocks(), use_two_encoder=True,
        dtype=jnp.bfloat16 if cfg.precision == "bf16" else None,
        gcn_hidden=cfg.parsed_gcn_hidden(),
        pos_mlp_hidden=cfg.parsed_pos_mlp_hidden(),
        occ_mlp_hidden=cfg.parsed_occ_mlp_hidden(),
        **_disn_fields(cfg),
    )


def jax_variables(model, cfg, statics, seed=0):
    """flax variables with non-trivial BatchNorm parameters and statistics
    (the initial ones are all 0 / 1 and would hide a layout slip)."""
    init = jax.jit(lambda key, a, b, c: model.init(key, a, b, c,
                                                   train=False))
    if cfg.use_disn:
        s = cfg.disn_image_size
        dummy = jnp.zeros((1, s, s, 3))
    else:
        dummy = jnp.zeros((1, cfg.n_point, 3))
    variables = init(jax.random.PRNGKey(seed), dummy,
                     statics.init_pos_nx3[None], jnp.zeros((1, 8, 3)))
    rng = np.random.default_rng(seed + 100)

    def jitter(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)
        if name in ("bias", "mean"):
            return jnp.asarray(rng.normal(0, 0.1, x.shape), jnp.float32)
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(jitter, dict(variables))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(cfg: TrainConfig, variables) -> DeformableTetNetwork:
    model = DeformableTetNetwork(
        blocks=cfg.parsed_blocks(), use_two_encoder=True,
        gcn_hidden=cfg.parsed_gcn_hidden(),
        pos_mlp_hidden=cfg.parsed_pos_mlp_hidden(),
        occ_mlp_hidden=cfg.parsed_occ_mlp_hidden(),
        generator=torch.Generator().manual_seed(0), **_disn_fields(cfg),
    )
    load_flax_variables(model, numpy_tree(variables))
    return model


def batch(cfg, seed=0, occ_res=16):
    """A batch as bench.py builds it: uniform surface points and the
    occupancy texture of a procedural shape."""
    from deftet_tpu.data.pipeline import occupancy_grid
    from deftet_tpu.data.shapes import random_shape

    verts, faces = random_shape(seed, level=1)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.4, 0.4, (cfg.batch_size, cfg.num_sample_points, 3))
    occ = occupancy_grid(verts, faces, occ_res)
    out = {
        "surface_points": pts.astype(np.float32),
        "occ_grid": np.tile(occ[None], (cfg.batch_size, 1, 1, 1)),
    }
    if cfg.use_disn:
        # uniform images (64 x 64, resized by the encoder) and the data
        # pipeline's random cameras
        from deftet_tpu.data.image_render import random_camera

        out["imgs"] = rng.uniform(0, 1, (cfg.batch_size, 64, 64, 3)).astype(
            np.float32)
        out["cam_matrix"] = np.stack([random_camera(rng)
                                      for _ in range(cfg.batch_size)])
    return out


def assert_tree_close(ref: dict, got: dict, rtol, atol, what="", prefix=""):
    """ref: nested dict of arrays (flax layout); got: {dotted path: array}
    in the flax layout too."""
    for k, v in ref.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            assert_tree_close(v, got, rtol, atol, what, path)
        else:
            np.testing.assert_allclose(
                np.asarray(got[path]), np.asarray(v), rtol=rtol, atol=atol,
                err_msg=f"{what} {path}")


def flax_layout(model: torch.nn.Module, tensors: dict) -> dict:
    """{dotted flax path: numpy array} from port tensors keyed by
    state-dict name, undoing the converter's layout change."""
    out = {}
    for name, t in tensors.items():
        mod, leaf = name.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if leaf == "weight" and a.ndim == 2:
            out[f"{mod}.kernel"] = a.T
        elif leaf == "weight" and a.ndim == 4:
            out[f"{mod}.kernel"] = a.transpose(2, 3, 1, 0)
        elif leaf == "weight" and a.ndim == 5:
            out[f"{mod}.kernel"] = a.transpose(2, 3, 4, 1, 0)
        elif leaf == "weight":
            out[f"{mod}.scale"] = a
        elif leaf == "running_mean":
            out[f"{mod}.mean"] = a
        elif leaf == "running_var":
            out[f"{mod}.var"] = a
        else:
            out[f"{mod}.{leaf}"] = a
    return out



def split_grid(path, res=2):
    """(JAX TetGrid, port TetGrid) of the res-``res`` Kuhn grid split 1->8
    by the port's ``subdivide_tets``: a non-lattice grid, written by the
    port's ``save_tet_file`` to ``path`` and read back by each package's
    ``read_tet_file`` (the path a quartet ``.tet`` grid takes)."""
    from deftet_tpu.tetgrid import read_tet_file as jax_read
    from deftet_tpu_torch.tetgrid import (TetGrid, build_tet_grid,
                                          read_tet_file, save_tet_file,
                                          subdivide_tets)

    g = build_tet_grid(res)
    points, _, tets = subdivide_tets(g.tets, g.vertices)
    save_tet_file(TetGrid(vertices=points, tets=tets,
                          interior_mask=np.zeros_like(points)), str(path))
    return jax_read(str(path)), read_tet_file(str(path))


def build_topology_of(pstat):
    """The port's numpy ``Topology`` of a port ``GridStatics``' tets."""
    from deftet_tpu_torch.tetgrid import build_topology

    return build_topology(pstat.tet_tx4.numpy(), pstat.n_vertices)
