"""Training configuration and experiment persistence (torch port of
deftet_tpu/config.py).

``TrainConfig`` carries the JAX package's fields and defaults for what the
port runs; a config JSON of the JAX package replays here (unknown keys are
ignored).  ``use_disn``, ``use_lap_layer`` and ``mesh_dir`` are kept so
that the engine and the CLI can refuse them by name rather than ignore
them.  ``add_config_args`` compiles the dataclass into argparse
flags (bools as ``--x`` / ``--no_x`` pairs); ``Experiment`` is the
timestamped directory holding ``config.json`` and ``state.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import uuid
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # -- grid / model -------------------------------------------------------
    res: int = 20
    use_two_encoder: bool = True
    scale_pvcnn: bool = True
    scale_pos: bool = True
    train_def: bool = True
    # (out_channels, num_blocks, voxel_res) groups; decoder widths where
    # entries < 1 are dropout rates.
    encoder_blocks: str = "64,1,32;128,2,16;512,1,8"
    gcn_hidden: str = "256,256,128"
    pos_mlp_hidden: str = "128,0.2,64"
    occ_mlp_hidden: str = "256,0.2,256,0.2,128,0.2,64"

    # -- input pipeline -----------------------------------------------------
    n_point: int = 5000
    add_input_noise: bool = True
    input_noise: float = 0.005
    batch_size: int = 8
    num_sample_points: int = 5000

    # -- optimization -------------------------------------------------------
    lr: float = 1e-3
    # cosine decay of the lr to lr * lr_final_scale over lr_decay_steps
    # updates; 0 keeps the lr constant
    lr_decay_steps: int = 0
    lr_final_scale: float = 0.1
    epochs: int = 100
    grad_norm: bool = True
    grad_norm_clip: float = 40.0

    # -- loss weights -------------------------------------------------------
    lambda_occ: float = 10.0
    lambda_def: float = 1.0
    lambda_surf: float = 1.0
    lambda_surf_chamfer: float = 1.0
    lambda_normal: float = 100.0
    lambda_edge: float = 0.0
    lambda_delta: float = 10.0
    lambda_amips: float = 10.0
    lambda_lap: float = 10.0
    lambda_area: float = 10000.0
    pow: int = 4

    # -- occupancy ----------------------------------------------------------
    # "grid" reads the occupancy texture; "check_sign" runs the +z ray
    # parity over the GT mesh every step
    occ_source: str = "grid"
    occ_grid_interp: str = "nearest"
    occ_grid_res: int = -1

    def resolved_occ_grid_res(self) -> int:
        if self.occ_grid_res < 0:
            return max(64, 2 * self.res)
        return self.occ_grid_res

    occ_sample: int = 10000
    # surface samples per side for the inference metrics; 0 means
    # num_sample_points (the eval CLI defaults it to 100,000)
    eval_points: int = 0
    occ_threshold: float = 0.4
    iou_logit_threshold: float = 0.1

    # -- surface losses -----------------------------------------------------
    per_face_samples: int = 20
    chamfer_samples_cap: int = 200_000
    # -1 = auto (8 r^2, capped at the face count).  When the boundary
    # overflows the budget the FIRST k faces in class-major face order are
    # kept (not a uniform sample), as in the JAX package.
    max_boundary_faces: int = -1

    def resolved_max_boundary_faces(self) -> int:
        if self.max_boundary_faces < 0:
            return min(8 * self.res * self.res, 12 * self.res**3)
        return self.max_boundary_faces

    timing: bool = False

    # -- not ported, refused by name: the DISN branch and the lap layer ----
    use_disn: bool = False
    use_lap_layer: bool = False

    # -- training schedule --------------------------------------------------
    pretrain: str = ""  # experiment dir to warm-start parameters from
    # sequential microbatches per update; batch_size must divide by it
    grad_accum: int = 1
    # recompute the forward in the backward, keeping only the argmins,
    # the boundary compaction and the occupancy labels
    remat: bool = False
    finetune_occ: bool = False
    print_every: int = 1000
    save_vis_every: int = 10000
    use_init_pos_mask: bool = True
    use_graph_attention: bool = False

    # -- runtime ------------------------------------------------------------
    seed: int = 1
    experiment_id: str = ""
    logdir: str = "experiments"
    dataset_root: str = "data_cache"
    mesh_dir: str = ""  # not ported: the CLI refuses it
    n_shapes: int = 32
    val_every: int = 1
    # select the best checkpoint by the threshold-swept SDF-point IoU of
    # the full inference path; off selects by the train-style occ_iou
    val_inference: bool = True
    save_vis: bool = False
    # "bf16" runs the encoder/decoder matmuls, convs and BatchNorms in
    # bfloat16 with float32 parameters; "f32" runs everything in float32.
    precision: str = "bf16"

    def parsed_blocks(self):
        return tuple(
            tuple(int(x) for x in group.split(","))
            for group in self.encoder_blocks.split(";")
            if group
        )

    @staticmethod
    def _parse_hidden(spec: str):
        return tuple(
            int(float(x)) if float(x) >= 1 else float(x)
            for x in spec.split(",")
            if x
        )

    def parsed_gcn_hidden(self):
        return self._parse_hidden(self.gcn_hidden)

    def parsed_pos_mlp_hidden(self):
        return self._parse_hidden(self.pos_mlp_hidden)

    def parsed_occ_mlp_hidden(self):
        return self._parse_hidden(self.occ_mlp_hidden)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        raw = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            return cls.from_json(f.read())


# Options of the original implementation that no code path reads; accepted
# and ignored so that its invocations and saved configs replay.  ("device",
# ignored by the JAX package, is the port's CLI flag for the torch device.)
REFERENCE_COMPAT_FLAGS = (
    "point_cloud", "loader_workers", "data_root", "shape_train_gt_root",
    "shape_train_ori_gt_root", "dataset_dir", "use_all", "expid",
    "lambda_prob_d", "detach", "sample_box", "z_window_radius",
    "use_surface_prob_loss", "use_old_intersection_test", "use_surface_dis",
    "optimize_network", "upsample", "upsample_layer", "upsample_gt_occ",
    "use_pos_encoding", "use_vert_feat", "use_init_boundary",
    "alternate_training", "def_epochs", "occ_epochs",
    "use_learned_def_mask", "c_dim", "use_vertex_loss", "use_l2_chamfer",
    "occ_detach_def", "use_init_correspondence", "expand_boundary",
    "use_pvcnn_pos_decoder", "use_pvcnn_decoder", "use_gcn_pos_decoder",
    "use_pvcnn_occ_decoder", "use_dvr_pos_decoder", "use_dvr_occ_decoder",
    "baseline", "upscale", "use_apex", "finetune_pos", "full_scene",
    "voxel_baseline", "voxel_baseline_res", "mesh_baseline",
    "meshrcnn_baseline", "disn_baseline", "meshrcnn_threshold",
    "pretrain_voxel", "occnet_baseline", "dmc_baseline", "use_distributed",
    "add_geo_feat", "optimize_part", "use_img_conv", "use_dvr_decoder",
    "use_projection", "train_car", "pretrain_occ", "adaptive_sample",
    "use_occ_encoder", "pos_pretrain_path", "predict_color",
    "resize_input_shape", "resize_local_feature_shape", "local_rank",
    "categories",
)


def add_config_args(parser: argparse.ArgumentParser,
                    cls=TrainConfig) -> argparse.ArgumentParser:
    """One flag per field; bools become ``--name`` / ``--no_name`` with a
    None default, so that only flags given override the config."""
    for f in dataclasses.fields(cls):
        name = f.name
        if isinstance(f.default, bool):
            group = parser.add_mutually_exclusive_group()
            group.add_argument(f"--{name}", dest=name, action="store_true",
                               default=None)
            group.add_argument(f"--no_{name}", dest=name,
                               action="store_false", default=None)
        else:
            parser.add_argument(f"--{name}", type=type(f.default),
                                default=None)
    compat = parser.add_argument_group("reference compatibility (ignored)")
    for name in REFERENCE_COMPAT_FLAGS:
        compat.add_argument(f"--{name}", nargs="?", const=True, default=None,
                            help=argparse.SUPPRESS)
        compat.add_argument(f"--no_{name}", action="store_true",
                            default=None, help=argparse.SUPPRESS)
    return parser


def config_from_args(args: argparse.Namespace,
                     base: Optional[TrainConfig] = None) -> TrainConfig:
    cfg = base or TrainConfig()
    for f in dataclasses.fields(TrainConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
    return cfg


class Experiment:
    """``{logdir}/{timestamp}_{id}/`` with ``config.json`` and
    ``state.json`` (epoch, best IoU, global step)."""

    CONFIG = "config.json"
    STATE = "state.json"

    def __init__(self, path: str, config: TrainConfig):
        self.path = path
        self.config = config

    @classmethod
    def new(cls, config: TrainConfig) -> "Experiment":
        ident = config.experiment_id or uuid.uuid4().hex[:8]
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        path = os.path.join(config.logdir, f"{stamp}_{ident}")
        os.makedirs(path, exist_ok=True)
        config.save(os.path.join(path, cls.CONFIG))
        exp = cls(path, config)
        exp.write_state({"epoch": 0, "best_iou": 0.0, "global_step": 0})
        return exp

    @classmethod
    def load(cls, path: str) -> "Experiment":
        return cls(path, TrainConfig.load(os.path.join(path, cls.CONFIG)))

    def file_path(self, name: str) -> str:
        return os.path.join(self.path, name)

    def write_state(self, state: dict) -> None:
        with open(self.file_path(self.STATE), "w") as f:
            json.dump(state, f, indent=2)

    def read_state(self) -> dict:
        with open(self.file_path(self.STATE)) as f:
            return json.load(f)
