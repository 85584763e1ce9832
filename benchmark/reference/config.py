"""Training configuration (a frozen copy of the port's ``config.py``).

``TrainConfig`` carries the port's fields and defaults, without the
port's persistence and flags.
"""

from __future__ import annotations

import dataclasses


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
    # kept (not a uniform sample), as in the JAX package.  0 = all
    # interior faces (no compaction), the reference's own semantics.
    max_boundary_faces: int = -1

    def resolved_max_boundary_faces(self) -> int:
        if self.max_boundary_faces < 0:
            return min(8 * self.res * self.res, 12 * self.res**3)
        return self.max_boundary_faces

    timing: bool = False

    # -- DISN image branch: VGG-16 image encoders and global + local SDF
    # decoders in place of the PVCNN encoders and the GCN / MLP decoders;
    # batches carry ``imgs`` (B, H, W, 3) and ``cam_matrix`` (B, 4, 4)
    # row-vector world-to-screen matrices
    use_disn: bool = False
    disn_image_size: int = 64
    disn_local_feature_size: int = 64
    disn_encoding_dim: int = 1000  # the VGG classifier's width
    disn_width: float = 1.0        # VGG width multiplier (1.0 = VGG-16-D)

    # -- lap (refinement) layer: a second position decoder refining the
    # first one's output.  lap_threshold and lambda_lap_v_loss are kept
    # for config replay: the JAX package's lap_v_loss is identically zero
    use_lap_layer: bool = False
    lap_threshold: float = 0.4
    lambda_lap_v_loss: float = 10.0

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
    # train on the OBJ meshes under this directory tree (watertighted and
    # sampled offline) instead of the procedural shape family
    mesh_dir: str = ""
    watertight_res: int = 100  # voxelization resolution of the remesh
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
