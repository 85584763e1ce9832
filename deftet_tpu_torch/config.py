"""Training configuration: the ``TrainConfig`` fields the train step and
``Engine`` read, with the JAX package's defaults (deftet_tpu/config.py).

Fields for paths the port does not run yet (gradient accumulation,
rematerialization, the lap layer, ``check_sign`` occupancy, DISN) are
kept where the engine must refuse them rather than ignore them.
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
    grad_norm: bool = True
    grad_norm_clip: float = 40.0
    # Not ported yet (the res-70/bs-8 path); the engine refuses them.
    lr_decay_steps: int = 0
    grad_accum: int = 1
    remat: bool = False

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
    # "grid" reads the occupancy texture; "check_sign" is not ported.
    occ_source: str = "grid"
    occ_grid_interp: str = "nearest"
    occ_grid_res: int = -1

    def resolved_occ_grid_res(self) -> int:
        if self.occ_grid_res < 0:
            return max(64, 2 * self.res)
        return self.occ_grid_res

    occ_sample: int = 10000
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

    use_disn: bool = False
    use_lap_layer: bool = False
    finetune_occ: bool = False
    use_init_pos_mask: bool = True
    use_graph_attention: bool = False

    # -- runtime ------------------------------------------------------------
    seed: int = 1
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
