"""Training engine: builds the grid, statics, model and optimizer for one
configuration and runs train steps on one device (torch port of the
construction and step of deftet_tpu/train/engine.py; checkpoints, the
epoch loop and validation are not ported yet).

``Engine(config)`` runs on the GPU.  ``device="cpu"`` runs every kernel's
plain PyTorch version instead, as the tests do.  Asking for CUDA without
a GPU raises; nothing falls back silently.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import TrainConfig
from ..nn import DeformableTetNetwork
from ..tetgrid import build_tet_grid, face_lattice_info
from .statics import build_grid_statics, lattice_offsets, lattice_tet_offsets
from .step import forward_losses, make_optimizer, train_step


def _check_supported(config: TrainConfig) -> None:
    unsupported = {
        "grad_accum": config.grad_accum != 1,
        "remat": config.remat,
        "use_disn": config.use_disn,
        "use_lap_layer": config.use_lap_layer,
        "use_graph_attention": config.use_graph_attention,
        "occ_source": config.occ_source != "grid",
        "precision": config.precision not in ("bf16", "f32"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not supported by the port yet: {bad}")


class Engine:
    """Owns the statics, model, optimizer and generator of one run."""

    def __init__(self, config: TrainConfig, device="cuda"):
        _check_supported(config)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Engine(device='cuda') needs a CUDA "
                                   "device; pass device='cpu' to run on "
                                   "the CPU")
            # float32 means float32, as in the JAX package: cuDNN would
            # otherwise run float32 convolutions in TF32 (matmuls already
            # default to full float32).  Process-wide settings.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = config
        grid = build_tet_grid(config.res)
        self.statics = build_grid_statics(config.res, grid=grid,
                                          device=self.device)
        self.lattice_offsets = lattice_offsets(grid)
        self.tet_lattice = lattice_tet_offsets(grid)
        self.face_lattice = face_lattice_info(grid)
        init_gen = torch.Generator().manual_seed(config.seed)
        self.model = DeformableTetNetwork(
            blocks=config.parsed_blocks(),
            use_two_encoder=config.use_two_encoder,
            scale_pos=config.scale_pos,
            scale_pvcnn=config.scale_pvcnn,
            train_def=config.train_def,
            gcn_hidden=config.parsed_gcn_hidden(),
            pos_mlp_hidden=config.parsed_pos_mlp_hidden(),
            occ_mlp_hidden=config.parsed_occ_mlp_hidden(),
            dtype=torch.bfloat16 if config.precision == "bf16" else None,
            generator=init_gen,
        ).to(self.device)
        self.optimizer = make_optimizer(config, list(self.model.parameters()))
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self.global_step = 0

    def _prep_batch(self, batch: Dict[str, np.ndarray]):
        """Numeric batch entries as tensors on the engine's device."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                out[k] = v.to(self.device)
            elif isinstance(v, np.ndarray) and (
                    np.issubdtype(v.dtype, np.number)
                    or np.issubdtype(v.dtype, np.bool_)):
                out[k] = torch.as_tensor(v, device=self.device)
        return out

    def _lattice(self):
        return dict(lattice_offsets=self.lattice_offsets,
                    tet_lattice=self.tet_lattice,
                    face_lattice=self.face_lattice)

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One optimizer update on a prepared batch; returns the terms."""
        terms = train_step(self.model, self.optimizer, batch, self.statics,
                           self.config, self.generator, draws=draws,
                           **self._lattice())
        self.global_step += 1
        return terms

    def forward_losses(self, batch, train: bool = True, draws=None):
        """(total, terms) without an update (for gradients or parity)."""
        return forward_losses(self.model, batch, self.statics, self.config,
                              self.generator, train=train, draws=draws,
                              **self._lattice())
