"""Train step, optimizer, statics, checkpoints and the engine."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .engine import Engine
from .statics import (
    GridStatics,
    build_grid_statics,
    lattice_offsets,
    lattice_tet_offsets,
)
from .step import (
    ClippedAdam,
    eval_step,
    forward_losses,
    make_optimizer,
    train_step,
)

__all__ = [
    "ClippedAdam",
    "Engine",
    "GridStatics",
    "build_grid_statics",
    "eval_step",
    "forward_losses",
    "latest_step",
    "lattice_offsets",
    "lattice_tet_offsets",
    "make_optimizer",
    "restore_checkpoint",
    "save_checkpoint",
    "train_step",
]
