"""Train step, optimizer, statics and the engine."""

from .engine import Engine
from .statics import (
    GridStatics,
    build_grid_statics,
    lattice_offsets,
    lattice_tet_offsets,
)
from .step import ClippedAdam, forward_losses, make_optimizer, train_step

__all__ = [
    "ClippedAdam",
    "Engine",
    "GridStatics",
    "build_grid_statics",
    "forward_losses",
    "lattice_offsets",
    "lattice_tet_offsets",
    "make_optimizer",
    "train_step",
]
