"""Checkpoints as torch state dicts (torch port of
deftet_tpu/train/checkpoint.py, which writes orbax trees).

One file per name under the experiment's ``ckpt/`` directory, ``last`` and
``best`` as in the JAX package.  A save writes a temporary file and
renames it over the old one (``os.replace``), so a crash mid-save leaves
the previous checkpoint whole.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def checkpoint_path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(directory), f"{name}.pt")


def save_checkpoint(directory: str, name: str, tree: Any) -> str:
    """Save a tree of tensors, lists, dicts and numbers; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, name)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, name: str, map_location=None) -> Any:
    """Load a tree written by ``save_checkpoint`` (tensors and plain
    containers only)."""
    return torch.load(checkpoint_path(directory, name),
                      map_location=map_location, weights_only=True)


def latest_step(directory: str) -> Optional[int]:
    """The largest integer-named checkpoint (``{step}.pt``) in
    ``directory``, else None (also for a missing directory)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(f[:-3]) for f in os.listdir(directory)
             if f.endswith(".pt") and f[:-3].isdigit()]
    return max(steps) if steps else None
