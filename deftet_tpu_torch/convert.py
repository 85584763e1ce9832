"""Convert the JAX package's flax variables into the port's state dict,
and its 2D-supervision parameters into tensors.

Input: ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (``jax.device_get`` of a flax variables tree).  The port's module
paths are the flax paths joined with dots, so the mapping is per leaf:

* Dense ``kernel`` (in, out)              -> ``weight`` (out, in)
* Conv ``kernel`` (k, k, k, in, out)      -> ``weight`` (out, in, k, k, k)
  (a permutation, not a flip: both frameworks cross-correlate)
* BatchNorm ``scale``                     -> ``weight``
* ``bias``                                -> ``bias``
* batch_stats ``mean`` / ``var``          -> ``running_mean`` / ``running_var``

Every flax leaf must land on exactly one entry of the model's state dict
and every entry must be filled; anything else raises with the offending
paths.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _param_leaf(path: tuple, arr: np.ndarray):
    name = path[-1]
    mod = ".".join(path[:-1])
    if name == "kernel" and arr.ndim == 2:
        return f"{mod}.weight", arr.T
    if name == "kernel" and arr.ndim == 5:
        return f"{mod}.weight", arr.transpose(4, 3, 0, 1, 2)
    if name == "scale":
        return f"{mod}.weight", arr
    if name == "bias":
        return f"{mod}.bias", arr
    return None, arr


def _stat_leaf(path: tuple, arr: np.ndarray):
    mod = ".".join(path[:-1])
    key = {"mean": "running_mean", "var": "running_var"}.get(path[-1])
    return (f"{mod}.{key}" if key else None), arr


def flax_to_state_dict(variables: Mapping, model: torch.nn.Module):
    """The state dict for ``model`` holding the flax ``variables``."""
    target = model.state_dict()
    out = {}
    unconsumed = []
    for collection, leaf_fn in (("params", _param_leaf),
                                ("batch_stats", _stat_leaf)):
        for path, arr in _flatten(variables.get(collection, {})).items():
            key, value = leaf_fn(path, arr)
            if key is None or key not in target or key in out:
                unconsumed.append(f"{collection}/{'/'.join(path)}")
                continue
            if tuple(target[key].shape) != value.shape:
                raise ValueError(
                    f"{collection}/{'/'.join(path)}: shape {value.shape} "
                    f"does not fit {key} {tuple(target[key].shape)}")
            out[key] = torch.tensor(np.array(value),
                                    dtype=target[key].dtype)
    if unconsumed:
        raise ValueError(f"flax leaves not consumed: {unconsumed}")
    missing = sorted(set(target) - set(out))
    if missing:
        raise ValueError(f"state-dict entries with no flax leaf: {missing}")
    return out


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Copy converted flax variables into ``model`` (strict)."""
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)


def render_params_from_numpy(tree: Mapping, device="cpu"):
    """The 2D-supervision parameters ``{"mov", "feat"}`` (the JAX render
    pipeline's pytree, as numpy arrays) as float32 tensors on ``device``."""
    missing = {"mov", "feat"} - set(tree)
    if missing:
        raise ValueError(f"render parameters lack {sorted(missing)}")
    return {k: torch.as_tensor(np.array(tree[k], dtype=np.float32),
                               device=device) for k in ("mov", "feat")}
