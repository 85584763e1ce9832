"""The reference's entries for DefTet's DISN configuration (``use_disn``):
its network, the names and shapes of its state, and the first training
updates, beside ``steps.py``, which builds the point network.  The grid,
the losses, the optimizer and the step are ``steps.py``'s and
``train/step.py``'s.

``lower=True`` computes every convolution and Dense of the DISN modules
in bfloat16, a step below the float32 that the configuration states for
them (the control that has to fail the comparison); ``global_only=True``
drops the heads' local branch and ``half_batch=True`` runs each update
on the first half of its rows (planted faults).
"""

from __future__ import annotations

import dataclasses

import torch

from . import steps as plain
from .config import TrainConfig
from .nn.disn import DISNNetwork
from .train.step import make_optimizer, train_step


def network(config: TrainConfig, device, lower: bool = False,
            global_only: bool = False) -> DISNNetwork:
    """The DISN network of ``config`` (parameters as built: load the
    benchmark's weights into it)."""
    if not config.use_disn or config.use_lap_layer:
        raise ValueError("the DISN reference has no point network and no "
                         "lap head")
    return DISNNetwork(
        encoding_dim=config.disn_encoding_dim,
        image_size=config.disn_image_size,
        local_size=config.disn_local_feature_size,
        width=config.disn_width,
        use_two_encoder=config.use_two_encoder,
        scale_pos=config.scale_pos,
        train_def=config.train_def,
        dtype=torch.bfloat16 if lower else None,
        global_only=global_only,
    ).to(device)


def state_shapes(config: TrainConfig) -> list:
    """(name, shape) of the parameters, in state-dict order (built on the
    meta device)."""
    with torch.device("meta"):
        model = network(config, "meta")
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


def parameter_names(config: TrainConfig) -> list:
    """The parameters' names in the optimizer's order."""
    with torch.device("meta"):
        model = network(config, "meta")
    return [k for k, _ in model.named_parameters()]


def train_readings(config: TrainConfig, weights: dict, batches, device,
                   steps: int = 3, lower: bool = False,
                   global_only: bool = False, half_batch: bool = False,
                   grid: plain.Grid | None = None) -> dict:
    """``steps.train_readings`` for the DISN network: each update's total
    loss, the first update's terms, each parameter's norm of the first
    gradient as the optimizer takes it and of its change over the
    updates, the draws from a generator seeded ``config.seed + 1``."""
    plain._exact_float32()
    grid = grid or plain.build_grid(config, device)
    model = network(config, device, lower, global_only)
    model.load_state_dict(weights)
    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    opt = make_optimizer(config, params)
    gen = torch.Generator(device=device).manual_seed(config.seed + 1)
    run_config = config
    if half_batch:
        run_config = dataclasses.replace(config,
                                         batch_size=config.batch_size // 2)
    loss = []
    for i in range(steps):
        batch = plain._on(batches[i], device)
        if half_batch:
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        terms = train_step(model, opt, batch, grid.statics, run_config, gen,
                           **grid.lattice)
        loss.append(float(terms["total"]))
        if i == 0:
            grad = plain.leaf_norms([m / (1.0 - opt.b1) for m in opt.mu])
            first = {k: float(v) for k, v in terms.items()}
    change = plain.leaf_norms([p.detach() - s for p, s in zip(params, start)])
    return {"loss": loss, "terms": first, "grad": grad, "change": change}
