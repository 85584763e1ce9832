"""The reference's entries: a configuration's grid, network and weights,
the first training updates, and one inference step, all in the frozen
plain copy.  Everything is worked out again from the configuration, the
inputs and the weights the benchmark made; nothing comes from the
program.

``lower=True`` computes the network's products in the precision a step
below the configuration's (float8 e4m3 for bfloat16): the control that
has to fail the comparison.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .config import TrainConfig
from .evals.harness import make_inference_step
from .nn.model import DeformableTetNetwork
from .tetgrid import build_tet_grid, face_lattice_info
from .train.statics import (
    build_grid_statics,
    lattice_offsets,
    lattice_tet_offsets,
)
from .train.step import make_optimizer, train_step

CLASSIFIER_BIAS = "decoder_occ.classifier.bias"


def make_config(fields: dict) -> TrainConfig:
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in fields.items() if k in names})


def _dtype(config: TrainConfig, lower: bool):
    if config.precision == "bf16":
        return torch.float8_e4m3fn if lower else torch.bfloat16
    if lower:
        raise ValueError("the lower-precision control is defined for bf16")
    return None


def network(config: TrainConfig, device, lower: bool = False):
    """The network of ``config`` (parameters left as built: load the
    benchmark's weights into it)."""
    return DeformableTetNetwork(
        blocks=config.parsed_blocks(),
        use_two_encoder=config.use_two_encoder,
        use_lap_layer=config.use_lap_layer,
        scale_pos=config.scale_pos,
        scale_pvcnn=config.scale_pvcnn,
        train_def=config.train_def,
        gcn_hidden=config.parsed_gcn_hidden(),
        pos_mlp_hidden=config.parsed_pos_mlp_hidden(),
        occ_mlp_hidden=config.parsed_occ_mlp_hidden(),
        dtype=_dtype(config, lower),
    ).to(device)


def state_shapes(config: TrainConfig) -> list:
    """(name, shape) of the network's parameters and buffers, in
    state-dict order (built on the meta device: no memory, no draws)."""
    with torch.device("meta"):
        model = network(config, "meta")
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


def parameter_names(config: TrainConfig) -> list:
    """The parameters' names in the optimizer's order."""
    with torch.device("meta"):
        model = network(config, "meta")
    return [k for k, _ in model.named_parameters()]


@dataclasses.dataclass
class Grid:
    statics: object
    lattice: dict


def build_grid(config: TrainConfig, device) -> Grid:
    """The regular res-``config.res`` Kuhn grid's statics and lattice
    tables, by the numpy builders."""
    grid = build_tet_grid(config.res)
    budget = config.resolved_max_boundary_faces()
    statics = build_grid_statics(
        config.res, grid=grid, device=device,
        face_arrays=not 0 < budget < 12 * config.res**3)
    return Grid(statics, dict(lattice_offsets=lattice_offsets(grid),
                              tet_lattice=lattice_tet_offsets(grid),
                              face_lattice=face_lattice_info(grid)))


def _exact_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


@torch.no_grad()
def occupancy_bias_shift(config: TrainConfig, weights: dict, batch: dict,
                         device, share: float) -> float:
    """The shift of the occupancy classifier's bias that puts the
    threshold ``occ_threshold`` at the (1 - share) quantile of the
    logits at the undeformed grid's tet centers (every 7th tet, every
    shape of ``batch``, the encoders reading the clean surface points),
    so that about ``share`` of the tets are predicted occupied."""
    _exact_float32()
    model = network(config, device)
    model.load_state_dict(weights)
    model.eval()
    grid = build_tet_grid(config.res)
    centers = torch.as_tensor(
        grid.centered_vertices()[grid.tets[::7]].mean(axis=1), dtype=torch.float32,
        device=device)
    pts = torch.as_tensor(batch["surface_points"][:, :config.n_point],
                          device=device)
    _, pyr_occ = model.encode(pts, False)
    logits = []
    for s in range(0, centers.shape[0], 100_000):
        tile = centers[s:s + 100_000][None].expand(pts.shape[0], -1, -1)
        logits.append(model.decode_occ(tile, pyr_occ, False).float())
    q = torch.quantile(torch.cat(logits, 1).reshape(-1)[::4], 1.0 - share)
    p = config.occ_threshold
    return float(math.log(p / (1.0 - p)) - q)


def leaf_norms(tensors) -> list:
    return [float(torch.linalg.vector_norm(t.float())) for t in tensors]


def train_readings(config: TrainConfig, weights: dict, batches, device,
                   steps: int = 3, lower: bool = False,
                   half_batch: bool = False, grid: Grid | None = None
                   ) -> dict:
    """The first ``steps`` updates from ``weights`` on ``batches`` (host
    numpy), the random draws from a generator seeded ``config.seed + 1``
    on ``device`` as the engine seeds its own: each update's total loss,
    the first update's terms, each parameter's norm of the first gradient as the optimizer takes it
    (after clipping, from its first moment), and of its change over the
    updates.  ``half_batch`` runs each update on the first half of its
    rows (a planted fault).  ``grid`` reuses a ``build_grid`` of this
    configuration."""
    _exact_float32()
    grid = grid or build_grid(config, device)
    model = network(config, device, lower)
    model.load_state_dict(weights)
    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    opt = make_optimizer(config, params)
    gen = torch.Generator(device=device).manual_seed(config.seed + 1)
    run_config = config
    if half_batch:
        run_config = dataclasses.replace(config,
                                         batch_size=config.batch_size // 2)
    loss, grad = [], None
    for i in range(steps):
        batch = _on(batches[i], device)
        if half_batch:
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        terms = train_step(model, opt, batch, grid.statics, run_config, gen,
                           **grid.lattice)
        loss.append(float(terms["total"]))
        if i == 0:
            grad = leaf_norms([m / (1.0 - opt.b1) for m in opt.mu])
            first = {k: float(v) for k, v in terms.items()}
    change = leaf_norms([p.detach() - s for p, s in zip(params, start)])
    return {"loss": loss, "terms": first, "grad": grad, "change": change}


@torch.no_grad()
def inference(config: TrainConfig, weights: dict, batch: dict, device,
              lower: bool = False, grid: Grid | None = None) -> dict:
    """One inference step on ``batch`` (host numpy), its surface draws
    from a generator seeded ``config.seed`` on ``device`` as the eval
    loop seeds its own: every metric, and the fewest boundary faces of
    any shape (``n_boundary_min``)."""
    _exact_float32()
    grid = grid or build_grid(config, device)
    model = network(config, device, lower)
    model.load_state_dict(weights)
    model.eval()
    infer = make_inference_step(model, config, **grid.lattice)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    out = infer(_on(batch, device), grid.statics, gen)
    return {k: float(v) for k, v in out.items()}
