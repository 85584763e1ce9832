"""The 3D-supervised train step: ``forward_losses``, the optimizer, one
update (with gradient accumulation and rematerialization) and the
validation step (torch port of deftet_tpu/train/step.py, lattice path).

Random draws happen where the JAX step draws them — input noise, the
occupancy center subsample (with replacement), dropout, the chamfer
barycentrics — but from a ``torch.Generator``.  ``draws`` injects any of
them (``noise``, ``center_idx``, ``bary_u``, ``bary_v``) so a test can
hand both frameworks the same numbers; with ``grad_accum > 1`` it is a
list with one such dict per microbatch.

loss = lambda_occ * occ + lambda_def * (area * volume + edge * edge +
       lap * lap + surf * surface_align + delta * delta + normal * normal
       + amips * amips + chamfer * surf_chamfer)
"""

from __future__ import annotations

from typing import Dict, Sequence

import math

import torch

from .. import remat
from ..config import TrainConfig
from ..evals.metrics import iou
from ..losses.geometry import (
    amips_energy_soa,
    delta_loss,
    edge_length_soa,
    gather_tet_soa,
    gather_tet_soa_lattice,
    tet_centers_soa,
    volume_variance_soa,
)
from ..losses.surface import occupancy_bce, surface_align_losses
from ..nn.gcn import LatticeAdjacency
from ..ops.check_sign import check_sign
from ..ops.lattice import lattice_boundary_info
from ..ops.voxelize import occupancy_from_grid_soa
from .statics import GridStatics


class ClippedAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)) on a list of
    tensors, updated in place.

    Clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
    (not torch's ``max_norm / (norm + 1e-6)``).  Adam is optax's default:
    bias-corrected moments, eps 1e-8 outside the square root.  With
    ``decay_steps > 0`` the lr follows optax.cosine_decay_schedule: update
    n (0-based) uses ``lr * ((1 - a) * (1 + cos(pi * min(n, D) / D)) / 2
    + a)`` with ``a = final_scale``; otherwise it is constant.
    """

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 max_norm: float | None = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 decay_steps: int = 0, final_scale: float = 0.1):
        self.params = list(params)
        self.lr, self.max_norm = lr, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.decay_steps, self.final_scale = decay_steps, final_scale
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def lr_at(self, n: int) -> float:
        """The lr of update ``n`` (0-based)."""
        if self.decay_steps <= 0:
            return self.lr
        d = self.decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(n, d) / d))
        a = self.final_scale
        return self.lr * ((1.0 - a) * cosine + a)

    def state_dict(self) -> dict:
        return {"mu": [m.detach().clone() for m in self.mu],
                "nu": [v.detach().clone() for v in self.nu],
                "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
                dst.copy_(src)
        self.count = int(state["count"])

    def clip(self, grads):
        if self.max_norm is None:
            return list(grads)
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_norm
        return [torch.where(keep, g, (g / g_norm) * self.max_norm)
                for g in grads]

    @torch.no_grad()
    def step(self, grads) -> None:
        grads = self.clip(grads)
        lr = self.lr_at(self.count)
        self.count += 1
        c1 = 1.0 - self.b1**self.count
        c2 = 1.0 - self.b2**self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(-lr * update)


def make_optimizer(config: TrainConfig, params) -> ClippedAdam:
    clip = config.grad_norm_clip if config.grad_norm else None
    return ClippedAdam(params, config.lr, clip,
                       decay_steps=max(config.lr_decay_steps, 0),
                       final_scale=config.lr_final_scale)


def _center_subsample_idx(generator, n_tets: int, k: int, device):
    """k random tet indices, with replacement; arange when k >= n_tets."""
    if k >= n_tets:
        return torch.arange(n_tets, device=device)
    return torch.randint(0, n_tets, (k,), generator=generator, device=device)


def forward_losses(
    model,
    batch: Dict[str, torch.Tensor],
    statics: GridStatics,
    config: TrainConfig,
    generator: torch.Generator | None = None,
    train: bool = True,
    lattice_offsets=None,
    tet_lattice=None,
    face_lattice=None,
    draws: Dict[str, torch.Tensor] | None = None,
):
    """Full forward.  Returns (total, terms); in training the model's
    BatchNorm running statistics are updated in place."""
    if lattice_offsets is None or tet_lattice is None or face_lattice is None:
        raise NotImplementedError("only the regular-lattice step is ported")
    draws = draws or {}
    surface = batch["surface_points"]
    b = surface.shape[0]
    device = surface.device

    inp = surface[:, : config.n_point]
    if config.add_input_noise:
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(inp.shape, generator=generator, device=device)
        inp = inp + config.input_noise * noise

    init_pos = statics.init_pos_nx3[None].expand(b, -1, -1)
    mask_src = (statics.pos_mask_nx3 if config.use_init_pos_mask
                else torch.ones_like(statics.pos_mask_nx3))
    pos_mask = mask_src[None].expand(b, -1, -1)
    n_tets = statics.n_tets
    center_idx = draws.get("center_idx")
    if center_idx is None:
        center_idx = _center_subsample_idx(
            generator, n_tets, min(config.occ_sample, n_tets), device)

    adj = LatticeAdjacency.from_degree(lattice_offsets, statics.vert_degree)
    pyr_pos, pyr_occ = model.encode(inp, train)
    pred_delta, tet_pos, _ = model.decode_pos(
        init_pos, pyr_pos, pos_mask, train, adj, config.res, generator)
    sub_soa = gather_tet_soa(tet_pos, statics.tet_tx4[center_idx])
    sub_centers = torch.stack(tet_centers_soa(sub_soa), dim=-1)
    logits = model.decode_occ(sub_centers, pyr_occ, train, generator)

    soa = gather_tet_soa_lattice(tet_pos, config.res, tet_lattice)
    cx, cy, cz = tet_centers_soa(soa)

    # GT occupancy at the deformed centers, no gradient: one read of the
    # occupancy texture, or the +z ray parity over the GT mesh; kept, not
    # recomputed, by a rematerialized backward
    if config.occ_source == "grid" and "occ_grid" in batch:
        center_occ = remat.saved("center_occ", lambda: occupancy_from_grid_soa(
            batch["occ_grid"], cx.detach(), cy.detach(), cz.detach(),
            interp=config.occ_grid_interp))
    else:
        centers = torch.stack([cx, cy, cz], dim=-1).detach()
        center_occ = remat.saved("center_occ", lambda: check_sign(
            batch["verts"], batch["faces"], centers,
            n_valid_faces=batch["n_faces"]))

    b_zero = torch.zeros((b,), device=device)
    use_def = config.lambda_def > 0.0

    def want(lam: float) -> bool:
        return use_def and lam != 0.0

    vol = (volume_variance_soa(soa, pow=config.pow)
           if want(config.lambda_area) else b_zero)
    amips = (amips_energy_soa(soa, statics.rest_inverse_tx3x3)
             if want(config.lambda_amips) else b_zero)
    edge = (edge_length_soa(soa, pow=config.pow)
            if want(config.lambda_edge) else b_zero)
    lap = (torch.sum((adj.matmul(pred_delta) - pred_delta) ** 2,
                     dim=(-1, -2))
           if want(config.lambda_lap) else b_zero)
    d_loss = delta_loss(pred_delta) if want(config.lambda_delta) else b_zero

    boundary_overflow = None
    if (want(config.lambda_surf) or want(config.lambda_surf_chamfer)
            or want(config.lambda_normal)):
        if statics.face_fx3.shape[0] != 12 * face_lattice.res**3:
            raise NotImplementedError("statics are not class-major lattice")
        boundary_mask, boundary_sign = lattice_boundary_info(
            center_occ, face_lattice)
        budget = config.resolved_max_boundary_faces()
        bary = None
        if "bary_u" in draws:
            bary = (draws["bary_u"], draws["bary_v"])
        chamfer, analytic, normal = surface_align_losses(
            tet_pos, statics.face_fx3, boundary_mask, boundary_sign,
            surface[:, : config.num_sample_points].contiguous(), face_lattice,
            per_face_samples=config.per_face_samples,
            max_boundary_faces=budget,
            with_chamfer=want(config.lambda_surf_chamfer),
            with_analytic=want(config.lambda_surf),
            with_normal=want(config.lambda_normal),
            samples_cap=config.chamfer_samples_cap,
            generator=generator,
            bary=bary,
        )
        # mean boundary-face count past the compaction budget: > 0 means
        # the surface terms saw the first-k (class-major) subset this step
        n_boundary = torch.sum(boundary_mask > 0, dim=1)
        boundary_overflow = torch.clamp(n_boundary - budget, min=0).to(
            torch.float32).mean()
    else:
        chamfer = analytic = normal = b_zero

    gt_occ = center_occ[:, center_idx]
    occ = occupancy_bce(logits, gt_occ)

    terms = {
        "volume": vol.mean(),
        "edge": edge.mean(),
        "lap": lap.mean(),
        "surface_align": analytic.mean(),
        "delta": d_loss.mean(),
        "normal": normal.mean(),
        "amips": amips.mean(),
        "surf_chamfer": chamfer.mean(),
        "occ": occ,
    }
    deform = (
        terms["volume"] * config.lambda_area
        + terms["edge"] * config.lambda_edge
        + terms["lap"] * config.lambda_lap
        + terms["surface_align"] * config.lambda_surf
        + terms["delta"] * config.lambda_delta
        + terms["normal"] * config.lambda_normal
        + terms["amips"] * config.lambda_amips
        + terms["surf_chamfer"] * config.lambda_surf_chamfer
    )
    total = torch.zeros((), device=device)
    if config.lambda_occ > 0.0:
        total = total + occ * config.lambda_occ
    if config.lambda_def > 0.0 and not config.finetune_occ:
        total = total + deform * config.lambda_def
    terms["occ_iou"] = iou(logits, gt_occ, thresh=config.iou_logit_threshold)
    if boundary_overflow is not None:
        terms["boundary_overflow"] = boundary_overflow
    return total, terms


def _microbatches(batch, accum: int):
    b = batch["surface_points"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} microbatches")
    m = b // accum
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(accum)]


def train_step(model, optimizer: ClippedAdam, batch, statics: GridStatics,
               config: TrainConfig, generator: torch.Generator | None = None,
               lattice_offsets=None, tet_lattice=None, face_lattice=None,
               draws=None):
    """One optimizer update; returns the detached loss terms + "total".

    With ``grad_accum = a > 1`` the batch runs as ``a`` sequential
    microbatches: BatchNorm statistics carry from one to the next, the
    gradients are summed then divided by ``a``, the terms averaged, and
    clipping and Adam apply once.  With ``remat`` each microbatch's
    forward is recomputed in its backward (``remat.checkpoint``)."""
    accum = max(int(config.grad_accum), 1)
    micro = _microbatches(batch, accum) if accum > 1 else [batch]
    if draws is None or isinstance(draws, dict):
        draws = [draws] * accum
    if len(draws) != accum:
        raise ValueError(f"{len(draws)} draws for {accum} microbatches")
    g_sum, t_sum = None, None
    for mb, mb_draws in zip(micro, draws):
        def loss(mb=mb, mb_draws=mb_draws):
            return forward_losses(
                model, mb, statics, config, generator, train=True,
                lattice_offsets=lattice_offsets, tet_lattice=tet_lattice,
                face_lattice=face_lattice, draws=mb_draws)

        if config.remat:
            total, terms = remat.checkpoint(loss, generator, model)
        else:
            total, terms = loss()
        grads = torch.autograd.grad(total, optimizer.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(optimizer.params, grads)]
        terms = {k: v.detach() for k, v in terms.items()}
        terms["total"] = total.detach()
        if g_sum is None:
            g_sum, t_sum = grads, terms
        else:
            g_sum = [a + g for a, g in zip(g_sum, grads)]
            t_sum = {k: t_sum[k] + v for k, v in terms.items()}
    if accum > 1:
        g_sum = [g / accum for g in g_sum]
        t_sum = {k: v / accum for k, v in t_sum.items()}
    optimizer.step(g_sum)
    return t_sum


@torch.no_grad()
def eval_step(model, batch, statics: GridStatics, config: TrainConfig,
              generator: torch.Generator | None = None, lattice_offsets=None,
              tet_lattice=None, face_lattice=None, draws=None):
    """Validation: the loss terms, "total" and ``occ_iou`` without
    gradients, BatchNorm reading its running statistics."""
    total, terms = forward_losses(
        model, batch, statics, config, generator, train=False,
        lattice_offsets=lattice_offsets, tet_lattice=tet_lattice,
        face_lattice=face_lattice, draws=draws)
    terms["total"] = total
    return terms
