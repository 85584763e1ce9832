"""PointNet sampling and grouping (torch port of deftet_tpu/ops/sampling.py):
furthest point sampling and gather, ball query, grouping, 3-nearest-
neighbour inverse-distance interpolation and ``logits_mask``.

No path of either package calls these; they complete the inventory, so
PVCNN-family point models can be built on the port.  Plain PyTorch, as
the JAX versions are XLA code.  The forms that decide indices are the
JAX package's, so the indices agree exactly:

* ball query and 3-NN rank by the expanded ‖a‖² + ‖b‖² − 2 a·b distance,
  clamped at 0; FPS by the direct difference, the first index on an
  argmax tie;
* ball query keeps the CUDA kernel's scan order: the first U in-radius
  points fill the slots, the rest repeat the first, an empty ball gives 0;
* 3-NN sends gradient to the features only; ties go to the lower index
  (a stable sort, as ``lax.top_k``);
* ``logits_mask`` takes its random priorities as an injected draw
  (``priorities``), or draws them from a ``torch.Generator``.

Layouts are channels-last: coordinates (B, N, 3), features (B, N, C).
"""

from __future__ import annotations

import torch

__all__ = [
    "gather_points",
    "furthest_point_sample",
    "ball_query",
    "grouping",
    "three_nn_interpolate",
    "logits_mask",
]


def _pairwise_sqdist(a_bxmx3: torch.Tensor, b_bxnx3: torch.Tensor):
    """(B, M, N) squared distances, ‖a‖² + ‖b‖² − 2 a·b clamped at 0."""
    d = (torch.sum(a_bxmx3 * a_bxmx3, dim=-1)[:, :, None]
         + torch.sum(b_bxnx3 * b_bxnx3, dim=-1)[:, None, :]
         - 2.0 * torch.einsum("bmc,bnc->bmn", a_bxmx3, b_bxnx3))
    return torch.clamp(d, min=0.0)


def gather_points(features_bxnxc: torch.Tensor,
                  idx_bxm: torch.Tensor) -> torch.Tensor:
    """(B, M, C) features at the given indices (the backward scatter-adds)."""
    idx = idx_bxm.long()[:, :, None].expand(-1, -1, features_bxnxc.shape[-1])
    return torch.gather(features_bxnxc, 1, idx)


@torch.no_grad()
def furthest_point_sample(coords_bxnx3: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """(B, M) int32 indices: start at point 0, then repeatedly the point
    farthest from the chosen set (the first on a tie).  M sequential
    steps of O(N) work each."""
    b, n, _ = coords_bxnx3.shape
    m = int(num_samples)
    dev = coords_bxnx3.device
    idx = torch.zeros((b, m), dtype=torch.int32, device=dev)
    mind = torch.full((b, n), float("inf"), device=dev)
    rows = torch.arange(b, device=dev)
    last = coords_bxnx3[:, 0]
    for i in range(1, m):
        d = torch.sum((coords_bxnx3 - last[:, None, :]) ** 2, dim=-1)
        mind = torch.minimum(mind, d)
        nxt = torch.argmax(mind, dim=-1)
        idx[:, i] = nxt.to(torch.int32)
        last = coords_bxnx3[rows, nxt]
    return idx


@torch.no_grad()
def ball_query(centers_bxmx3: torch.Tensor, points_bxnx3: torch.Tensor,
               radius: float, num_neighbors: int) -> torch.Tensor:
    """(B, M, U) int32 indices of up to U points within ``radius`` of each
    center, in scan order (see the module doc)."""
    u = int(num_neighbors)
    n = points_bxnx3.shape[1]
    d2 = _pairwise_sqdist(centers_bxmx3, points_bxnx3)
    inside = d2 < radius * radius
    pos = torch.arange(n, device=d2.device)
    # in-radius points keyed by position, the others pushed past N: the U
    # smallest keys are the first U in-radius points in scan order
    key = torch.where(inside, pos, pos + n)
    idx = torch.topk(key, u, dim=-1, largest=False, sorted=True).indices
    cnt = torch.clamp(inside.sum(dim=-1), max=u)
    slot = torch.arange(u, device=d2.device)
    idx = torch.where(slot < cnt[..., None], idx, idx[..., :1])
    return torch.where(cnt[..., None] > 0, idx, 0).to(torch.int32)


def grouping(features_bxnxc: torch.Tensor,
             idx_bxmxu: torch.Tensor) -> torch.Tensor:
    """(B, M, U, C) neighbour features (the backward scatter-adds)."""
    b, m, u = idx_bxmxu.shape
    out = gather_points(features_bxnxc, idx_bxmxu.reshape(b, m * u))
    return out.reshape(b, m, u, features_bxnxc.shape[-1])


def three_nn_interpolate(points_bxnx3: torch.Tensor,
                         centers_bxmx3: torch.Tensor,
                         centers_feat_bxmxc: torch.Tensor) -> torch.Tensor:
    """(B, N, C) features interpolated from the 3 nearest centers with
    weights ∝ the product of the other two squared distances (clamped to
    [1e-10, 1e10]); the gradient reaches ``centers_feat`` only."""
    with torch.no_grad():
        d2 = _pairwise_sqdist(points_bxnx3, centers_bxmx3)
        d2, idx = torch.sort(d2, dim=-1, stable=True)
        d = torch.clamp(d2[..., :3], 1e-10, 1e10)
        idx = idx[..., :3]
        d0, d1, d2_ = d[..., 0], d[..., 1], d[..., 2]
        denom = 1.0 / (d0 * d1 + d0 * d2_ + d1 * d2_)
        w = torch.stack([d1 * d2_, d0 * d2_, d0 * d1], dim=-1) \
            * denom[..., None]
    feats = grouping(centers_feat_bxmxc, idx)  # (B, N, 3, C)
    return torch.sum(feats * w[..., None], dim=2)


def logits_mask(coords_bxnx3: torch.Tensor, logits_bxnx2: torch.Tensor,
                num_points_per_object: int,
                priorities: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
    """M points per example where the class-1 logit wins, centered on the
    masked mean: a random choice without replacement among at least M
    candidates, every candidate then the wrap-around repeat among fewer,
    index 0 when there is none.  ``priorities`` (B, N) uniforms order the
    candidates (drawn from ``generator`` when not given).

    Returns (selected (B, M, 3), masked mean (B, 3), mask (B, N) bool)."""
    b, n, _ = coords_bxnx3.shape
    m = int(num_points_per_object)
    dev = coords_bxnx3.device
    mask = logits_bxnx2[..., 0] < logits_bxnx2[..., 1]
    cnt = mask.sum(dim=-1)
    masked = coords_bxnx3 * mask[..., None]
    mean = torch.sum(masked, dim=1) / torch.clamp(cnt, min=1)[:, None]
    if priorities is None:
        priorities = torch.rand((b, n), generator=generator, device=dev)
    pri = torch.where(mask, priorities, float("inf"))
    order = torch.argsort(pri, dim=-1, stable=True)
    slot = torch.arange(m, device=dev).expand(b, m)
    rank = torch.where(cnt[:, None] > 0,
                       slot % torch.clamp(cnt, min=1)[:, None], 0)
    sel_idx = torch.gather(order, 1, rank)
    sel_idx = torch.where(cnt[:, None] > 0, sel_idx, 0)
    selected = gather_points(masked - mean[:, None, :], sel_idx)
    return selected, mean, mask
