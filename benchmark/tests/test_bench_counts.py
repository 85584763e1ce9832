"""The frozen counts reproduce chip_smoke.py's bounds at the cells'
shapes, and the model-FLOP count is what torch's FLOP counter counts."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, harness
from benchmark.tests import tiny


def test_k1_and_k2_bounds_at_the_cells_shapes():
    ms, by = counts.stencil_bound(4, 51, 256, 2)
    assert (round(ms, 4), by) == (0.1623, "bytes")
    pairs, ms, by = counts.nearest_bound(4, 100_000, 100_000)
    assert (pairs, round(ms, 4), by) == (4 * 10**10, 4.7761, "operations")
    _, cfg, _ = harness.load_cell("res50.eval")
    cfg = {**cfg, "eval_points": 100_000}
    assert counts.eval_nearest_bound_ms(cfg, 4) == pytest.approx(8 * ms)
    _, cfg, _ = harness.load_cell("res50.train")
    lap = counts.stencil_bound(4, 51, 3, 4)[0]
    assert counts.train_stencil_bound_ms(cfg) == pytest.approx(
        8 * 0.16234898507 + 2 * lap)


@pytest.mark.parametrize("two_encoders", [True, False])
def test_model_flops_equal_the_flop_counter(two_encoders):
    from deftet_tpu_torch.nn import DeformableTetNetwork
    from deftet_tpu_torch.nn.gcn import VertexAdjacency
    from deftet_tpu_torch.tetgrid import build_tet_grid
    from deftet_tpu_torch.train.statics import build_grid_statics

    cfg = {**tiny.TINY, "use_two_encoder": two_encoders, "res": 3}
    st = build_grid_statics(cfg["res"], grid=build_tet_grid(cfg["res"]))
    blocks = tuple(tuple(int(x) for x in g.split(","))
                   for g in cfg["encoder_blocks"].split(";"))
    gen = torch.Generator().manual_seed(0)
    model = DeformableTetNetwork(
        blocks=blocks, use_two_encoder=two_encoders,
        gcn_hidden=(16, 8), pos_mlp_hidden=(8, 0.2, 8),
        occ_mlp_hidden=(16, 0.2, 8), generator=gen)
    b, k = 2, 37
    pts = torch.rand(b, cfg["n_point"], 3, generator=gen) - 0.5
    adj = VertexAdjacency(st.vert_adj_idx, st.vert_adj_mask, st.vert_degree)
    init = st.init_pos_nx3[None].expand(b, -1, -1)
    centers = torch.rand(b, k, 3, generator=gen) - 0.5
    with FlopCounterMode(display=False) as fc:
        pyr_pos, pyr_occ = model.encode(pts, False)
        model.decode_pos(init, pyr_pos, None, False, adj, 0)
        model.decode_occ(centers, pyr_occ, False)
    assert fc.get_total_flops() == counts.forward_flops(cfg, b, k)
