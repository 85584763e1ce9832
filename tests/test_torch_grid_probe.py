"""``ops.grid_probe`` on the CPU: its plain path against the ATen probe
and concatenation it replaces, the occupancy decoder's two paths (the
rows in one ``grid_probe`` call where no graph is needed, the
differentiable probe otherwise) giving the same logits, and gradients
still reaching the pyramid and the centres.  The kernel itself is held to
the plain path on the card (``test_torch_grid_probe_kernel.py``)."""

import pytest
import torch

from deftet_tpu_torch.nn import DeformableTetNetwork, sample_grid_features
from deftet_tpu_torch.ops.grid_probe import grid_probe, needs_graph

BLOCKS = ((8, 1, 8), (16, 2, 4), (12, 1, 2))  # (C, blocks, r): 4 levels


def _inputs(seed=0, b=2, n=50):
    gen = torch.Generator().manual_seed(seed)
    pts = torch.rand((b, n, 3), generator=gen) * 1.4 - 0.7
    pyr = [torch.randn((b, r, r, r, c), generator=gen)
           for c, nb, r in BLOCKS for _ in range(nb)]
    return pts, pyr


def _bits(x):
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


def _network(dtype):
    torch.manual_seed(0)
    model = DeformableTetNetwork(blocks=BLOCKS, gcn_hidden=(8,),
                                 pos_mlp_hidden=(8,),
                                 occ_mlp_hidden=(16, 0.2, 8), dtype=dtype,
                                 generator=torch.Generator().manual_seed(1))
    return model.eval()


def plain_equals_cat():
    pts, pyr = _inputs()
    for dt in (torch.bfloat16, torch.float32):
        for app in (True, False):
            with torch.no_grad():
                got = grid_probe(pts, pyr, app, dt)
                feat = sample_grid_features(pts, pyr)
                if app:
                    feat = torch.cat([feat, pts], dim=-1)
            want = feat.to(dt)
            assert got.dtype == dt and got.shape == want.shape
            assert torch.equal(_bits(got), _bits(want)), (dt, app)


def decode_occ_no_grad_equals_grad():
    for dtype in (torch.bfloat16, None):
        model = _network(dtype)
        pts, pyr = _inputs(1)
        with torch.no_grad():
            fast = model.decode_occ(pts, pyr, train=False)
        pyr = [p.requires_grad_() for p in pyr]
        graph = model.decode_occ(pts, pyr, train=False)
        assert graph.requires_grad and not fast.requires_grad
        assert torch.equal(_bits(fast), _bits(graph.detach())), dtype


def gradient_reaches_pyramid_and_centres():
    model = _network(torch.bfloat16)
    pts, pyr = _inputs(2)
    pts.requires_grad_()
    pyr = [p.requires_grad_() for p in pyr]
    assert needs_graph(pts, pyr)
    model.decode_occ(pts, pyr, train=False).square().sum().backward()
    assert pts.grad is not None and pts.grad.abs().sum() > 0
    for level in pyr:
        assert level.grad is not None and level.grad.abs().sum() > 0


def raises_where_a_graph_is_needed():
    pts, pyr = _inputs(3)
    pyr[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        grid_probe(pts, pyr, True, torch.float32)
    with torch.no_grad():
        assert not needs_graph(pts, pyr)
        grid_probe(pts, pyr, True, torch.float32)


def card_cases_hold_on_the_cpu():
    """chip_smoke's kernel cases build here and test what they say: the
    -0.0 level's columns come out +0.0 (the sum starts from +0.0), and
    the face points sit on whole voxel coordinates."""
    import chip_smoke

    cases = {name: (pts, pyr)
             for name, pts, pyr in chip_smoke.grid_probe_cases("cpu")}
    assert set(cases) >= {"faces_border_outside", "odd_levels_b1", "empty",
                          "strided_views", "expanded_points",
                          "negative_zero"}
    pts, pyr = cases["negative_zero"]
    with torch.no_grad():
        rows = grid_probe(pts, pyr, True, torch.float32)
    zeros = rows[..., :pyr[0].shape[-1]]
    assert torch.equal(_bits(zeros), torch.zeros_like(_bits(zeros)))
    pts, pyr = cases["faces_border_outside"]
    coords = (pts + 0.5) * 32
    assert (coords == coords.round()).float().mean() > 0.3
    assert (pts.abs() > 0.5).any(dim=(0, 1)).all()
    for name, (pts, pyr) in cases.items():
        with torch.no_grad():
            rows = grid_probe(pts, pyr, True, torch.bfloat16)
        assert rows.shape == pts.shape[:2] + (
            sum(p.shape[-1] for p in pyr) + 3,), name


CASES = {f.__name__: f for f in (
    plain_equals_cat, decode_occ_no_grad_equals_grad,
    gradient_reaches_pyramid_and_centres, raises_where_a_graph_is_needed,
    card_cases_hold_on_the_cpu)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_probe_cpu(case):
    CASES[case]()
