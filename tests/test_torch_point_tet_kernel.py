"""The point-in-tet kernel (``csrc/point_tet.cu``) on the card against the
plain scan, index for index.  It needs an NVIDIA card and skips without
one; it imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_point_tet_kernel.py
"""

import pytest
import torch


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On the card: the kernel against the plain scan on chip_smoke's
    adversarial cases (the undeformed grid at lattice vertices, edge, face
    and cell centres; queries on the boundary, just and far outside it,
    NaN and infinite; flat tets, a tet across the domain, batch elements
    deformed apart; an empty result), the corners as strided views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke

    chip_smoke.check_point_tet_edge_cases("cuda")
