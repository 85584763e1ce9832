"""The grid-probe kernel (``csrc/grid_probe.cu``) on the card against its
plain version, bit for bit.  It needs an NVIDIA card and skips without
one; it imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_grid_probe_kernel.py
"""

import pytest
import torch


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On the card: the kernel against the plain version on chip_smoke's
    cases (points on voxel faces, on and past the r - 1 border and
    outside [-0.5, 0.5] on every side; the default pyramid and odd, even
    and single-voxel levels; n not a multiple of a tile and n = 0; B = 1
    and 4; strided and expanded points and levels, a level off 16-byte
    alignment; -0.0 products first in the corner sums), in bfloat16 and
    float32, with and without xyz."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke

    chip_smoke.check_grid_probe_cases("cuda")
