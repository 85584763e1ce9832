"""The DISN image branch's res-4 step against the JAX
package's (every loss term, every parameter gradient), float32, with and
without remat, and remat's gradients against none's (test_torch_lap holds
the checks)."""

import pytest

import test_torch_lap as tl


@pytest.fixture(scope="module")
def reference():
    return tl.step_reference("disn")


@pytest.mark.parametrize("remat_on", [False, True])
def test_step_matches_reference(reference, remat_on):
    tl.check_step(reference, remat_on)


def test_remat_gradients_equal_none(reference):
    tl.check_remat(reference)
