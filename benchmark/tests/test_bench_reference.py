"""The plain reference against the port's CPU path at a tiny size: the
train cell's first updates and the eval cell's inference step, run end
to end through the harness (the port on the CPU runs its kernels' plain
versions), agree."""

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.eval"])
def test_reference_matches_the_port_on_the_cpu(tmp_path, cell):
    root = tiny.make_root(tmp_path)
    out = harness.execute(tiny.context(root, cell), tiny.spec_of(root))
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, c in out["checks"].items():
        assert c["value"] <= 1e-6, (name, c)
