"""The traced window's reduction on a hand-made trace."""

import pytest

from benchmark.trace import Trace


def _trace():
    device = [("k1", 0.1, 0.3), ("k2", 0.2, 0.4), ("Memcpy HtoD", 0.6, 0.7)]
    host = [("cudaLaunchKernel", 0.05, 0.06), ("cudaStreamSynchronize",
                                                0.35, 0.65)]
    return Trace(device, host, 1.0, steps=2)


def test_busy_time_is_the_union_of_device_intervals():
    tr = _trace()
    assert tr.busy_intervals() == [[0.1, 0.4], [0.6, 0.7]]
    assert tr.busy_s == pytest.approx(0.4)
    assert [k[0] for k in tr.kernels()] == ["k1", "k2"]
    assert tr.seconds_of("k") == pytest.approx(0.4)


def test_idle_gaps_are_named_by_the_host():
    gaps = _trace().idle_gaps()
    assert [round(g, 6) for _, g in gaps] == [0.3, 0.2, 0.1]
    assert [n for n, _ in gaps] == ["after cudaStreamSynchronize",
                                    "cudaStreamSynchronize",
                                    "(no host event before it)"]
    assert _trace().device_ops(2) == [["k2", pytest.approx(0.2)],
                                      ["k1", pytest.approx(0.2)]]
