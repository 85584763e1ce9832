"""``tests/torch_compare_campaign.py``, the reduced two-package campaign,
at the tests' tiny size: ``init`` draws the JAX engine's initial weights
and builds the dataset, ``run`` trains each package from those weights on
the same batches, and ``compare`` reads both runs' curves."""

import json
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_compare_campaign as campaign  # noqa: E402

SIZES = ["--res", "4", "--batch_size", "2", "--n_shapes", "6",
         "--n_point", "128", "--epochs", "2", "--val_every", "1", "--tiny"]


def _curves(out: Path, package: str) -> dict:
    (metrics,) = (out / "runs").glob(f"*{package}_s0/metrics.jsonl")
    return campaign._curves(metrics)


def _check_engines_hold_init(out, init):
    """``run``'s engines start from the ``init`` weights: the JAX engine's
    variables are those arrays, the port's state is their conversion
    (which a fresh engine's random weights are not)."""
    import jax
    import torch

    from deftet_tpu_torch.config import TrainConfig
    from deftet_tpu_torch.convert import load_flax_variables
    from deftet_tpu_torch.train import Engine

    def args(package):
        return campaign.parse_args(["run", *out, "--package", package,
                                    "--seed", "0", *SIZES])

    state = campaign.engine_for(args("jax")).state
    for name in ("params", "batch_stats"):
        got, want = (jax.tree_util.tree_leaves(t) for t in
                     (getattr(state, name), init[name]))
        assert len(got) == len(want) > 0
        assert all(np.array_equal(np.asarray(g), w)
                   for g, w in zip(got, want)), name

    port = campaign.engine_for(args("torch")).model.state_dict()
    fresh = Engine(TrainConfig(**campaign.config_kwargs(args("torch"), 0)),
                   device="cpu").model
    assert any(not torch.equal(port[k], v)
               for k, v in fresh.state_dict().items())
    load_flax_variables(fresh, init)
    assert all(torch.equal(port[k], v) for k, v in fresh.state_dict().items())


def test_compare_campaign_runs_both_packages(tmp_path, capsys):
    out = ["--out", str(tmp_path)]
    assert campaign.main(["init", *out, *SIZES]) == 0
    init = np.load(tmp_path / "init.npy", allow_pickle=True).item()
    assert set(init) == {"params", "batch_stats"}
    _check_engines_hold_init(out, init)
    for package in ("jax", "torch"):
        assert campaign.main(["run", *out, "--package", package,
                              "--seed", "0", *SIZES]) == 0
    capsys.readouterr()
    assert campaign.main(["compare", *out]) == 0
    report = json.loads(capsys.readouterr().out)

    jax_c, torch_c = _curves(tmp_path, "jax"), _curves(tmp_path, "torch")
    # the same series at the same steps: 2 epochs of 2 steps (4 of the 6
    # shapes train), a validation after each
    assert set(jax_c) == set(torch_c) >= {
        f"{kind}.{name}" for kind, names in campaign.SERIES.items()
        for name in names}
    for series in jax_c:
        assert sorted(jax_c[series]) == sorted(torch_c[series]), series
    (row,) = report["mean_abs_difference"].values()
    assert list(report["mean_abs_difference"]) == ["jax_s0 vs torch_s0"]
    assert set(row) == set(jax_c)
    assert all(math.isfinite(v) for v in row.values())
    assert set(report["last"]) == {"jax_s0", "torch_s0"}
