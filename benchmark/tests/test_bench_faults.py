"""The comparison fails a broken timed path: the tiny cells, held to the
real cells' limits, come out correct when sound and not correct with an
optimizer step that leaves the state unchanged, with half of each batch
left out, and with an answer altered where the inference step produces
it; and the float8 control fails them too."""

import pytest

from benchmark import compare, harness
from benchmark.reference import steps as ref
from benchmark.tests import tiny

LIMITS = {"tiny.train": harness.load_cell("res50.train")[0]["limits"],
          "tiny.eval": harness.load_cell("res50.eval")[0]["limits"]}


def _correct(tmp_path, cell):
    root = tiny.make_root(tmp_path, LIMITS)
    return harness.execute(tiny.context(root, cell), tiny.spec_of(root))


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.eval"])
def test_sound_runs_are_correct(tmp_path, cell):
    assert _correct(tmp_path, cell)["correct"]


def test_state_left_unchanged(tmp_path, monkeypatch):
    from deftet_tpu_torch.train import step

    monkeypatch.setattr(step.ClippedAdam, "step", lambda self, grads: None)
    assert not _correct(tmp_path, "tiny.train")["correct"]


def test_half_the_batch_left_out(tmp_path, monkeypatch):
    from deftet_tpu_torch.train.engine import Engine

    whole = Engine.train_step

    def half(self, batch, draws=None):
        rows = batch["surface_points"].shape[0] // 2
        return whole(self, {k: v[:rows] for k, v in batch.items()}, draws)

    monkeypatch.setattr(Engine, "train_step", half)
    assert not _correct(tmp_path, "tiny.train")["correct"]


@pytest.mark.parametrize("key", ["occ_iou", "n_boundary", "chamfer"])
def test_an_answer_altered(tmp_path, monkeypatch, key):
    from deftet_tpu_torch.evals import harness as port_harness

    make = port_harness.make_inference_step

    def altered(*args, **kwargs):
        infer = make(*args, **kwargs)

        def run(*a, **k):
            out = infer(*a, **k)
            out[key] = out[key] * 1.1 + 0.01
            return out
        return run

    monkeypatch.setattr(port_harness, "make_inference_step", altered)
    assert not _correct(tmp_path, "tiny.eval")["correct"]


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.eval"])
def test_the_float8_control_fails(tmp_path, cell):
    root = tiny.make_root(tmp_path, LIMITS)
    ctx = tiny.context(root, cell)
    drv = harness.driver(ctx.cell["traffic"], root)
    inp = drv.inputs(ctx)
    weights = drv.weights_for(inp, ctx)
    cfg = inp["config"]
    if cell == "tiny.train":
        base = ref.train_readings(cfg, weights, inp["proof"], "cpu")
        low = ref.train_readings(cfg, weights, inp["proof"], "cpu",
                                 lower=True)
        numbers = compare.train_numbers(low, base)
    else:
        base = ref.inference(cfg, weights, inp["batch"], "cpu")
        low = ref.inference(cfg, weights, inp["batch"], "cpu", lower=True)
        numbers = compare.eval_numbers([low], base)
    assert not harness.passed(harness.checks_of(numbers, LIMITS[cell]))
