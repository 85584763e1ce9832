"""The benchmark's plain DISN reference (``benchmark/reference/nn/disn.py``,
``steps_disn.py``) against the port and against the JAX package, at the
tiny DISN size (VGG width 0.05, code 64, images 32, maps 16), res 4,
batch 2; the port's DISN spans; and the reference's imports.

The step is held as ``test_torch_disn_step`` holds the port against the
JAX package: every loss term at rtol 1e-4, each parameter's gradient in
norm at rtol 1e-3 (the DISN decoders' 512-wide ReLUs have inputs down to
1e-8, inside a float32 difference of the two forwards, so one point's
ReLU can switch and move a single entry), with the normal term's
per-face fields in float32 on both sides (``test_torch_lap``)."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from benchmark import harness
from benchmark.reference import steps, steps_disn
from benchmark.reference.losses import surface as ref_surface
from benchmark.reference.nn import disn as ref_disn
from benchmark.reference.train.step import forward_losses as ref_forward
from benchmark.weights import seeded_state
from deftet_tpu.nn import disn as jax_disn
from deftet_tpu_torch.config import TrainConfig
from deftet_tpu_torch.convert import load_flax_variables
from deftet_tpu_torch.losses import surface as port_surface
from deftet_tpu_torch.train import Engine
from deftet_tpu_torch.utils.timing import RECORDER

REPO = Path(__file__).resolve().parent.parent
SMALL = {"res": 4, "batch_size": 2, "n_point": 128, "num_sample_points": 128,
         "occ_sample": 64, "per_face_samples": 4,
         "encoder_blocks": "8,1,8;16,1,4", "gcn_hidden": "16,8",
         "pos_mlp_hidden": "8,0.2,8", "occ_mlp_hidden": "16,0.2,8"}
PARAMS = {"n_shapes": 4, "level": 1, "n_surface": 128, "occ_res": 16,
          "n_views": 2, "image_res": 40, "proof_steps": 1}
ENC = dict(width=0.05, image_encoding_dim=64, image_size=32,
           local_feature_size=16)
DISN_SPANS = ("disn.encode", "disn.sample", "disn.decode")


def _fields(**over):
    base = json.loads((REPO / "benchmark" / "configs" /
                       "deftet_disn50.json").read_text())
    base = {k: v for k, v in base.items() if k not in harness.META_KEYS}
    return {**base, **SMALL, **tp.DISN_TINY, "seed": 5, **over}


def _inputs(fields, seed=5):
    ctx = harness.Context(
        name="tiny.disn", cell={"params": PARAMS}, config=fields, seed=seed,
        seconds=0.0, trace=False, device="cpu", root=harness.ROOT,
        t_start=0.0)
    drv = harness.driver("disn_train")
    return drv, drv.inputs(ctx)


@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("experiments"))


@pytest.fixture(scope="module")
def setup(logdir):
    fields = _fields(logdir=logdir)
    drv, inp = _inputs(fields)
    weights = seeded_state(steps_disn.state_shapes(inp["config"]), 5, "cpu")
    return fields, inp, weights


def _port(fields, weights, batch):
    names = {f for f in TrainConfig.__dataclass_fields__}
    engine = Engine(TrainConfig(**{k: v for k, v in fields.items()
                                   if k in names}), device="cpu")
    engine.model.load_state_dict(weights)
    params = dict(engine.model.named_parameters())
    total, terms = engine.forward_losses(engine._prep_batch(batch))
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return engine, total, terms, dict(zip(params, grads))


def _reference(config, weights, batch):
    model = steps_disn.network(config, "cpu")
    model.load_state_dict(weights)
    grid = steps.build_grid(config, "cpu")
    gen = torch.Generator().manual_seed(config.seed + 1)
    params = dict(model.named_parameters())
    total, terms = ref_forward(model, steps._on(batch, "cpu"), grid.statics,
                               config, gen, train=True, **grid.lattice)
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return total, terms, dict(zip(params, grads))


def test_port_step_matches_benchmark_reference(setup, monkeypatch):
    fields, inp, weights = setup
    monkeypatch.setattr(port_surface, "NORMAL_FIELD_DTYPE", torch.float32)
    monkeypatch.setattr(ref_surface, "NORMAL_FIELD_DTYPE", torch.float32)
    batch = inp["proof"][0]
    assert batch["imgs"].shape == (2, 40, 40, 3)
    assert batch["cam_matrix"].shape == (2, 4, 4)
    _, total, terms, grads = _port(fields, weights, batch)
    r_total, r_terms, r_grads = _reference(inp["config"], weights, batch)
    assert set(terms) == set(r_terms)
    for k, want in r_terms.items():
        np.testing.assert_allclose(float(terms[k].detach()),
                                   float(want.detach()), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total.detach()),
                               float(r_total.detach()), rtol=1e-4)
    assert list(grads) == list(r_grads) == steps_disn.parameter_names(
        inp["config"])
    for k, want in r_grads.items():
        got = grads[k]
        assert (got is None) == (want is None), k
        if want is not None:
            err = float(torch.linalg.vector_norm(got - want))
            assert err <= 1e-3 * float(torch.linalg.vector_norm(want)) \
                + 1e-5 * want.numel()**0.5, k


def _images(n=2, size=64, seed=2):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, size, size, 3)).astype(np.float32)


def test_reference_encoder_matches_jax():
    """The reference's VGG-16 encoder against the JAX package's
    ``DISNEncoder``: the global code and the five resized maps."""
    imgs = _images()
    enc = jax_disn.DISNEncoder(**ENC)
    variables = jax.jit(enc.init)(jax.random.PRNGKey(0), jnp.asarray(imgs))
    code, maps = jax.jit(enc.apply)(variables, jnp.asarray(imgs))
    ref = ref_disn.Encoder(ENC["image_encoding_dim"], ENC["image_size"],
                           ENC["local_feature_size"], ENC["width"])
    load_flax_variables(ref, jax.device_get(variables))
    with torch.no_grad():
        r_code, r_maps = ref(torch.tensor(imgs))
    np.testing.assert_allclose(r_code.numpy(), np.asarray(code), rtol=1e-5,
                               atol=1e-6)
    assert len(r_maps) == 5
    assert sum(m.shape[1] for m in r_maps) == ref_disn.local_dim(
        ENC["width"])
    for rm, m in zip(r_maps, maps):
        np.testing.assert_allclose(rm.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(m), rtol=1e-5, atol=1e-6)


def test_reference_head_matches_jax():
    """A reference head (global + local branches) against the JAX
    package's ``DISNDecoder``, and its projection and sampler against the
    JAX package's ``sample_image_features``."""
    rng = np.random.default_rng(4)
    q = rng.uniform(-0.5, 0.5, (2, 50, 3)).astype(np.float32)
    code = rng.normal(size=(2, 64)).astype(np.float32)
    local = rng.normal(size=(2, 50, 81)).astype(np.float32)
    dec = jax_disn.DISNDecoder(out_features=3)
    variables = jax.jit(dec.init)(jax.random.PRNGKey(1), q, code, local)
    want = jax.jit(dec.apply)(variables, q, code, local)
    head = ref_disn.Head(64, 81, 3)
    load_flax_variables(head, jax.device_get(variables))
    with torch.no_grad():
        got = head(torch.tensor(q), torch.tensor(code), torch.tensor(local))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)

    maps = [rng.normal(size=(2, 8, 8, c)).astype(np.float32)
            for c in (3, 5)]
    cam = np.stack([np.eye(4, dtype=np.float32)] * 2)
    cam[:, 3, 2] = 2.0  # depth 2: every point in front
    want = jax_disn.sample_image_features([jnp.asarray(m) for m in maps],
                                          jnp.asarray(q), jnp.asarray(cam))
    got = ref_disn.sample([torch.tensor(m).permute(0, 3, 1, 2)
                           for m in maps],
                          ref_disn.project(torch.tensor(q),
                                           torch.tensor(cam)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _spans_of_one_update(fields):
    """The spans of one ``train_epoch`` update: {id: (name, parent)}."""
    drv, inp = _inputs(fields)
    names = {f for f in TrainConfig.__dataclass_fields__}
    engine = Engine(TrainConfig(**{k: v for k, v in fields.items()
                                   if k in names}), device="cpu")
    RECORDER.reset()
    engine.train_epoch(iter(inp["proof"]))
    return {s["id"]: (s["name"], s["parent"])
            for s in RECORDER.export()["spans"]}


def test_disn_spans_nest_under_step_forward(logdir):
    """One DISN update opens ``disn.encode`` once and ``disn.sample`` and
    ``disn.decode`` once per head, each inside ``step.forward``; the
    point path opens none of them."""
    spans = _spans_of_one_update(_fields(logdir=logdir))

    def ancestors(sid):
        out = []
        while sid in spans:
            sid = spans[sid][1]
            if sid in spans:
                out.append(spans[sid][0])
        return out

    counts = {n: 0 for n in DISN_SPANS}
    for sid, (name, _) in spans.items():
        if name in counts:
            counts[name] += 1
            assert "step.forward" in ancestors(sid), name
    assert counts == {"disn.encode": 1, "disn.sample": 2, "disn.decode": 2}
    point = _spans_of_one_update(_fields(use_disn=False, logdir=logdir))
    assert "step.forward" in {n for n, _ in point.values()}
    assert not {n for n, _ in point.values()} & set(DISN_SPANS)


def test_benchmark_reference_imports_neither_jax_nor_port():
    code = ("import sys, benchmark.reference.steps_disn, benchmark.images;"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'deftet_tpu', 'deftet_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
