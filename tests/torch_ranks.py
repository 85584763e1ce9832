"""What each rank runs in the data-parallel tests (imports neither JAX nor
the JAX package: every rank is a fresh process on the port alone).

A case is a dict: ``config`` (TrainConfig fields), ``batch`` (the global
numpy batch), optionally ``draws`` (injected, at the global shape),
``state`` (a state dict to start from), ``val_batch`` (a global batch
for ``validate`` and ``validate_inference``), ``fault`` (BatchNorm
without its all-reduce), ``float32_normal_fields`` (the normal term's
face fields in float32, as test_torch_lap sets them against JAX) and
``restore`` (a checkpoint saved after the step, then restored).
``run_case`` gives the same record in one process (``world`` None), so
the tests compare like with like.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from deftet_tpu_torch.config import TrainConfig
from deftet_tpu_torch.losses import surface
from deftet_tpu_torch.nn import layers
from deftet_tpu_torch.train import Engine


def run_case(case, world=None):
    """{"terms", "grads", "buffers", "val", "val_inference"} of one train
    step of ``case``, or None on a rank that takes no part in it."""
    cfg = TrainConfig(**case["config"])
    engine = Engine(cfg, device="cpu" if world is None else world.device,
                    world=world)
    if case.get("state") is not None:
        engine.model.load_state_dict(case["state"])
    if engine.idle:
        return None
    grads = []
    step = engine.optimizer.step

    def record(g):
        grads.append([t.detach().cpu().clone() for t in g])
        step(g)

    engine.optimizer.step = record
    out = {}
    if case.get("val_batch") is not None:
        # before the update: Adam moves a parameter whose gradient is
        # rounding noise by ~lr either way, and the two runs' parameters
        # would part there
        out["val"] = engine.validate([case["val_batch"]])
        out["val_inference"] = engine.validate_inference([case["val_batch"]])
    fault = (mock.patch.object(layers, "global_moments", lambda m, e: (m, e))
             if case.get("fault") else contextlib.nullcontext())
    fields = (mock.patch.object(surface, "NORMAL_FIELD_DTYPE", torch.float32)
              if case.get("float32_normal_fields")
              else contextlib.nullcontext())
    with fault, fields:
        terms = engine.train_step(engine._prep_batch(case["batch"]),
                                  draws=case.get("draws"))
    out.update(terms={k: float(v) for k, v in terms.items()},
               grads=grads[0],
               buffers={k: v.detach().cpu().clone()
                        for k, v in engine.model.named_buffers()})
    if case.get("restore"):
        # rank 0 writes the checkpoint; every rank's restore gets it back
        # over any change made since
        engine.save()
        kept = {k: v.clone() for k, v in engine.model.state_dict().items()}
        with torch.no_grad():
            for p in engine.model.parameters():
                p.add_(1.0)
        engine.optimizer.count = 0
        engine.restore("last")
        now = engine.model.state_dict()
        out["restored"] = (all(torch.equal(v, now[k]) for k, v in kept.items())
                           and engine.optimizer.count == 1)
    return out


def parity_ranks(world, cases):
    """Every case on this rank, in order (a rank past the divisor clamp
    gives None for a case)."""
    return {name: run_case(case, world) for name, case in cases.items()}
