"""Evaluation traffic: ``cli eval``'s loop, a closed loop of
``Engine._prep_batch`` then ``Engine.inference_step()`` on one batch of
held-out shapes, each step's metrics read to the host, the surface draws
from a generator seeded with the configuration's seed at every step, as
``cli eval`` seeds it.

Set-up makes the shapes and the weights from the seed; untrained
weights predict every tet occupied, an empty surface, so the occupancy
classifier's bias is shifted until about ``occupied_share`` of the tets
are predicted occupied (worked out by the reference's forward on these
inputs, ``reference.steps.occupancy_bias_shift``).  One inference step
warms every shape; the window then runs steps for ``--seconds`` (or,
traced, ``trace_steps`` steps).  After the window the engine is freed
and the plain reference runs one inference step on the same inputs and
weights; every answer of the window is held against it
(``compare.eval_numbers``).  An answer with no predicted surface, or a
shape of the reference's with none, fails.

Params: ``n_shapes``, ``held_out``, ``level``, ``n_surface``, ``n_sdf``,
``occ_res``, ``eval_points``, ``occupied_share``, ``trace_steps``.
"""

from __future__ import annotations

import math
import time


def inputs(ctx) -> dict:
    """The cell's configuration (the run's ``fields`` and the reference's
    ``config``) and its one batch of shapes (host numpy)."""
    from benchmark import traffic
    from benchmark.reference import steps as ref

    fields = {**ctx.config, "seed": ctx.seed,
              "eval_points": int(ctx.params["eval_points"])}
    return {"fields": fields, "config": ref.make_config(fields),
            "batch": traffic.stack(traffic.make_records(ctx.params,
                                                        ctx.seed))}


def weights_for(inp: dict, ctx) -> dict:
    """The run's weights on the device (``weights.py``), the occupancy
    classifier's bias shifted to predict ``occupied_share`` of the tets
    occupied."""
    from benchmark import session
    from benchmark.reference import steps as ref

    weights = session.weights(inp["config"], ctx.seed, ctx.device)
    weights[ref.CLASSIFIER_BIAS] += ref.occupancy_bias_shift(
        inp["config"], weights, inp["batch"], ctx.device,
        float(ctx.params["occupied_share"]))
    return weights


def run(ctx) -> dict:
    import torch

    from benchmark import compare, session
    from benchmark.reference import steps as ref
    from benchmark.trace import traced

    p = ctx.params
    inp = inputs(ctx)
    fields, config, batch = inp["fields"], inp["config"], inp["batch"]

    with session.scratch_dir() as logdir:
        engine = session.program_engine(fields, ctx.device, logdir)
        weights = weights_for(inp, ctx)
        engine.model.load_state_dict(weights)
        host_weights = {k: v.cpu() for k, v in weights.items()}
        del weights
        session.free(ctx.device)
        infer = engine.inference_step()
        dev = engine.device

        def step():
            prepped = engine._prep_batch(batch)
            gen = torch.Generator(device=dev).manual_seed(config.seed)
            return {k: float(v) for k, v in
                    infer(prepped, engine.statics, gen).items()}

        answers = [step()]  # the warm-up, one answer among the others
        session.sync(ctx.device)

        from deftet_tpu_torch.ops import _cuda

        _cuda.reset_launch_counts()
        session.reset_peak(ctx.device)
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        deadline = t0 + ctx.seconds
        window = []
        trace = None
        if ctx.trace:
            with traced(int(p["trace_steps"]),
                        lambda: session.sync(ctx.device)) as box:
                for _ in range(int(p["trace_steps"])):
                    window.append(step())
            trace = box[0]
        else:
            while time.perf_counter() < deadline:
                window.append(step())
        session.sync(ctx.device)
        window_s = time.perf_counter() - t0
        peak = session.peak_bytes(ctx.device)
        launches = dict(_cuda.launch_counts)
        del engine, infer
        session.free(ctx.device)

    refr = ref.inference(config, host_weights, batch, ctx.device)
    answers += window
    numbers = compare.eval_numbers(answers, refr)
    failed = sum(1 for a in window
                 if not compare.finite(a.values()) or a["n_boundary"] <= 0)
    if refr["n_boundary_min"] <= 0 or not math.isfinite(
            refr["n_boundary_min"]):
        failed = len(window)
    return {"numbers": numbers, "attempted": len(window), "failed": failed,
            "setup_s": setup_s,
            "window": {"steps": len(window),
                       "shapes": len(window) * len(batch["surface_points"]),
                       "seconds": window_s, "peak_bytes": peak},
            "trace": trace, "launch_counts": launches,
            "device": session.device_info(ctx.device, peak),
            "config": config}
