"""DISN training traffic: single-view reconstruction, a closed loop of
optimizer updates through ``Engine.train_epoch`` with the DISN image
network (``use_disn``), fed an iterator of host numpy batches that carry
each shape's surface points and occupancy texture (``traffic``) and one
rendered view of it with its camera (``images``).

Set-up makes the shapes, renders ``n_views`` views of each from cameras
drawn from the seed, makes the weights from the seed, builds the engine
and drives it through ``proof_steps`` updates, which also warm every
shape the window uses.  Each pass reshuffles the shapes and draws one
view a shape from the seed.  The window then runs that engine on the
batches that follow, for ``--seconds`` (or, traced, ``trace_steps``
updates).  After the window the engine is freed and the plain DISN
reference (``reference/steps_disn.py``) follows the proof updates from
the same weights, batches and generator seed; the numbers compared are
``compare.train_numbers``.

Params: ``n_shapes``, ``level``, ``n_surface``, ``occ_res``,
``n_views``, ``image_res``, ``proof_steps``, ``trace_steps``.
"""

from __future__ import annotations

import math
import time

import numpy as np


def _batches(records, imgs, cams, order, seed, traffic):
    rng = np.random.default_rng([seed, 6007])
    for pass_ in order:
        view = rng.integers(0, imgs.shape[1], size=len(records))
        for idx in pass_:
            yield traffic.stack([{**records[i], "imgs": imgs[i, view[i]],
                                  "cam_matrix": cams[i, view[i]]}
                                 for i in map(int, idx)])


def inputs(ctx) -> dict:
    """The cell's configuration (the run's ``fields`` and the reference's
    ``config``), its shapes and views, their batch order and the stream
    of batches; ``proof``: the first ``proof_steps`` batches."""
    from benchmark import images, traffic
    from benchmark.reference import steps as ref

    p = ctx.params
    fields = {**ctx.config, "seed": ctx.seed}
    config = ref.make_config(fields)
    b = config.batch_size
    records = traffic.make_records(p, ctx.seed)
    imgs, cams = images.views(p, ctx.seed)
    n_passes = 10_000 // max(len(records) // b, 1) + 1
    order = traffic.batch_order(len(records), b, ctx.seed, n_passes)
    stream = _batches(records, imgs, cams, order, ctx.seed, traffic)
    proof = [next(stream) for _ in range(int(p["proof_steps"]))]
    return {"fields": fields, "config": config, "per_pass": len(order[0]),
            "stream": stream, "proof": proof}


def weights_for(inp: dict, ctx) -> dict:
    """The run's weights on the device (``weights.py``), named as the DISN
    network names them."""
    from benchmark.reference import steps_disn
    from benchmark.weights import seeded_state

    return seeded_state(steps_disn.state_shapes(inp["config"]), ctx.seed,
                        ctx.device)


def state_bytes(engine) -> int:
    """Bytes of the parameters and of the optimizer's two moments."""
    opt = engine.optimizer
    return sum(t.numel() * t.element_size() for t in
               [*engine.model.parameters(), *opt.mu, *opt.nu])


def run(ctx) -> dict:
    from benchmark import compare, session
    from benchmark.reference import steps_disn as ref
    from benchmark.reference.steps import leaf_norms
    from benchmark.trace import traced

    p = ctx.params
    inp = inputs(ctx)
    fields, config, proof = inp["fields"], inp["config"], inp["proof"]
    stream, per_pass = inp["stream"], inp["per_pass"]
    b = config.batch_size
    names = ref.parameter_names(config)

    with session.scratch_dir() as logdir:
        engine = session.program_engine(fields, ctx.device, logdir)
        weights = weights_for(inp, ctx)
        engine.model.load_state_dict(weights)
        start = {k: weights[k].detach().clone() for k in names}
        host_weights = {k: v.cpu() for k, v in weights.items()}
        del weights

        prog = {"loss": []}
        for i, batch in enumerate(proof):
            means = engine.train_epoch(iter([batch]))
            prog["loss"].append(means["total"])
            if i == 0:
                prog["terms"] = dict(means)
                prog["grad"] = leaf_norms(
                    [m / (1.0 - engine.optimizer.b1)
                     for m in engine.optimizer.mu])
        params = dict(engine.model.named_parameters())
        prog["change"] = leaf_norms(
            [params[k].detach() - start[k] for k in names])
        del start
        session.sync(ctx.device)

        # the window: epochs of the rest of the stream, each up to the end
        # of its pass, until the time (or the traced step count) is up
        done = len(proof)
        steps, failed = 0, 0
        if ctx.trace:
            limit = int(p["trace_steps"])

            def more():
                return steps < limit
        else:
            def more():
                return time.perf_counter() < deadline

        def epoch():
            nonlocal steps, done
            while more():
                yield next(stream)
                steps += 1
                done += 1
                if done % per_pass == 0:
                    return

        def loop():
            nonlocal failed
            while more():
                means = engine.train_epoch(epoch())
                if not math.isfinite(means.get("total", 0.0)):
                    failed += 1

        session.reset_peak(ctx.device)
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        deadline = t0 + ctx.seconds
        trace = None
        if ctx.trace:
            with traced(int(p["trace_steps"]),
                        lambda: session.sync(ctx.device)) as box:
                loop()
            trace = box[0]
        else:
            loop()
        session.sync(ctx.device)
        window_s = time.perf_counter() - t0
        peak = session.peak_bytes(ctx.device)
        held = state_bytes(engine)
        del engine, params
        session.free(ctx.device)

    refr = ref.train_readings(config, host_weights, proof, ctx.device,
                              steps=len(proof))
    numbers = compare.train_numbers(prog, refr)
    unsteady = compare.train_unsteady(prog, refr)
    if not compare.finite(prog["loss"]):
        failed += 1
    return {"numbers": numbers, "unsteady": unsteady,
            "attempted": steps, "failed": failed,
            "setup_s": setup_s, "state_bytes": held,
            "window": {"steps": steps, "shapes": steps * b,
                       "seconds": window_s, "peak_bytes": peak},
            "trace": trace, "device": session.device_info(ctx.device, peak),
            "config": config}
