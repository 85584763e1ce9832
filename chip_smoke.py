"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on lines of its own:

1. header  — torch / CUDA versions and the card's name and power limit;
2. build   — the four CUDA kernels (csrc/*.cu), compiled anew, in parallel;
3. parity  — the small configuration in float32: one forward + backward on
   the CPU (plain PyTorch versions of the kernels) and one on the card
   (the kernels), from the same parameters and injected draws;
   parity_train — two res-4 steps with grad_accum=2, remat and the cosine
   lr, card against CPU, and on the card remat's gradients against none;
   parity_eval — the res-4 inference step, card against CPU;
4. main    — the full-width res-50 / batch-4 train step (bench.py's
   configuration, bf16) through ``Engine``: one warm-up step and five
   timed steps, launch counts per kernel read around them;
   eval — that engine's full-inference evaluation at 100,000 points a
   side (validate, validate_inference, timed inference steps);
5. kernels — each kernel on the inputs the main path gave it, held
   against its plain version on the card and timed beside its bound and
   the nearest single PyTorch call (every K1 variant of the step, with
   their launch-weighted total per step), K2 also at the eval metrics'
   shape (100,000 against 100,000 points), then K1-K3 at the inference
   step's inputs;
6. paper_step — bench.py's paper recipe (res 70, batch 8, grad_accum=2)
   with and without remat, and K1-K3 at its inputs; then the kernels'
   edge cases;
7. cli     — ``python -m deftet_tpu_torch.cli train`` then ``eval`` in
   subprocesses, and a restored engine's step against the uninterrupted
   one's;
8. the 2D-supervision renderer: render_parity (a small scene's mov and
   fix stages and one frame, card against CPU); render (the full-width
   protocol scene through run_pipeline: res-40 grid, k 300, carves,
   carve_and_subdivide at the real tet budget, four test-PSNR
   evaluations); render_subdiv (the bundled carved snapshot split 1->8,
   20 steps and a frame); render_split (one step and one frame split into
   their parts); kernel_raster_hit (the hit kernel against its plain
   version at each path's inputs and at edge cases, timed against its
   bound); render_cli (``cli render`` in a subprocess);
9. the ``{"kernels": [...]}`` line (one entry per kernel and path), then
   the result line ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero and prints no result.
It needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# NVIDIA H100 SXM published peaks (dense): HBM3 bytes/s and float32
# CUDA-core FLOP/s.  Every kernel here computes in float32.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# Kernel launches per full-width train step (see PERF.md): the stencil
# runs 4x in the GCN (C = 256) and once for the Laplacian term (C = 3),
# each with its backward; chamfer and the analytic term launch once each.
LAUNCHES_PER_STEP = {"stencil": 10, "nearest": 1, "tri_argmin": 1,
                     "raster_hit": 0}
TIMED_STEPS = 5

KERNEL_INFO = {
    "stencil": ("deftet_tpu_torch/csrc/stencil.cu",
                "deftet_tpu/ops/stencil_pallas.py:46"),
    "nearest": ("deftet_tpu_torch/csrc/nearest.cu",
                "deftet_tpu/ops/nearest_pallas.py:33"),
    "tri_argmin": ("deftet_tpu_torch/csrc/tri_argmin.cu",
                   "deftet_tpu/ops/tri_distance_pallas.py:32"),
    # replaces XLA code, not a Pallas kernel: the hit pass of the JAX
    # rasterizer (a scan merging a (pixels, k + chunk) top-k per chunk)
    "raster_hit": ("deftet_tpu_torch/csrc/raster_hit.cu",
                   "deftet_tpu/render/raster.py:89"),
}


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


# ------------------------------------------------------------------ phases
def header():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("header", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    print(smi, flush=True)
    return smi


def build():
    from deftet_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_all(force=True)
    wall = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log["ptxas"].splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in _cuda.build_log.items()
    }
    say("build", seconds=round(wall, 3),
        per_kernel={k: round(v["seconds"], 3)
                    for k, v in _cuda.build_log.items()},
        ptxas=ptxas)


def bench_batch(cfg, level=2, occ_res=64):
    """bench.py's batch (bench.py:302-317): uniform surface points and the
    occupancy texture of ``random_shape(0)``, as numpy arrays."""
    from deftet_tpu_torch.data.pipeline import occupancy_grid
    from deftet_tpu_torch.data.shapes import random_shape

    verts, faces = random_shape(0, level=level)
    rng = np.random.default_rng(0)
    occ = occupancy_grid(verts, faces, occ_res)
    return {
        "surface_points": rng.uniform(
            -0.4, 0.4, (cfg.batch_size, cfg.num_sample_points, 3)
        ).astype(np.float32),
        "occ_grid": np.tile(occ[None], (cfg.batch_size, 1, 1, 1)),
    }


def parity(devices=("cpu", "cuda")):
    """CPU (plain versions) vs card (kernels) on the small configuration,
    float32 with TF32 off.  Tolerances: terms rtol 1e-4 / atol 1e-6 and
    gradients rtol 1e-3 / atol 1e-5, as the CPU tests hold the port to the
    JAX package (sums run in another order on the card)."""
    from deftet_tpu_torch.config import TrainConfig
    from deftet_tpu_torch.train import Engine

    cfg = TrainConfig(
        res=4, batch_size=2, encoder_blocks="8,1,8;16,1,4",
        gcn_hidden="16,8", pos_mlp_hidden="8", occ_mlp_hidden="16,8",
        n_point=256, num_sample_points=256, per_face_samples=4,
        occ_sample=128, precision="f32",
    )
    rng = np.random.default_rng(11)
    k = cfg.resolved_max_boundary_faces()
    draws = {
        "noise": rng.normal(size=(cfg.batch_size, cfg.n_point, 3)),
        "center_idx": rng.integers(0, 6 * cfg.res**3, cfg.occ_sample),
        "bary_u": rng.uniform(size=(cfg.batch_size, k, cfg.per_face_samples,
                                    1)),
        "bary_v": rng.uniform(size=(cfg.batch_size, k, cfg.per_face_samples,
                                    1)),
    }
    batch = bench_batch(cfg, level=1, occ_res=16)
    results = []
    state = None
    for device in devices:
        engine = Engine(cfg, device=device)
        if state is None:
            state = {k_: v.clone() for k_, v in
                     engine.model.state_dict().items()}
        engine.model.load_state_dict(state)
        dev_draws = {
            k_: torch.tensor(v, device=device,
                             dtype=torch.int64 if k_ == "center_idx"
                             else torch.float32)
            for k_, v in draws.items()
        }
        total, terms = engine.forward_losses(engine._prep_batch(batch),
                                             train=True, draws=dev_draws)
        params = dict(engine.model.named_parameters())
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        results.append((
            {k_: float(v.detach()) for k_, v in terms.items()}
            | {"total": float(total.detach())},
            {n: (torch.zeros_like(p) if g is None else g).cpu()
             for (n, p), g in zip(params.items(), grads)},
        ))
    (t_cpu, g_cpu), (t_gpu, g_gpu) = results
    worst_term = max(abs(t_gpu[k_] - v) / (1e-6 + 1e-4 * abs(v))
                     for k_, v in t_cpu.items())
    worst_grad = max(
        float(torch.max((g_gpu[n] - g).abs() / (1e-5 + 1e-3 * g.abs())))
        for n, g in g_cpu.items()
    )
    say("parity", terms_cuda=t_gpu, terms_cpu=t_cpu,
        worst_term_ratio=worst_term, worst_grad_ratio=worst_grad)
    if not worst_term <= 1.0 or not worst_grad <= 1.0:
        raise AssertionError(
            f"CPU vs CUDA step parity failed: term ratio {worst_term}, "
            f"grad ratio {worst_grad} (must be <= 1)")


def variant_key(name, args):
    """A K1 call's variant (dtype, channels, direction); K2 and K3 have
    one variant per path."""
    if name == "stencil":
        x, n, offsets, scale, in_scale = args
        return (name, str(x.dtype).split(".")[-1], x.shape[-1],
                "backward" if in_scale is not None else "forward")
    return (name,)


def shape_key(name, args):
    """variant_key, with K2's and K3's calls told apart by their shapes."""
    if name == "stencil":
        return variant_key(name, args)
    return (name, tuple(args[0].shape), tuple(args[1].shape))


class Recorder:
    """Wraps each kernel's launch function to keep a copy of the inputs
    of its first launch per key (``key_fn``) during a path, and to count
    each key's launches."""

    def __init__(self, key_fn=variant_key, mods=None):
        from deftet_tpu_torch.ops import nearest, stencil, tri_distance

        self.mods = mods or {"stencil": (stencil, "_stencil_cuda"),
                             "nearest": (nearest, "_nearest_cuda"),
                             "tri_argmin": (tri_distance, "_tri_argmin_cuda")}
        self.orig = {k: getattr(m, a) for k, (m, a) in self.mods.items()}
        self.key_fn = key_fn
        self.inputs = {}
        self.counts = {}

    def _wrap(self, name):
        orig = self.orig[name]

        def launch(*args):
            key = self.key_fn(name, args)
            self.counts[key] = self.counts.get(key, 0) + 1
            if key not in self.inputs:
                self.inputs[key] = tuple(
                    a.detach().clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
            return orig(*args)
        return launch

    def __enter__(self):
        for name, (mod, attr) in self.mods.items():
            setattr(mod, attr, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.mods.items():
            setattr(mod, attr, self.orig[name])


def bench_config():
    """bench.py's configuration (bench.py:262-271): res 50, batch 4,
    default widths and the default bf16 precision."""
    from deftet_tpu_torch.config import TrainConfig

    return TrainConfig(res=50, batch_size=4, n_point=5000,
                       num_sample_points=5000, occ_sample=10000,
                       per_face_samples=20)


def main_path(config, device="cuda", occ_res=64):
    """The train step through the port's Engine: one warm-up and
    TIMED_STEPS timed steps, on bench.py's batch."""
    from deftet_tpu_torch.ops import _cuda
    from deftet_tpu_torch.train import Engine

    t0 = time.perf_counter()
    engine = Engine(config, device=device)
    t_engine = time.perf_counter() - t0
    b = config.batch_size
    batch = engine._prep_batch(bench_batch(config, occ_res=occ_res))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    step_s, per_step = [], []
    with Recorder() as rec:
        for step in range(1 + TIMED_STEPS):
            _cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            terms = engine.train_step(batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts = dict(_cuda.launch_counts)
            terms = {k: float(v) for k, v in terms.items()}
            say("main_step", step=step, warmup=step == 0, seconds=dt,
                launches=counts, terms=terms)
            bad = [k for k, v in terms.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"non-finite loss terms: {bad}")
            if counts != LAUNCHES_PER_STEP:
                raise AssertionError(
                    f"launches {counts} != expected {LAUNCHES_PER_STEP}")
            per_step.append(counts)
            if step:
                step_s.append(dt)
    launches = {k: sum(c[k] for c in per_step) for k in LAUNCHES_PER_STEP}
    say("main", config=f"res={config.res} batch={b} {config.precision}",
        engine_init_s=t_engine, steps=TIMED_STEPS,
        median_step_s=statistics.median(step_s), step_s=step_s,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        launches_total=launches, launches_per_step=LAUNCHES_PER_STEP)
    per_variant = {k: c / (1 + TIMED_STEPS) for k, c in rec.counts.items()}
    return rec.inputs, launches, per_variant, engine


# ------------------------------------------------------------ kernel checks
def stencil_bound(x, n, offsets, scale, in_scale):
    """(bound ms, bound by) of one K1 call: x read and out written once,
    each scale read once; one add per in-lattice neighbour read and one
    multiply per element for each scale."""
    b, v, c = x.shape
    ijk = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    reads = sum(int(np.all((ijk + o >= 0) & (ijk + o < n), -1).sum())
                for o in np.asarray(offsets))
    n_scales = (scale is not None) + (in_scale is not None)
    n_flops = b * c * (reads + n_scales * v)
    n_bytes = 2 * x.numel() * x.element_size() + n_scales * v * 4
    return bound_ms(n_bytes, n_flops)


def check_stencil_launches(x, n, offsets, inv_deg):
    """The device work of StencilMean's forward and backward on the GCN's
    inputs, read by torch.profiler: each is one launch of the tiled K1
    kernel and no elementwise pass."""
    from torch.profiler import ProfilerActivity, profile

    from deftet_tpu_torch.ops import stencil

    def kernels_of(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        return out, {e.key: e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA}

    xg = x.detach().requires_grad_()
    y, fwd = kernels_of(
        lambda: stencil.lattice_neighbor_mean(xg, inv_deg, n, offsets))
    g = torch.ones_like(y)
    _, bwd = kernels_of(lambda: torch.autograd.grad(y, xg, g))
    for way, kernels in (("forward", fwd), ("backward", bwd)):
        if sum(kernels.values()) != 1 or not all(
                "stencil_kernel_tiled" in k for k in kernels):
            raise AssertionError(
                f"stencil {way} ran {kernels}, not one tiled K1 launch")
    return {"forward": fwd, "backward": bwd}


def stencil_library(x, n, offsets, scale, in_scale):
    """The library yardstick of one K1 call: a depthwise conv3d with the
    binary stencil on the channels-last view of x (no copy), the source
    scale applied to x before it and the output scale after it."""
    import torch.nn.functional as F

    b, v, c = x.shape
    w = torch.zeros((c, 1, 3, 3, 3), dtype=x.dtype, device=x.device)
    for di, dj, dk in offsets:
        w[:, 0, 1 + di, 1 + dj, 1 + dk] = 1
    x5 = x.view(b, n, n, n, c).permute(0, 4, 1, 2, 3)

    def library():
        src = x5
        if in_scale is not None:
            src = (x5.float() * in_scale.view(1, 1, n, n, n)).to(x.dtype)
        y = F.conv3d(src, w, padding=1, groups=c)
        if scale is not None:
            y = (y.float() * scale.view(1, 1, n, n, n)).to(x.dtype)
        return y

    def as_x(y):
        return y.permute(0, 2, 3, 4, 1).reshape(b, v, c)

    return library, as_x


def check_stencil(inputs, per_step, label="kernel_stencil",
                  profile_launches=True):
    """Every K1 variant of a path, plus the bf16 GCN inputs in f32 (the
    precision="f32" path), against the plain version: equal bit for bit
    (same f32 sums in the same order, same roundings).  Each of the
    path's variants is timed beside its bound and the depthwise conv3d
    that computes the same function; their times weighted by launches
    per step give K1's device time per step."""
    from deftet_tpu_torch.ops import stencil

    cases = {k: v for k, v in inputs.items() if k[0] == "stencil"}
    for way in ("forward", "backward"):
        key = ("stencil", "bfloat16", 256, way)
        if key in cases:
            x, *rest = cases[key]
            cases[("stencil", "float32", 256, way)] = (x.float(), *rest)
    report = {}
    step_ms = 0.0
    for key, (x, n, offsets, scale, in_scale) in sorted(cases.items(),
                                                        key=str):
        got = stencil.stencil_sum(x, n, offsets, scale, in_scale)
        ref = stencil.stencil_sum_plain(x, n, offsets, scale, in_scale)
        err = float((got.float() - ref.float()).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"stencil {key}: max err {err}, not equal")
        row = {"shape": list(x.shape), "max_abs_err": err}
        if key in per_step:
            ms = cuda_ms(lambda: stencil.stencil_sum(x, n, offsets, scale,
                                                     in_scale), 20)
            bms, by = stencil_bound(x, n, offsets, scale, in_scale)
            library, as_x = stencil_library(x, n, offsets, scale, in_scale)
            lib_err = float((as_x(library()).float() - ref.float()).abs()
                            .max())
            row.update(ms=ms, bound_ms=bms, bound_by=by,
                       launches_per_step=per_step[key],
                       library_ms=cuda_ms(library, 10),
                       library_max_abs_err=lib_err)
            step_ms += ms * per_step[key]
        report["/".join(map(str, key[1:]))] = row

    # the kernels line reports the dominant call: the GCN forward, C = 256
    x, n, offsets, scale, _ = cases[("stencil", "bfloat16", 256, "forward")]
    profiled = None
    if profile_launches:
        inv_deg = cases[("stencil", "bfloat16", 256, "backward")][4]
        profiled = check_stencil_launches(x, n, offsets, inv_deg)
    fwd = report["bfloat16/256/forward"]
    plain_ms = cuda_ms(
        lambda: stencil.stencil_sum_plain(x, n, offsets, scale), 3)
    worst = max(r["max_abs_err"] for r in report.values())
    say(label, variants=report, step_ms=step_ms, profiled_kernels=profiled)
    return dict(ms=fwd["ms"], plain_ms=plain_ms, bound_ms=fwd["bound_ms"],
                bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
                max_abs_err=worst, step_ms=step_ms,
                shape=f"x {list(x.shape)} {str(x.dtype).split('.')[-1]}")


def nearest_bound(q, r, n_valid, n_queries):
    """(pairs, bound ms, bound by) of one K2 call: 8 flops (3 sub, 3 mul,
    2 add) per scanned pair, i.e. per valid reference and query in a live
    512-query tile; both clouds read and both outputs written once."""
    from deftet_tpu_torch.ops import nearest

    b, p, _ = q.shape
    tile = nearest.QUERY_TILE
    live = torch.clamp((n_queries + tile - 1) // tile * tile, min=0, max=p)
    valid = torch.clamp(n_valid, min=0, max=r.shape[1])
    pairs = int((live.long() * valid.long()).sum())
    n_bytes = q.numel() * 4 + r.numel() * 4 + 8 * b * p
    return (pairs, *bound_ms(n_bytes, 8 * pairs))


def check_nearest_exact(label, q, r, n_valid, n_queries):
    """K2 against the plain version on the card: the same indices and the
    same distances, bit for bit (both take the direct difference summed
    x, y, z in order, every product and sum rounded, no FMA)."""
    from deftet_tpu_torch.ops import nearest

    d, i = nearest.nearest_neighbor(q, r, n_valid, n_queries)
    d_ref, i_ref = nearest.nearest_neighbor_plain(q, r, n_valid, n_queries)
    if not (torch.equal(i, i_ref) and torch.equal(d, d_ref)):
        raise AssertionError(
            f"nearest {label}: {int((i != i_ref).sum())} indices and "
            f"{int((d != d_ref).sum())} distances differ from the plain "
            "version")
    return d, i, float((d - d_ref).abs().max()) if d.numel() else 0.0


def check_nearest(args, label="kernel_nearest", reps=20):
    """K2 on one call's inputs of a path, exact against the plain version,
    timed beside its bound, its no-FMA ceiling and cdist + min (where
    cdist's (B, P, M) matrix fits in 20 GB)."""
    from deftet_tpu_torch.ops import nearest

    q, r, n_valid, n_queries = args
    err = check_nearest_exact(label, q, r, n_valid, n_queries)[2]
    ms = cuda_ms(lambda: nearest.nearest_neighbor(q, r, n_valid, n_queries),
                 reps)
    plain_ms = cuda_ms(
        lambda: nearest.nearest_neighbor_plain(q, r, n_valid, n_queries),
        max(1, reps // 10))
    pairs, bms, by = nearest_bound(q, r, n_valid, n_queries)

    def library():  # the (B, P, M) distance matrix, then its row minima
        return torch.cdist(q, r).min(dim=-1)

    fits = q.shape[0] * q.shape[1] * r.shape[1] * 4 <= 20e9
    library_ms = cuda_ms(library, 3) if fits else None
    plan = nearest.kernel_plan(q, r)
    # built with -fmad=false: no instruction does two flops, so the
    # float32 ceiling is half the peak the bound assumes
    say(label, shape=[list(q.shape), list(r.shape)],
        n_queries=n_queries.tolist(), n_valid=n_valid.tolist(),
        pairs=pairs, max_abs_err=err, index_differences=0, plan=plan,
        no_fma_ceiling_ms=2 * bms)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms, max_abs_err=err,
                no_fma_ceiling_ms=2 * bms, plan=plan,
                shape=f"queries {list(q.shape)} refs {list(r.shape)} f32")


def sphere_clouds(seed=3, n=100_000, device="cuda"):
    """The eval metrics' K2 shape (deftet_tpu/evals/metrics.py, 100k
    points a side): two clouds of n points on the unit sphere, batch 1."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, r = (torch.nn.functional.normalize(
        torch.randn((1, n, 3), generator=gen), dim=-1).to(device)
        for _ in range(2))
    full = torch.tensor([n], dtype=torch.int32, device=device)
    return q, r, full, full.clone()


def check_nearest_eval():
    """K2 at the eval metrics' shape, 100,000 against 100,000 points:
    exact against the plain version, timed beside its bound and no-FMA
    ceiling, with the plan (the reference axis split over blocks).  No
    library time: cdist's (P, M) matrix would be 40 GB."""
    from deftet_tpu_torch.ops import nearest

    q, r, n_valid, n_queries = sphere_clouds()
    err = check_nearest_exact("eval shape", q, r, n_valid, n_queries)[2]
    ms = cuda_ms(lambda: nearest.nearest_neighbor(q, r, n_valid, n_queries),
                 10)
    plain_ms = cuda_ms(
        lambda: nearest.nearest_neighbor_plain(q, r, n_valid, n_queries), 1)
    pairs, bms, by = nearest_bound(q, r, n_valid, n_queries)
    row = dict(shape=[list(q.shape), list(r.shape)], pairs=pairs, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               no_fma_ceiling_ms=2 * bms, plan=nearest.kernel_plan(q, r),
               index_differences=0, max_abs_err=err,
               library_ms=None, library="none: cdist's (P, M) matrix "
               "would be 40 GB")
    say("kernel_nearest_eval", **row)
    return row


# Flops of one point-triangle pair by its closest-point region, for the
# least work that gives the same answer: the region tests in the kernel's
# priority order (vertex a, b, c, edge ab, ac, bc, interior), each after
# only the products it needs, then that region's closest point q and
# |p - q|^2.  d1, d2 take 13 (p - a, two dot products), each further pair
# of dot products 13, vc and vb 3 each, va with d4 - d3 and d5 - d6 5; a
# vertex reuses p - v (5), an edge or the interior takes 8 for |p - q|^2;
# an edge's parameter 2 and point 6, the interior's 4 and 12.  b - a, c - a
# and c - b are per face (9 flops).
TRI_REGION_FLOPS = {"a": 13 + 5, "b": 26 + 5, "c": 39 + 5,
                    "ab": 39 + 3 + 8 + 8, "ac": 39 + 6 + 8 + 8,
                    "bc": 39 + 11 + 8 + 8, "interior": 39 + 11 + 16 + 8}
TRI_FACE_FLOPS = 9


def tri_region_counts(pts, tri, mask, n_active, chunk=512):
    """Scanned pairs (unmasked faces below n_active) by closest-point
    region, in the order of TRI_REGION_FLOPS, and the scanned faces."""
    counts = torch.zeros(len(TRI_REGION_FLOPS), dtype=torch.int64,
                         device=pts.device)
    faces = 0
    for bi in range(pts.shape[0]):
        na = int(n_active[bi])
        t = tri[bi, :na][mask[bi, :na] > 0]
        faces += t.shape[0]
        a, b, c = t[:, 0], t[:, 1], t[:, 2]
        ab, ac = b - a, c - a
        for s in range(0, pts.shape[1], chunk):
            p = pts[bi, s:s + chunk, None, :]
            ap, bp, cp = p - a, p - b, p - c
            d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
            d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
            d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
            va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
            region = torch.full_like(d1, 6, dtype=torch.int64)
            for r, sel in ((5, (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)),
                           (4, (vb <= 0) & (d2 >= 0) & (d6 <= 0)),
                           (3, (vc <= 0) & (d1 >= 0) & (d3 <= 0)),
                           (2, (d6 >= 0) & (d5 <= d6)),
                           (1, (d3 >= 0) & (d4 <= d3)),
                           (0, (d1 <= 0) & (d2 <= 0))):  # the last wins
                region = torch.where(sel, r, region)
            counts += torch.bincount(region.flatten(), minlength=7)
    return counts.tolist(), faces


def check_tri_argmin(args, label="kernel_tri_argmin", reps=20):
    """K3 on one call's inputs of a path against the plain version: the
    same index for every point (same region order and arithmetic, no FMA
    contraction, ties to the lowest index), hence the same distance at
    it."""
    from deftet_tpu_torch.ops import tri_distance

    pts, tri, mask, n_active = args

    def d2_at(idx):
        sel = torch.gather(tri, 1, idx.long()[:, :, None, None].expand(
            -1, -1, 3, 3))
        return tri_distance.point_triangle_squared_distance(
            pts, sel[..., 0, :], sel[..., 1, :], sel[..., 2, :])

    i = tri_distance.tri_argmin(pts, tri, mask)
    i_ref = tri_distance.tri_argmin_plain(pts, tri, mask, n_active)
    d, d_ref = d2_at(i), d2_at(i_ref)
    err = float((d - d_ref).abs().max())
    n_diff = int((i != i_ref).sum())
    if n_diff or err:
        raise AssertionError(
            f"tri_argmin {label}: {n_diff} indices differ, distance err "
            f"{err}")

    ms = cuda_ms(lambda: tri_distance.tri_argmin(pts, tri, mask), reps)
    plain_ms = cuda_ms(
        lambda: tri_distance.tri_argmin_plain(pts, tri, mask, n_active),
        max(1, reps // 10))
    b, p, _ = pts.shape
    counts, faces = tri_region_counts(pts, tri, mask, n_active)
    pairs = sum(counts)
    n_flops = TRI_FACE_FLOPS * faces + sum(
        n * f for n, f in zip(counts, TRI_REGION_FLOPS.values()))
    n_bytes = pts.numel() * 4 + tri.numel() * 4 + mask.numel() * 4 + 4 * b * p
    bms, by = bound_ms(n_bytes, n_flops)
    say(label, shape=[list(pts.shape), list(tri.shape)],
        n_active=n_active.tolist(), pairs=pairs, max_abs_err=err,
        index_differences=n_diff,
        region_pairs=dict(zip(TRI_REGION_FLOPS, counts)),
        flops_per_pair=n_flops / pairs,
        # built with -fmad=false: no instruction does two flops, so the
        # float32 ceiling is half the peak the bound assumes
        no_fma_ceiling_ms=2 * bms)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, max_abs_err=err, no_fma_ceiling_ms=2 * bms,
                shape=f"points {list(pts.shape)} faces {list(tri.shape)} f32")


def check_nearest_edge_cases(uniform, device="cuda"):
    """K2 where the main path does not reach, exact against the plain
    version.  Copies of one point tie at every distance, so the lowest
    valid copy must win across every sub-tile (32 references), ring slot
    (1,024), split and n_valid boundary, whatever the plan:

    * batch 0: references 0-4 far away, every one from 5 on a copy of one
      point (index 5 everywhere);
    * batch 1: references far away but copies at 31, 32, 1023, 1024, 5119,
      5120, 12000 (index 31);
    * batch 2: copies at 1024, 1055, 1056, 6000 with n_valid 1030, not a
      multiple of 32 (index 1024);
    * n_valid 0 (1e30, 0), 17,001 and 20,000 (past the Pallas kernel's
      16,384 cap);
    * n_queries ragged against the 512-query tile and the 3,072-query
      block (300, 1030, 3073), P below one block, and a query with a NaN
      coordinate, which no reference can be nearest to (1e30, 0);
    * batch 1 alone, where the plan splits the reference axis;
    * 1,100 batches of 32 queries against 6,000 references, where the plan
      keeps one split that streams through the ring, with copies across
      its slots."""
    from deftet_tpu_torch.ops import nearest

    m = 20000
    far = uniform(3, m, 3) + 10.0
    point = uniform(1, 1, 3)[0, 0]
    r = far.clone()
    r[0, 5:] = point
    for bi, copies in ((1, [31, 32, 1023, 1024, 5119, 5120, 12000]),
                       (2, [1024, 1055, 1056, 6000])):
        r[bi, copies] = point
    expect = (5, 31, 1024)
    report = {}
    for p, nq in ((3500, (3500, 3073, 300)), (100, (100, 60, 100))):
        q = uniform(3, p, 3)
        q[0, 7, 1] = float("nan")
        nv = torch.tensor([m, m, 1030], dtype=torch.int32, device=device)
        nqt = torch.tensor(nq, dtype=torch.int32, device=device)
        d, i, _ = check_nearest_exact(f"ties P={p}", q, r, nv, nqt)
        for bi, want in enumerate(expect):
            live = -(-nq[bi] // nearest.QUERY_TILE) * nearest.QUERY_TILE
            got = i[bi, :live].clone()
            if bi == 0:
                got[7] = want
            if not bool(torch.all(got == want)):
                raise AssertionError(f"nearest ties P={p}: batch {bi} "
                                     f"did not keep index {want}")
        if not (bool(d[0, 7] == 1e30) and int(i[0, 7]) == 0):
            raise AssertionError("nearest took a NaN distance")
        report[f"ties_P{p}"] = {"n_queries": list(nq),
                                "plan": nearest.kernel_plan(q, r)}

    q = uniform(1, 3500, 3)
    one = torch.tensor([m], dtype=torch.int32, device=device)
    plan = nearest.kernel_plan(q, r[1:2])
    if plan["splits"] < 2:
        raise AssertionError(f"nearest plan did not split B=1: {plan}")
    _, i, _ = check_nearest_exact("ties B=1", q, r[1:2].contiguous(), one,
                               torch.tensor([3500], dtype=torch.int32,
                                            device=device))
    if not bool(torch.all(i == expect[1])):
        raise AssertionError("nearest ties across splits: not index 31")
    report["ties_B1"] = {"plan": plan}

    # enough batches that the plan keeps one split of 6,000 references,
    # which stream through the ring's 5 slots; the rescan then reads device
    # memory.  Copies straddle sub-tiles and slots (slot 0 is refilled).
    n_b, n_r = 1100, 6000
    r = uniform(n_b, n_r, 3) + 10.0
    copies = ([31, 32, 1023, 1024], [1023, 1024, 5119, 5120],
              [5120, 5151, 5152, 5999])
    for bi in range(n_b):
        r[bi, copies[bi % 3]] = point
    q = uniform(n_b, 32, 3)
    plan = nearest.kernel_plan(q, r)
    if plan["splits"] != 1 or plan["split_len"] <= 5 * 1024:
        raise AssertionError(f"nearest plan does not stream: {plan}")
    full = torch.full((n_b,), n_r, dtype=torch.int32, device=device)
    _, i, _ = check_nearest_exact("ties streamed", q, r, full,
                               torch.full((n_b,), 32, dtype=torch.int32,
                                          device=device))
    want = torch.tensor([c[0] for c in copies], dtype=torch.int32,
                        device=device).repeat(n_b // 3 + 1)[:n_b]
    if not bool(torch.all(i == want[:, None])):
        raise AssertionError("nearest ties across ring slots: not the "
                             "lowest copy")
    report["ties_streamed"] = {"batch": n_b, "plan": plan}

    q, r = uniform(3, 3500, 3), uniform(3, m, 3)
    nv = torch.tensor([m, 17001, 0], dtype=torch.int32, device=device)
    nq = torch.tensor([300, 1030, 3073], dtype=torch.int32, device=device)
    d, i, _ = check_nearest_exact("masks", q, r, nv, nq)
    if not (bool(torch.all(d[0, 512:] == 0)) and bool(torch.all(i[2] == 0))
            and bool(torch.all(d[2, :3584] == 1e30))
            and bool(torch.all(i[1] < 17001))):
        raise AssertionError("nearest skip / no-valid outputs wrong")
    report["masks"] = ("n_valid (20000, 17001, 0), n_queries (300, 1030, "
                       f"3073), plan {nearest.kernel_plan(q, r)}")
    return report


def check_edge_cases(device="cuda"):
    """The kernels' paths that the main path's inputs do not reach,
    against the plain versions at small shapes: K1 on ragged row tiles,
    lattices smaller than a tile and every kind of scale, and its refusal
    of a lattice too large for the tiled path; K2's ties, masks and skip
    (check_nearest_edge_cases); K3's masks, ties across face splits and
    ragged point tiles.  All must agree exactly."""
    from deftet_tpu_torch.ops import nearest, stencil, tri_distance
    from deftet_tpu_torch.tetgrid import build_tet_grid
    from deftet_tpu_torch.train.statics import lattice_offsets

    gen = torch.Generator(device="cpu").manual_seed(5)

    def uniform(*shape):
        return (torch.rand(shape, generator=gen) * 2 - 1).to(device)

    report = {}
    offsets = lattice_offsets(build_tet_grid(5))
    cases = 0
    for n in (2, 3, 17, 51):
        scale = torch.rand(n**3, generator=gen).to(device)
        in_scale = (torch.rand(n**3, generator=gen) + 0.1).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            for c in (3, 40, 130, 256):
                x = uniform(2, n**3, c).to(dtype)
                for s, s_in in ((scale, None), (None, None),
                                (None, in_scale), (scale, in_scale)):
                    got = stencil.stencil_sum(x, n, offsets, s, s_in)
                    ref = stencil.stencil_sum_plain(x, n, offsets, s, s_in)
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            f"stencil edge case n={n} {dtype} C={c} "
                            f"scale={s is not None} "
                            f"in_scale={s_in is not None}")
                    cases += 1
    report["stencil"] = (f"{cases} cases: n in (2, 3, 17, 51), C in (3, 40, "
                         "130, 256), f32 and bf16, scale / none / in_scale "
                         "/ both")
    # 16-byte packs on a lattice whose ring does not fit in shared memory:
    # refused, not run another way
    x = torch.zeros(1, 200**3, 8, dtype=torch.bfloat16, device=device)
    try:
        stencil.stencil_sum(x, 200, offsets)
    except RuntimeError as e:
        if "not supported" not in str(e):
            raise
        report["stencil_refused"] = f"n=200 C=8 bf16: {e}"
    else:
        raise AssertionError("stencil ran n=200 with 16-byte packs")
    del x

    report["nearest"] = check_nearest_edge_cases(uniform, device)

    # Batch 0: every face a copy of face 5, behind five masked copies, so
    # that every face split the kernel cuts ties at the same distance and
    # the merge must keep the lowest unmasked index, wherever the splits
    # fall.  Batch 1: masked faces and a ragged n_active; batch 2: every
    # face masked.  P ragged against the point tile and P below one tile.
    n_faces = 3000
    tri = uniform(3, n_faces, 3, 3)
    tri[0] = tri[0, 5]
    mask = (torch.rand(3, n_faces, generator=gen) < 0.7).float().to(device)
    mask[0] = 1
    mask[0, :5] = 0
    mask[1, 2777:] = 0
    mask[2] = 0
    for p in (700, 100):
        pts = uniform(3, p, 3)
        i = tri_distance.tri_argmin(pts, tri, mask)
        i_ref = tri_distance.tri_argmin_plain(
            pts, tri, mask, tri_distance.active_face_count(mask))
        if not torch.equal(i, i_ref):
            raise AssertionError(
                f"tri_argmin edge cases (P={p}): "
                f"{int((i != i_ref).sum())} indices differ")
        if not (bool(torch.all(i[0] == 5)) and bool(torch.all(i[2] == 0))
                and int(i[1].max()) < 2777
                and bool(torch.all(mask.gather(1, i[:2].long()) > 0))):
            raise AssertionError("tri_argmin broke a tie or picked a masked "
                                 "face")
        report[f"tri_argmin_P{p}"] = (
            "3000 equal faces behind 5 masked (index 5 everywhere), masked "
            "faces, n_active 2777, all masked")
    say("kernel_edge_cases", **report)


# --------------------------------------------------- train loop and eval
def small_config(**over):
    """bench.py's small network at res 4 in float32 (the parity phases)."""
    from deftet_tpu_torch.config import TrainConfig

    kw = dict(res=4, batch_size=2, encoder_blocks="8,1,8;16,1,4",
              gcn_hidden="16,8", pos_mlp_hidden="8", occ_mlp_hidden="16,8",
              n_point=256, num_sample_points=256, per_face_samples=4,
              occ_sample=128, precision="f32")
    kw.update(over)
    return TrainConfig(**kw)


def ratio(got, ref, rtol, atol) -> float:
    """max |got - ref| / (atol + rtol |ref|): within tolerance when <= 1."""
    got, ref = (torch.as_tensor(x).double().cpu() for x in (got, ref))
    if not ref.numel():
        return 0.0
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def on_device(draws, device):
    """Numpy draws as tensors: ids int64, everything else float32."""
    def one(k, v):
        ids = k == "center_idx" or (isinstance(v, np.ndarray)
                                    and v.dtype.kind == "i")
        return torch.tensor(v, device=device,
                            dtype=torch.int64 if ids else torch.float32)

    out = {}
    for k, v in draws.items():
        out[k] = (tuple(one(k, x) for x in v) if isinstance(v, tuple)
                  else one(k, v))
    return out


def parity_train(devices=("cpu", DEVICE)):
    """The res-4 / batch-4 f32 train step with grad_accum=2, remat and the
    cosine lr, card against CPU, two steps from the same parameters and
    injected draws, at the step tolerances: terms rtol 1e-4 / atol 1e-6,
    the averaged gradient (Adam's first moment, 0.1 g) rtol 1e-3 /
    atol 1e-6, each parameter's update rtol 1e-3 / atol 1e-7, and the
    BatchNorm statistics of the first step rtol 1e-4 / atol 1e-6.

    Entries whose gradient is at the level of rounding noise (biases
    feeding a BatchNorm, whose true gradient is 0, and weight entries
    along a BatchNorm's null direction) differ in sign between the
    devices, and Adam moves each by ~lr whatever its size: their updates
    are held within 3 lr a step, and the second step's running means,
    which follow those parameters, within 2 lr; running variances stay
    at rtol 1e-4 / atol 1e-6.  Then on the card: one
    microbatch's gradient with remat equals the one without it, rtol 1e-5
    with an atol of 1e-6 of the largest gradient (the noise of those
    biases), and K2 and K3 launch once per microbatch in a step with and
    without remat."""
    import dataclasses

    from deftet_tpu_torch import remat
    from deftet_tpu_torch.ops import _cuda
    from deftet_tpu_torch.train import Engine

    cfg = small_config(batch_size=4, grad_accum=2, remat=True,
                       lr_decay_steps=3)
    rng = np.random.default_rng(12)
    k = cfg.resolved_max_boundary_faces()
    mb = cfg.batch_size // cfg.grad_accum
    bary = (mb, k, cfg.per_face_samples, 1)
    draws = [[{"noise": rng.normal(size=(mb, cfg.n_point, 3)),
               "center_idx": rng.integers(0, 6 * cfg.res**3, cfg.occ_sample),
               "bary_u": rng.uniform(size=bary),
               "bary_v": rng.uniform(size=bary)}
              for _ in range(cfg.grad_accum)] for _ in range(2)]
    batch = bench_batch(cfg, level=1, occ_res=16)
    state, runs = None, {}
    for device in devices:
        engine = Engine(cfg, device=device)
        if state is None:
            state = {n: v.clone() for n, v in
                     engine.model.state_dict().items()}
        engine.model.load_state_dict(state)
        prepped = engine._prep_batch(batch)
        terms, stats = [], []
        for step in draws:
            t = engine.train_step(prepped,
                                  draws=[on_device(d, device) for d in step])
            terms.append({n: float(v) for n, v in t.items()})
            stats.append({n: v.detach().cpu().clone() for n, v in
                          engine.model.named_buffers()})
        names = [n for n, _ in engine.model.named_parameters()]
        runs[device] = dict(
            terms=terms, stats=stats,
            update={n: (p.detach() - state[n].to(device)).cpu()
                    for n, p in engine.model.named_parameters()},
            mu={n: m.cpu().clone()
                for n, m in zip(names, engine.optimizer.mu)})
    cpu, gpu = (runs[d] for d in devices)
    live_ratio, slack = 0.0, 0.0
    noise = 3 * cfg.lr * len(draws)  # a noise-driven update's reach
    for n, upd in cpu["update"].items():
        live = cpu["mu"][n].abs() > 1e-6
        live_ratio = max(live_ratio, ratio(gpu["update"][n][live], upd[live],
                                           1e-3, 1e-7))
        slack = max(slack,
                    float((gpu["update"][n] - upd).abs().max()) / noise)
    (s1, s2), (c1, c2) = gpu["stats"], cpu["stats"]
    worst = {
        "terms": max(ratio(g[n], c[n], 1e-4, 1e-6)
                     for g, c in zip(gpu["terms"], cpu["terms"]) for n in c),
        "batch_stats_step1": max(ratio(s1[n], v, 1e-4, 1e-6)
                                 for n, v in c1.items()),
        "running_var_step2": max(ratio(s2[n], v, 1e-4, 1e-6)
                                 for n, v in c2.items() if "var" in n),
        "running_mean_step2": max(ratio(s2[n], v, 0.0, 2 * cfg.lr)
                                  for n, v in c2.items() if "mean" in n),
        "mu": max(ratio(gpu["mu"][n], v, 1e-3, 1e-6)
                  for n, v in cpu["mu"].items()),
        "update": live_ratio,
        "update_noise": slack,
    }

    grads, calls = {}, {}
    for use_remat in (False, True):
        engine = Engine(dataclasses.replace(cfg, remat=use_remat),
                        device=DEVICE)
        engine.model.load_state_dict(state)
        prepped = engine._prep_batch(batch)
        first = {n: v[:mb] for n, v in prepped.items()}
        d = on_device(draws[0][0], DEVICE)

        def loss(engine=engine, first=first, d=d):
            return engine.forward_losses(first, train=True, draws=d)

        total, _ = (remat.checkpoint(loss, engine.generator, engine.model)
                    if use_remat else loss())
        params = list(engine.model.parameters())
        g = torch.autograd.grad(total, params, allow_unused=True)
        grads[use_remat] = [torch.zeros_like(p) if x is None else x
                            for p, x in zip(params, g)]
        _cuda.reset_launch_counts()
        engine.train_step(prepped,
                          draws=[on_device(x, DEVICE) for x in draws[0]])
        calls[use_remat] = dict(_cuda.launch_counts)
    g_max = max(float(g.abs().max()) for g in grads[False])
    worst["remat_grads"] = max(ratio(b, a, 1e-5, 1e-6 * g_max)
                               for a, b in zip(grads[False], grads[True]))
    say("parity_train", terms_cuda=gpu["terms"], terms_cpu=cpu["terms"],
        worst_ratios=worst, launches_per_step={"no_remat": calls[False],
                                               "remat": calls[True]})
    if not all(v <= 1.0 for v in worst.values()):
        raise AssertionError(f"train-loop parity failed: {worst}")
    for use_remat, c in calls.items():
        if c["nearest"] != cfg.grad_accum or c["tri_argmin"] != cfg.grad_accum:
            raise AssertionError(f"remat={use_remat}: K2/K3 launches {c}, "
                                 f"not once per microbatch")


def eval_batch(seeds, n_surface, n_sdf, level, occ_res):
    """Records of the port's make_example for random_shape(seed, level),
    padded as ShapeDataset pads them (numpy)."""
    from deftet_tpu_torch.data.pipeline import make_example
    from deftet_tpu_torch.data.shapes import random_shape, shape_family

    exs = []
    for seed in seeds:
        verts, faces = random_shape(seed, level=level)
        exs.append(make_example(verts, faces, n_surface, n_sdf,
                                np.random.default_rng(seed),
                                occ_grid_res=occ_res))
    b = len(exs)
    nv = max(e["verts"].shape[0] for e in exs)
    nf = max(e["faces"].shape[0] for e in exs)
    batch = {k: np.stack([e[k] for e in exs])
             for k in ("surface_points", "sdf_points", "sdf", "occ_grid")}
    batch["verts"] = np.zeros((b, nv, 3), np.float32)
    batch["faces"] = np.zeros((b, nf, 3), np.int32)
    batch["n_verts"] = np.array([e["verts"].shape[0] for e in exs], np.int32)
    batch["n_faces"] = np.array([e["faces"].shape[0] for e in exs], np.int32)
    for i, e in enumerate(exs):
        batch["verts"][i, :e["verts"].shape[0]] = e["verts"]
        batch["faces"][i, :e["faces"].shape[0]] = e["faces"]
    batch["category"] = [shape_family(s) for s in seeds]
    return batch


def parity_eval(devices=("cpu", DEVICE)):
    """The res-4 / batch-2 f32 inference step, card against CPU, from the
    same parameters and injected draws (input noise, the face ids and
    uniforms of both samplers): every output rtol 1e-4 / atol 1e-6, the
    CPU tests' tolerance against the JAX package.  The occupancy threshold
    is set in the widest gap between neighbouring probabilities above the
    median, so that there is a surface and no probability sits near it."""
    from deftet_tpu_torch.evals import harness
    from deftet_tpu_torch.train import Engine

    n_res = 300
    cfg = small_config(eval_points=n_res)
    batch = eval_batch((1, 2), 256, 400, level=1, occ_res=16)
    rng = np.random.default_rng(13)
    k = cfg.resolved_max_boundary_faces()
    n_gt = int(batch["n_faces"].min())

    def sampler(n_faces):
        return (rng.integers(0, n_faces, (2, n_res)),
                rng.uniform(size=(2, n_res, 1)),
                rng.uniform(size=(2, n_res, 1)))

    draws = {"noise": rng.normal(size=(2, cfg.n_point, 3)),
             "pred": sampler(k), "gt": sampler(n_gt)}
    state, out = None, {}
    for device in devices:
        engine = Engine(cfg, device=device)
        if state is None:
            state = {n: v.clone() for n, v in
                     engine.model.state_dict().items()}
        engine.model.load_state_dict(state)
        prepped = engine._prep_batch(batch)
        d = on_device(draws, device)
        if device == devices[0]:
            _, _, logits = harness._predict(
                engine.model, prepped, engine.statics, cfg,
                engine.lattice_offsets, engine.tet_lattice, noise=d["noise"])
            probs = np.sort(torch.sigmoid(logits).cpu().numpy().reshape(-1))
            half = len(probs) // 2
            i = half + int(np.argmax(np.diff(probs[half:])))
            cfg.occ_threshold = float((probs[i] + probs[i + 1]) / 2)
        out[device] = {n: float(v) for n, v in engine.inference_step()(
            prepped, engine.statics, draws=d).items()}
    cpu, gpu = (out[d] for d in devices)
    worst = max(ratio(gpu[n], v, 1e-4, 1e-6) for n, v in cpu.items())
    say("parity_eval", metrics_cuda=gpu, metrics_cpu=cpu, worst_ratio=worst,
        occ_threshold=cfg.occ_threshold)
    if not worst <= 1.0 or cpu["n_boundary"] <= 0:
        raise AssertionError(f"inference parity failed: ratio {worst}, "
                             f"n_boundary {cpu['n_boundary']}")


EVAL_POINTS = 100_000  # deftet-eval's default (deftet_tpu/cli.py:154)
EVAL_SDF = 20_000      # the pipeline's n_sdf default
EVAL_RUNS = 3


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` over ``reps`` runs after one
    warm-up, each ended by a device synchronize."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def eval_phase(engine):
    """The main path's res-50 / batch-4 / bf16 engine after its steps,
    evaluated on four shapes of the port's make_example (random_shape
    0-3, level 2; 5,000 surface points, 20,000 SDF points, a 64^3
    texture) at 100,000 surface points a side: validate and
    validate_inference, then one warm-up and EVAL_RUNS timed inference
    steps with the launch counts read around them, and the parts of the
    step timed alone (the forward with the full-grid occupancy,
    points_in_tets_soa).  Fails on a non-finite metric, on no predicted
    surface (the engine trains on the batch until there is one, at most
    40 steps, and says so) and on a kernel of the path never launched."""
    from deftet_tpu_torch.evals import harness
    from deftet_tpu_torch.ops import _cuda, point_tet

    cfg = engine.config
    cfg.eval_points = EVAL_POINTS
    cfg.logdir = str(ROOT / "build" / "smoke_eval")  # validate's log
    t0 = time.perf_counter()
    batch = eval_batch(range(4), max(cfg.num_sample_points, cfg.n_point),
                       EVAL_SDF, level=2, occ_res=64)
    data_s = time.perf_counter() - t0
    prepped = engine._prep_batch(batch)
    infer = engine.inference_step()

    def run():
        gen = torch.Generator(device=engine.device).manual_seed(cfg.seed)
        return infer(prepped, engine.statics, gen)

    trained = 0
    n_boundary = float(run()["n_boundary"])
    while n_boundary <= 0 and trained < 40:
        engine.train_step(prepped)
        trained += 1
        n_boundary = float(run()["n_boundary"])
    if n_boundary <= 0:
        raise AssertionError("no predicted surface after 40 steps on the "
                             "eval batch")
    val = engine.validate([batch])
    val_inference = engine.validate_inference([batch])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    times = []
    with Recorder(shape_key) as rec:
        for i in range(1 + EVAL_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = {n: float(v) for n, v in run().items()}
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t)
    launches = dict(_cuda.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    bad = [n for n, v in out.items() if not np.isfinite(v)]
    if bad or out["n_boundary"] <= 0:
        raise AssertionError(f"eval: non-finite {bad} or no surface {out}")
    idle = [n for n in ("stencil", "nearest", "tri_argmin")
            if launches[n] == 0]
    if idle:
        raise AssertionError(f"eval path never launched {idle}")

    with torch.no_grad():
        _, soa, _ = harness._predict(engine.model, prepped, engine.statics,
                                     cfg, engine.lattice_offsets,
                                     engine.tet_lattice)
        predict_ms = host_ms(lambda: harness._predict(
            engine.model, prepped, engine.statics, cfg,
            engine.lattice_offsets, engine.tet_lattice), 3)
        pit_ms = host_ms(lambda: point_tet.points_in_tets_soa(
            soa, prepped["sdf_points"]), 3)
    runs = 1 + EVAL_RUNS
    say("eval", config=f"res={cfg.res} batch={cfg.batch_size} "
        f"{cfg.precision} eval_points={EVAL_POINTS} n_sdf={EVAL_SDF}",
        trained_for_surface=trained, data_s=data_s, metrics=out,
        validate=val, validate_inference=val_inference,
        median_infer_s=statistics.median(times), infer_s=times,
        max_memory_allocated_bytes=peak, launches_total=launches,
        launches_per_run={n: c / runs for n, c in launches.items()},
        predict_ms=predict_ms, points_in_tets_ms=pit_ms,
        points_in_tets_tests=4 * 4 * EVAL_SDF * engine.statics.n_tets)
    return dict(inputs=rec.inputs, launches=launches,
                budget=cfg.resolved_max_boundary_faces(),
                per_run={k: c / runs for k, c in rec.counts.items()},
                median_infer_s=statistics.median(times), predict_ms=predict_ms,
                points_in_tets_ms=pit_ms)


def check_eval_kernels(ev):
    """K1-K3 at the inference step's inputs, exact against their plain
    versions and timed beside their bounds: K1 in the GCN's eval forward,
    K2 on one of the metrics' eight (4, 100k) against (4, 100k) calls, K3
    on both Hausdorff calls (GT points against the predicted surface,
    predicted points against the GT mesh); then the step's time split."""
    inputs, per_run = ev["inputs"], ev["per_run"]
    k1 = check_stencil({k: v for k, v in inputs.items() if k[0] == "stencil"},
                       {k: c for k, c in per_run.items()
                        if k[0] == "stencil"},
                       label="kernel_stencil_eval", profile_launches=False)
    (nn_key,) = [k for k in inputs if k[0] == "nearest"]
    k2 = check_nearest(inputs[nn_key], label="kernel_nearest_eval", reps=5)
    k2["launches_per_run"] = per_run[nn_key]
    k3 = {}
    for key in sorted((k for k in inputs if k[0] == "tri_argmin"), key=str):
        side = ("gt_points_to_predicted_surface" if key[2][1] == ev["budget"]
                else "predicted_points_to_gt_mesh")
        k3[side] = check_tri_argmin(inputs[key], label=f"kernel_tri_{side}",
                                    reps=5)
        k3[side]["launches_per_run"] = per_run[key]
    run_ms = ev["median_infer_s"] * 1e3
    split = {"predict_forward_and_occupancy_ms": ev["predict_ms"],
             "points_in_tets_ms": ev["points_in_tets_ms"],
             "k2_ms": k2["ms"] * per_run[nn_key],
             "k3_ms": sum(r["ms"] for r in k3.values()),
             "step_ms": run_ms}
    split["rest_ms"] = run_ms - sum(v for n, v in split.items()
                                    if n != "step_ms")
    say("eval_split", **split)
    return {"stencil": k1, "nearest": k2, "tri_argmin": k3}


PAPER_STEPS = 3
# launches per step at grad_accum=2: each microbatch runs the GCN's four
# K1 forwards and the Laplacian's (again in remat's recompute) and five
# K1 backwards, one K2 and one K3
PAPER_LAUNCHES = {False: {"stencil": 20, "nearest": 2, "tri_argmin": 2},
                  True: {"stencil": 30, "nearest": 2, "tri_argmin": 2}}


def paper_config(remat: bool):
    """bench.py's paper recipe (bench.py:373-397: res 70, batch 8,
    grad_accum=2) on the bench configuration, unreduced."""
    cfg = bench_config()
    cfg.res, cfg.batch_size, cfg.grad_accum, cfg.remat = 70, 8, 2, remat
    return cfg


def paper_step():
    """The paper recipe with and without remat: one warm-up and
    PAPER_STEPS timed steps each, launches per step checked, median step
    time and peak memory; the kernels' inputs kept from the run without
    remat."""
    from deftet_tpu_torch.ops import _cuda
    from deftet_tpu_torch.train import Engine

    rows = {}
    for use_remat in (True, False):
        cfg = paper_config(use_remat)
        t0 = time.perf_counter()
        engine = Engine(cfg, device=DEVICE)
        t_init = time.perf_counter() - t0
        batch = engine._prep_batch(bench_batch(cfg, occ_res=64))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        expected = PAPER_LAUNCHES[use_remat]
        step_s = []
        _cuda.reset_launch_counts()
        with Recorder() as rec:
            for step in range(1 + PAPER_STEPS):
                before = dict(_cuda.launch_counts)
                torch.cuda.synchronize()
                t = time.perf_counter()
                terms = engine.train_step(batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                counts = {n: _cuda.launch_counts[n] - before[n]
                          for n in expected}
                terms = {n: float(v) for n, v in terms.items()}
                say("paper_step_step", remat=use_remat, step=step,
                    warmup=step == 0, seconds=dt, launches=counts,
                    terms=terms)
                bad = [n for n, v in terms.items() if not np.isfinite(v)]
                if bad:
                    raise AssertionError(f"non-finite loss terms: {bad}")
                if counts != expected:
                    raise AssertionError(
                        f"launches {counts} != expected {expected}")
                if step:
                    step_s.append(dt)
        rows[use_remat] = dict(
            engine_init_s=t_init, median_step_s=statistics.median(step_s),
            step_s=step_s,
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
            launches_total=dict(_cuda.launch_counts),
            launches_per_step=expected)
        if not use_remat:
            inputs = rec.inputs
            per_step = {k: c / (1 + PAPER_STEPS)
                        for k, c in rec.counts.items()}
        del engine, batch
        torch.cuda.empty_cache()
    say("paper_step", config=f"res={cfg.res} batch={cfg.batch_size} "
        f"{cfg.precision} grad_accum={cfg.grad_accum}",
        remat=rows[True], no_remat=rows[False])
    return inputs, per_step, rows


def check_paper_kernels(inputs, per_step):
    """K1-K3 at the paper recipe's inputs (res 70, microbatch 4), exact
    against their plain versions and timed beside their bounds."""
    return {
        "stencil": check_stencil(inputs, per_step,
                                 label="kernel_stencil_paper",
                                 profile_launches=False),
        "nearest": check_nearest(inputs[("nearest",)],
                                 label="kernel_nearest_paper"),
        "tri_argmin": check_tri_argmin(inputs[("tri_argmin",)],
                                       label="kernel_tri_argmin_paper"),
    }


# the verify skill's tiny configuration
CLI_TINY = ["--res", "4", "--batch_size", "2", "--n_point", "128",
            "--num_sample_points", "256", "--occ_sample", "128",
            "--per_face_samples", "4", "--encoder_blocks", "8,1,8;16,1,4",
            "--gcn_hidden", "16,8", "--pos_mlp_hidden", "8",
            "--occ_mlp_hidden", "16,8", "--epochs", "2", "--n_shapes", "6"]
METRICS = ("occ_iou", "val_iou_max", "f_score", "f_score_extend", "chamfer",
           "chamfer_l1", "hausdorff", "hausdorff_max", "n_boundary",
           "boundary_overflow")


def cli_phase():
    """The two commands, each in a subprocess on the card, at the verify
    skill's tiny configuration: train for 2 epochs, then eval on its
    experiment (100,000 points a side); both exit 0 and the report holds
    every metric.  Then, in this process, an engine restored from the
    'last' checkpoint takes the step the uninterrupted engine takes: the
    terms, parameters and statistics rtol 1e-5 / atol 1e-7 (kernels with
    atomics may reorder float sums on the card)."""
    import shutil

    from deftet_tpu_torch.config import TrainConfig
    from deftet_tpu_torch.data import ShapeDataset, batch_iterator
    from deftet_tpu_torch.train import Engine

    work = ROOT / "build" / "smoke_cli"
    shutil.rmtree(work, ignore_errors=True)

    def run(*args):
        t = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "deftet_tpu_torch.cli",
                              *args], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        if out.returncode:
            raise RuntimeError(f"cli {args[0]} exited {out.returncode}:\n"
                               f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        return time.perf_counter() - t

    train_s = run("train", "--device", DEVICE, *CLI_TINY, "--dataset_root",
                  str(work / "data"), "--logdir", str(work / "exp"))
    (exp,) = (work / "exp").iterdir()
    eval_s = run("eval", "--device", DEVICE, "--experiment_path", str(exp),
                 "--eval_points", str(EVAL_POINTS))
    report = json.loads((exp / "result_update.json").read_text())
    metrics = report["metrics"]
    bad = [n for n in METRICS if not np.isfinite(metrics.get(n, np.nan))]
    if bad or report["device"] != DEVICE:
        raise AssertionError(f"eval report lacks {bad}: {report}")

    config = TrainConfig.load(str(exp / "config.json"))
    config.logdir = str(work / "restore")
    split = json.loads((exp / "split.json").read_text())
    b1, b2 = list(batch_iterator(ShapeDataset(split["train"]),
                                 config.batch_size))[:2]
    engine = Engine(config, device=DEVICE)
    engine.train_step(engine._prep_batch(b1))
    engine.save()
    terms = engine.train_step(engine._prep_batch(b2))
    fresh = Engine(config, device=DEVICE, experiment=engine.experiment)
    fresh.restore("last")
    terms2 = fresh.train_step(fresh._prep_batch(b2))
    pairs = ([(terms2[n], v) for n, v in terms.items()]
             + list(zip(fresh.model.parameters(), engine.model.parameters()))
             + list(zip(fresh.model.buffers(), engine.model.buffers())))
    worst = max(ratio(a.detach(), b.detach(), 1e-5, 1e-7) for a, b in pairs)
    identical = all(torch.equal(a, b) for a, b in pairs)
    say("cli", train_s=train_s, eval_s=eval_s, metrics=metrics,
        restore_worst_ratio=worst, restore_bit_identical=identical)
    if not worst <= 1.0:
        raise AssertionError(f"restored engine diverged: ratio {worst}")


# ------------------------------------------------------------ the renderer
# The full-width 2D-supervision run: make_nerf_protocol_scene's defaults
# (400x400, 100 train / 8 val / 25 test views) on RenderOptConfig's
# defaults (res-40 Kuhn grid, k 300, 16x16 tile sampling at 4 %, the real
# tet budget) with the stages cut to 30 steps and a carve every 10.
RENDER_CFG = dict(sublevels=1, steps_mov=30, steps_fix=30, delete_every=10)
RENDER_SUBDIV_STEPS = 20
SUBDIV_SCENE = ROOT / "tests" / "assets" / "bench_scene.npz"
FRAME_TILES = 25 * 25  # a 400x400 frame in 16x16 tiles
# raster_hit builds with -fmad=false: no instruction does two flops
PEAK_F32_NO_FMA = PEAK_F32 / 2
# flops of a (pixel, candidate) pair with the face-only terms hoisted: two
# edge functions (2 differences, 2 products, 1 difference each), two
# divisions, w1 (2); z of a pair inside the triangle (3 products, 2 sums);
# per tile and candidate, the denominator (7) and 4 face-only differences
HIT_PAIR_FLOPS, HIT_Z_FLOPS, HIT_FACE_FLOPS = 14, 5, 11


def hit_kind(args):
    """The path of one raster_hit call, by its layout: the coverage count
    of a calibration (k 0), a 400x400 full frame, or training tiles."""
    pix, ranges, face_z, face_img, cand, offsets, tile_pixels, k = args
    if k == 0:
        return "count"
    if offsets.shape[0] - 1 == FRAME_TILES and tile_pixels == 256:
        return "frame"
    return "train"


def hit_recorder():
    """A Recorder of raster_hit's launches, keyed by ``hit_kind``."""
    from deftet_tpu_torch.render import raster

    return Recorder(lambda name, args: hit_kind(args),
                    {"raster_hit": (raster, "_raster_hit_cuda")})


def protocol_scene():
    from deftet_tpu_torch.render import optimize as ro

    t = time.perf_counter()
    data = ro.make_nerf_protocol_scene(device=DEVICE)
    torch.cuda.synchronize()
    images = data[0]
    say("render_scene", seconds=time.perf_counter() - t,
        images=list(images.shape), views=[len(s) for s in data[3]],
        mask_mean=float(images[..., 3].mean()))
    if not np.isfinite(images).all() or not 0.01 < images[..., 3].mean() < 0.9:
        raise AssertionError("protocol scene: bad ground truth")
    return data


def _seeded_params(scene, seed, device):
    """Random parameters with alpha ~0 on the x < 0 half, so that a carve
    deletes tets."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(0, 1.0, (scene.n_points, 4)).astype(np.float32)
    feat[scene.points_px3[:, 0] < 0.0, 0] = -12.0
    mov = rng.normal(0, 0.01, (scene.n_points, 3)).astype(np.float32)
    return {"feat": torch.tensor(feat, device=device),
            "mov": torch.tensor(mov, device=device)}


def render_parity(devices=("cpu", DEVICE)):
    """The same small scene on the CPU (plain hit pass) and the card (the
    kernel): a res-6 grid, make_synthetic_scene at 32x32 with 8 views,
    optimize_stage in mov mode for 6 steps with a carve at step 2, then
    fix mode for 6 steps.  Ground truth rtol 1e-5, histories rtol 1e-4,
    parameters rtol 1e-4 with atol 3 lr (Adam moves a parameter whose
    gradient is rounding noise by ~lr, in a direction that can differ by
    device).  Then one full frame from the CPU run's final state, the same
    face arrays on both: ids, z and counts equal, colours rtol 1e-5."""
    from deftet_tpu_torch.render import frame as rf
    from deftet_tpu_torch.render import optimize as ro
    from deftet_tpu_torch.render.scene import TetScene
    from deftet_tpu_torch.tetgrid import build_tet_grid

    cfg = ro.RenderOptConfig(tet_res=6, pixel_sampling=0.5, delete_every=3,
                             carve_dilation=0, seed=0)
    runs = {}
    for dev in devices:
        data = ro.make_synthetic_scene(n_views=8, height=32, width=32,
                                       device=dev)
        scene = TetScene.from_grid(build_tet_grid(6), coef=cfg.coef,
                                   device=dev)
        n0 = scene.n_tets
        params = _seeded_params(scene, 5, dev)
        hist, infos = [], []
        for gridmov in (True, False):
            params, h, info = ro.optimize_stage(
                scene, params, *data[:3], data[3][0], cfg, gridmov, 6,
                log=None)
            hist += h
            infos.append(info)
        runs[dev] = dict(data=data, scene=scene, params=params, hist=hist,
                         infos=infos)
    a, b = (runs[d] for d in devices)
    if a["scene"].n_tets >= n0 or not np.array_equal(a["scene"].tets_tx4,
                                                      b["scene"].tets_tx4):
        raise AssertionError("render_parity: the carve did not run alike")
    worst = {
        "images": ratio(b["data"][0], a["data"][0], 1e-5, 1e-6),
        "history": ratio(b["hist"], a["hist"], 1e-4, 0.0),
        "feat": ratio(b["params"]["feat"].detach(),
                      a["params"]["feat"].detach(), 1e-4, 3 * cfg.lr_feat),
        "mov": ratio(b["params"]["mov"].detach(),
                     a["params"]["mov"].detach(), 1e-4, 3 * cfg.lr_mov),
    }
    scene, params = a["scene"], a["params"]
    h, w, focal = a["data"][2]
    cam = ro.camera_from_blender(a["data"][1][0], focal, h, w)
    with torch.no_grad():
        face = scene.face_arrays(params, *cam)
    bins = rf.build_frame_bins(ro.project_faces_np(scene, params, cam), h, w)
    lin, pix = rf.frame_pixels(h, w, 16)
    out = {}
    for dev in devices:
        fz, fi, ff = (x.to(dev) for x in face)
        ids, counts = rf.frame_hits(fz, fi, bins, pix, 16, cfg.k)
        k_used = rf.peel_depth(counts, cfg.k)
        color, vis = rf.frame_replay(ids[:, :k_used], pix, fi, ff)
        out[dev] = (ids.cpu(), counts.cpu(), color.cpu(), vis.cpu(), k_used)
    (ia, ca, cola, visa, ka), (ib, cb, colb, visb, kb) = (out[d]
                                                          for d in devices)
    frame_equal = torch.equal(ia, ib) and torch.equal(ca, cb) and ka == kb
    worst["frame_color"] = ratio(colb, cola, 1e-5, 1e-6)
    worst["frame_vis"] = ratio(visb, visa, 1e-5, 1e-6)
    say("render_parity", n_tets=[n0, scene.n_tets], infos=a["infos"],
        history_cpu=a["hist"], history_cuda=b["hist"], worst_ratios=worst,
        frame_ids_counts_equal=frame_equal, frame_k=ka,
        frame_max_hits=int(ca.max()))
    if not frame_equal or not all(v <= 1.0 for v in worst.values()):
        raise AssertionError(f"render parity failed: {worst}, frame equal "
                             f"{frame_equal}")


def _median_steps(stage_log):
    """Median seconds of a stage's steps that neither carve nor
    recalibrate."""
    plain = [s["seconds"] for s in stage_log if not s["recalibrated"]]
    return statistics.median(plain) if plain else None


def render_phase(data):
    """The full-width run through run_pipeline, the counts set to 0 just
    before it and read just after; then the numbers it is measured by."""
    from deftet_tpu_torch.ops import _cuda
    from deftet_tpu_torch.render import optimize as ro

    cfg = ro.RenderOptConfig(**RENDER_CFG)
    logs, step_log = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    with hit_recorder() as rec:
        scene, params, records = ro.run_pipeline(
            *data, cfg, log=logs.append, device=DEVICE, step_log=step_log)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = dict(_cuda.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    branch = [m for m in logs if m.startswith("[subdiv]")]
    stages = [{
        "sublevel": s["sublevel"], "stage": s["stage"],
        "median_step_s": _median_steps(s["steps"]),
        "steps": len(s["steps"]),
        "recalibrated_steps": [x["step"] for x in s["steps"]
                               if x["recalibrated"]],
        "recalibrated_step_s": [x["seconds"] for x in s["steps"]
                                if x["recalibrated"]],
        "frame_s_per_view": s["psnr_seconds"] / s["psnr_views"],
    } for s in step_log]
    say("render", seconds=seconds, config=RENDER_CFG, records=records,
        stages=stages, subdiv_branch=branch,
        calibrations=[m for m in logs if m.startswith(("[bin]", "[peel]"))],
        max_memory_allocated_bytes=peak, launches=launches,
        launches_by_path=rec.counts, final_tets=scene.n_tets)
    if launches["raster_hit"] == 0 or any(
            launches[n] for n in ("stencil", "nearest", "tri_argmin")):
        raise AssertionError(f"render path launches {launches}")
    if len(records) != 4 or not all(np.isfinite(r["psnr"])
                                    for r in records):
        raise AssertionError(f"render records {records}")
    return rec.inputs, rec.counts, scene, params


def render_subdiv(data):
    """The post-subdivision scale: the bundled carved snapshot (saved by
    the JAX package), split 1->8, then RENDER_SUBDIV_STEPS mov-stage steps
    against the protocol images and one timed full frame.  The snapshot
    is not of the protocol scene, so its PSNR means nothing."""
    from deftet_tpu_torch.ops import _cuda
    from deftet_tpu_torch.render import optimize as ro
    from deftet_tpu_torch.render.scene import TetScene

    scene, params = TetScene.load_state(str(SUBDIV_SCENE), device=DEVICE)
    n0 = scene.n_tets
    params = scene.subdivide(params)
    if scene.n_tets != 8 * n0:
        raise AssertionError(f"subdivision gave {scene.n_tets} tets")
    cfg = ro.RenderOptConfig()
    images, poses, hwf, (i_train, _, i_test) = data
    step_log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    with hit_recorder() as rec:
        params, hist, info = ro.optimize_stage(
            scene, params, images, poses, hwf, i_train, cfg, gridmov=True,
            steps=RENDER_SUBDIV_STEPS, log=None, step_log=step_log)
        frame_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            color, vis = ro.render_full_image(scene, params,
                                              poses[int(i_test[0])], hwf,
                                              cfg)
            frame_s.append(time.perf_counter() - t)
    launches = dict(_cuda.launch_counts)
    say("render_subdiv", tets=[n0, scene.n_tets],
        faces=int(scene.faces_fx3.shape[0]), info=info,
        median_step_s=_median_steps(step_log), history=hist,
        frame_s=frame_s, launches=launches, launches_by_path=rec.counts,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        note="the snapshot is not of the protocol scene: no PSNR is "
             "meaningful here")
    if launches["raster_hit"] == 0 or not np.isfinite(hist).all() or \
            not np.isfinite(color).all():
        raise AssertionError("render_subdiv: no launch or non-finite output")
    return rec.inputs, rec.counts


def render_split(data, steps=5):
    """One res-40 training step split into its parts, each ended by a
    synchronisation (host clock): projection and candidate lists (up to
    the kernel's launch), the hit kernel, replay and composite (with the
    loss), backward, the Adam update; medians of ``steps`` steps after a
    warm-up.  Then one full frame: the face arrays and host projection,
    host build_frame_bins, the kernel, the replay."""
    from deftet_tpu_torch.render import frame as rf
    from deftet_tpu_torch.render import optimize as ro
    from deftet_tpu_torch.render import raster
    from deftet_tpu_torch.render.scene import TetScene
    from deftet_tpu_torch.tetgrid import build_tet_grid
    from deftet_tpu_torch.train.step import ClippedAdam

    images, poses, (h, w, focal), (i_train, _, i_test) = data
    cfg = ro.RenderOptConfig()
    scene = TetScene.from_grid(build_tet_grid(cfg.tet_res), coef=cfg.coef,
                               device=DEVICE)
    params = scene.init_params()
    cams = [ro.camera_from_blender(p, focal, h, w) for p in poses]
    grid = ro.pixel_grid(h, w)
    n_pix = int(cfg.pixel_sampling * h * w)
    tile_w, n_tiles = ro._tile_mode(cfg, h, w, n_pix)
    cal = dataclasses.replace(
        cfg, bin_cand=ro.calibrate_bin_cand(scene, params, cams, i_train[:3],
                                            grid, n_pix, cfg, hw=(h, w)),
        k=ro.calibrate_peel_k(scene, params, cams, i_train[:2], grid, n_pix,
                              cfg, hw=(h, w)))
    opt_f = ClippedAdam([params["feat"]], cfg.lr_feat, None, b1=0.5,
                        b2=0.999)
    opt_m = ClippedAdam([params["mov"]], cfg.lr_mov, None, b1=0.5, b2=0.999)
    step = ro.make_render_step(scene, ro.DEFAULT_WEIGHTS, True, cal, opt_f,
                               opt_m, pixel_chunk=tile_w * tile_w or None,
                               bin_sort=not tile_w)
    layout = (rf.tile_pixel_layout(h, w, tile_w)[0] if tile_w else
              np.arange(h * w)[:, None])
    n_tiles = n_tiles or n_pix
    gt_color, gt_mask = ro._white_composite(images)
    rng = np.random.default_rng(11)
    marks = {}

    def mark(name):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()

    def wrapped(fn, before, after):
        def call(*a, **kw):
            mark(before)
            out = fn(*a, **kw)
            mark(after)
            return out
        return call

    orig_hit, orig_grad = raster._raster_hit_cuda, torch.autograd.grad
    parts = {k: [] for k in ("projection_lists", "hit_kernel",
                             "replay_composite", "backward", "adam")}
    try:
        raster._raster_hit_cuda = wrapped(orig_hit, "hit0", "hit1")
        torch.autograd.grad = wrapped(orig_grad, "bwd0", "bwd1")
        for i in range(1 + steps):
            view = int(i_train[rng.integers(len(i_train))])
            pick = layout[rng.choice(layout.shape[0], size=n_tiles,
                                     replace=False)].reshape(-1)
            args = (torch.as_tensor(grid[pick], device=DEVICE)[None],
                    *cams[view],
                    torch.as_tensor(gt_color[view].reshape(-1, 3)[pick],
                                    device=DEVICE)[None],
                    torch.as_tensor(gt_mask[view].reshape(-1, 1)[pick],
                                    device=DEVICE)[None])
            mark("start")
            step(params, *args)
            mark("end")
            if i:
                for name, (a, b) in (("projection_lists", ("start", "hit0")),
                                     ("hit_kernel", ("hit0", "hit1")),
                                     ("replay_composite", ("hit1", "bwd0")),
                                     ("backward", ("bwd0", "bwd1")),
                                     ("adam", ("bwd1", "end"))):
                    parts[name].append(marks[b] - marks[a])
    finally:
        raster._raster_hit_cuda = orig_hit
        torch.autograd.grad = orig_grad
    step_parts = {k: statistics.median(v) for k, v in parts.items()}

    cam = cams[int(i_test[0])]
    frame = {}
    for _ in range(2):  # the second one counts
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            fz, fi, ff = scene.face_arrays(params, *cam)
        face_np = ro.project_faces_np(scene, params, cam)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bins = rf.build_frame_bins(face_np, h, w, cfg.frame_tile)
        lin, pix = rf.frame_pixels(h, w, cfg.frame_tile)
        t2 = time.perf_counter()
        ids, counts = rf.frame_hits(fz, fi, bins, pix, cfg.frame_tile, cfg.k)
        k_used = rf.peel_depth(counts, cfg.k)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        color, vis = rf.frame_replay(ids[:, :k_used], pix, fi, ff)
        color.cpu()
        t4 = time.perf_counter()
        frame = {"face_arrays_and_host_projection": t1 - t,
                 "host_build_frame_bins": t2 - t1,
                 "hit_kernel": t3 - t2, "replay": t4 - t3,
                 "total": t4 - t, "k_used": k_used,
                 "max_hits": int(counts.max()),
                 "candidates": int(bins[0][-1])}
    say("render_split", config=f"res {cfg.tet_res}, {n_tiles} tiles of "
        f"{tile_w}x{tile_w}, bin_cand {cal.bin_cand}, k {cal.k}",
        step_s=step_parts, step_total_s=sum(step_parts.values()),
        frame_s=frame)


def hit_stats(args, counts):
    """(pairs, tile candidates, hits, kept) of one raster_hit call."""
    pix, ranges, face_z, face_img, cand, offsets, tile_pixels, k = args
    t = offsets.shape[0] - 1
    lengths = (offsets[1:] - offsets[:-1]).long()
    tile_of = torch.repeat_interleave(torch.arange(t, device=cand.device),
                                      lengths)
    valid = torch.bincount(tile_of[cand[offsets[0]:offsets[0]
                                        + tile_of.shape[0]] >= 0],
                           minlength=t)
    pixels = torch.full((t,), tile_pixels, dtype=torch.int64,
                        device=cand.device)
    pixels[-1] = pix.shape[0] - (t - 1) * tile_pixels
    return (int((valid * pixels).sum()), int(valid.sum()),
            int(counts.sum()), int(counts.clamp(max=k).sum()))


def check_raster_hit(args, label, reps=10):
    """raster_hit on one call's inputs of a path against its plain version
    on the card: ids, z and counts equal (torch.equal).  Timed beside its
    bound: the pair tests' flops at the float32 rate without FMA, or the
    bytes, the larger.  The bytes are what the call needs: the pixels and
    ranges, the valid list entries and the distinct faces they name, read
    once, and the (P, k) rows and counts written once."""
    from deftet_tpu_torch.render import raster

    ids, z, counts = raster.raster_hit(*args)
    ids_p, z_p, counts_p = raster.raster_hit_plain(*args)
    equal = (torch.equal(ids, ids_p) and torch.equal(z, z_p)
             and torch.equal(counts, counts_p))
    if not equal:
        raise AssertionError(
            f"raster_hit {label}: {int((ids != ids_p).sum())} ids, "
            f"{int((counts != counts_p).sum())} counts differ")
    ms = cuda_ms(lambda: raster.raster_hit(*args), reps)
    plain_ms = cuda_ms(lambda: raster.raster_hit_plain(*args), 1)
    pix, ranges, face_z, face_img, cand, offsets, tile_pixels, k = args
    pairs, tile_faces, hits, kept = hit_stats(args, counts)
    p = pix.shape[0]
    listed = cand[int(offsets[0]):int(offsets[-1])]
    n_faces = int(torch.unique(listed[listed >= 0]).numel())
    n_bytes = (16 * p + 36 * n_faces + 4 * tile_faces
               + 8 * offsets.numel() + 8 * p * k + 4 * p)
    n_flops = (HIT_PAIR_FLOPS * pairs + HIT_Z_FLOPS * hits
               + HIT_FACE_FLOPS * tile_faces)
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / PEAK_F32_NO_FMA
    bms = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    shape = (f"{p} pixels, {offsets.numel() - 1} tiles of {tile_pixels}, "
             f"{face_z.shape[0]} faces, {cand.numel()} list entries, k {k}")
    say(label, shape=shape, pairs=pairs, hits=hits, kept=kept,
        insertion_bound=hits * k, max_hits=int(counts.max()),
        valid_entries=tile_faces, distinct_faces=n_faces, bytes=n_bytes,
        flops=n_flops, ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        fma_peak_bound_ms=n_flops / PEAK_F32 * 1e3, share=bms / ms,
        equal=equal)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, max_abs_err=0.0, shape=shape, pairs=pairs,
                hits=hits, insertion_work=hits * k)


def check_raster_edge_cases(device=DEVICE):
    """raster_hit where the main path does not reach, each case equal to
    the plain version (ids, z, counts) and to what it must give:

    * 40 stacked faces over every pixel, k 8: the 8 nearest kept, counts 40;
    * the same stack at k 0 (a calibration's count-only call, 300 pixels
      in tiles of 128): no rows, counts 40;
    * 5 copies of one face (equal z): lower ids first;
    * -1 slots in a list, and an empty list (fill values, count 0);
    * zero-area faces (a point, a segment): the guarded division;
    * pixels exactly on the edge two faces share;
    * per-pixel z ranges that cut the stack;
    * P not a multiple of the tile (1,000 pixels, tiles of 256)."""
    from deftet_tpu_torch.render import raster

    gen = torch.Generator(device="cpu").manual_seed(9)

    def uniform(*shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(*shape, generator=gen)).to(device)

    big = torch.tensor([[-1.0, -1.0], [3.0, -1.0], [-1.0, 3.0]],
                       device=device)
    cases = {}
    # stacked: 40 big faces at distinct z, 300 random pixels in them
    z = -torch.arange(1, 41, dtype=torch.float32, device=device)
    z = z[torch.randperm(40, generator=gen).to(device)]
    cases["truncation"] = (uniform(300, 2, lo=-0.9, hi=0.9),
                           z[:, None].expand(40, 3), big.expand(40, 3, 2),
                           None, 128, 8)
    cases["count_only"] = cases["truncation"][:5] + (0,)
    # copies of one face at equal z, list ascending
    cases["duplicates"] = (uniform(64, 2, lo=-0.9, hi=0.9),
                           torch.full((5, 3), -2.0, device=device),
                           big.expand(5, 3, 2), None, 64, 4)
    # -1 slots and an empty list: tiles [0..3 with -1s], [empty], [2]
    cases["slots_empty"] = (uniform(30, 2, lo=-0.9, hi=0.9),
                            -uniform(4, 3, lo=1.0, hi=5.0),
                            big.expand(4, 3, 2),
                            (torch.tensor([0, -1, 1, -1, 3, -1, 2]),
                             torch.tensor([0, 6, 6, 7])), 10, 4)
    # zero-area faces among normal ones
    deg = torch.stack([big, big[[0, 0, 0]], big[[0, 1, 1]],
                       torch.tensor([[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
                                    device=device)])
    cases["zero_area"] = (torch.cat([uniform(60, 2),
                                     torch.zeros(4, 2, device=device)]),
                          -uniform(4, 3, lo=1.0, hi=5.0), deg, None, 64, 4)
    # two faces sharing the edge x = 0, pixels exactly on it
    shared = torch.tensor([[[0.0, -1.0], [0.0, 1.0], [-1.0, 0.0]],
                           [[0.0, -1.0], [1.0, 0.0], [0.0, 1.0]]],
                          device=device)
    on_edge = torch.stack([torch.zeros(33, device=device),
                           torch.linspace(-1, 1, 33, device=device)], 1)
    cases["shared_edge"] = (on_edge, torch.tensor([[-2.0] * 3, [-3.0] * 3],
                                                  device=device),
                            shared, None, 33, 4)
    # random faces, P = 1000 not a multiple of 256, random z ranges
    n = 500
    centre = uniform(n, 1, 2)
    tri = centre + 0.3 * uniform(n, 3, 2)
    pix = uniform(1000, 2)
    lo = -uniform(1000, 1, lo=1.5, hi=6.0)
    cases["ragged_ranges"] = (pix, -uniform(n, 3, lo=1.0, hi=5.0), tri,
                              None, 256, 16, torch.cat([lo, lo + 2.0], 1))
    # what each case must give besides equality with the plain version
    nearest8 = torch.argsort(z, descending=True)[:8].to(torch.int32)
    expect = {
        "truncation": lambda ids, zs, c: bool((c == 40).all())
        and torch.equal(ids, nearest8.expand_as(ids)),
        "count_only": lambda ids, zs, c: bool((c == 40).all())
        and ids.shape == zs.shape == (300, 0),
        "duplicates": lambda ids, zs, c: bool((c == 5).all()) and torch.equal(
            ids, torch.arange(4, dtype=torch.int32,
                              device=device).expand_as(ids)),
        "slots_empty": lambda ids, zs, c: bool((c[10:20] == 0).all())
        and bool((ids[10:20] == -1).all()) and bool((c[:10] == 3).all()),
        "shared_edge": lambda ids, zs, c: bool((c[1:-1] == 2).all()),
    }
    report = {}
    for name, case in cases.items():
        pix, fz, fi, lists, tile, k = case[:6]
        ranges = case[6] if len(case) > 6 else torch.tensor(
            [[-1000.0, 0.0]], device=device).expand(pix.shape[0], 2)
        t = -(-pix.shape[0] // tile)
        if lists is None:  # each tile: every face, ascending
            f = fz.shape[0]
            cand = torch.arange(f, dtype=torch.int32,
                                device=device).repeat(t)
            offsets = torch.arange(t + 1, device=device) * f
        else:
            cand, offsets = (x.to(device) for x in lists)
        args = (pix.contiguous(), ranges.contiguous(), fz.contiguous(),
                fi.contiguous(), cand.to(torch.int32), offsets, tile, k)
        out = raster.raster_hit(*args)
        ref = raster.raster_hit_plain(*args)
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"raster_hit edge case {name} differs")
        if name in expect and not expect[name](*out):
            raise AssertionError(f"raster_hit edge case {name}: wrong "
                                 f"result {out}")
        report[name] = {"pixels": pix.shape[0], "k": k,
                        "max_hits": int(out[2].max()),
                        "kept": int((out[0] >= 0).sum())}
    say("kernel_raster_hit_edge_cases", cases=report)


RENDER_CLI = ["render", "--synthetic", "--image_size", "64", "--n_views",
              "8", "--tetres", "8", "--sublevel", "1", "--optmovnum", "6",
              "--optfixnum", "6", "--deletenum", "3", "--savedir",
              "build/smoke_render"]


def render_cli():
    """``python -m deftet_tpu_torch.cli render`` on the card in a
    subprocess: exits 0 and writes records.json, surface.obj and the
    turntable (an .npz of frames where no video writer is installed)."""
    import shutil

    work = ROOT / "build" / "smoke_render"
    shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "deftet_tpu_torch.cli",
                          *RENDER_CLI], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"cli render exited {out.returncode}:\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    outdir = work / "scene"
    names = sorted(p.name for p in outdir.iterdir())
    records = json.loads((outdir / "records.json").read_text())
    turntable = [n for n in names if n.startswith("rgb-")]
    say("render_cli", seconds=time.perf_counter() - t, files=names,
        records=records)
    if "surface.obj" not in names or not turntable or not np.isfinite(
            records["final_psnr"]):
        raise AssertionError(f"cli render wrote {names}")


def kernel_entry(name, res, launches, path):
    source, replaces = KERNEL_INFO[name]
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
        "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"], "library_ms": res["library_ms"],
        "shape": res["shape"], "path": path,
    }
    for extra in ("step_ms", "no_fma_ceiling_ms", "launches_per_run",
                  "pairs", "hits", "insertion_work"):
        if extra in res:
            entry[extra] = res[extra]
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import deftet_tpu_torch

    if Path(deftet_tpu_torch.__file__).resolve().parents[1] != ROOT:
        raise RuntimeError("deftet_tpu_torch must come from this checkout")

    t0 = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    smi = timed("header", header)
    timed("build", build)
    timed("parity", parity)
    timed("parity_train", parity_train)
    timed("parity_eval", parity_eval)
    inputs, launches, per_variant, engine = timed("main", main_path,
                                                  bench_config())
    ev = timed("eval", eval_phase, engine)
    del engine
    torch.cuda.empty_cache()
    results = timed("kernels", lambda: {
        "stencil": check_stencil(inputs, per_variant),
        "nearest": check_nearest(inputs[("nearest",)]),
        "tri_argmin": check_tri_argmin(inputs[("tri_argmin",)]),
    })
    nearest_eval = timed("kernel_nearest_eval", check_nearest_eval)
    eval_kernels = timed("eval_kernels", check_eval_kernels, ev)
    paper_inputs, paper_per_step, paper_rows = timed("paper_step", paper_step)
    paper_kernels = timed("paper_kernels", check_paper_kernels, paper_inputs,
                          paper_per_step)
    timed("edge_cases", check_edge_cases)
    timed("cli", cli_phase)
    timed("render_parity", render_parity)
    data = timed("render_scene", protocol_scene)
    r_inputs, r_counts, _, _ = timed("render", render_phase, data)
    torch.cuda.empty_cache()
    s_inputs, s_counts = timed("render_subdiv", render_subdiv, data)
    timed("render_split", render_split, data)
    raster_rows = timed("kernel_raster_hit", lambda: {
        "train": check_raster_hit(r_inputs["train"],
                                  "kernel_raster_hit_train"),
        "frame": check_raster_hit(r_inputs["frame"],
                                  "kernel_raster_hit_frame"),
        "count": check_raster_hit(r_inputs["count"],
                                  "kernel_raster_hit_count"),
        "subdiv": check_raster_hit(s_inputs["frame"],
                                   "kernel_raster_hit_subdiv"),
    })
    timed("raster_edge_cases", check_raster_edge_cases)
    timed("render_cli", render_cli)

    kernels = []
    for name, res in results.items():
        kernels.append(kernel_entry(name, res, launches[name], "main"))
        if name == "nearest":
            kernels[-1]["eval_shape"] = {
                k: nearest_eval[k] for k in ("shape", "ms", "plain_ms",
                                             "bound_ms", "no_fma_ceiling_ms",
                                             "plan")}
    for name, res in paper_kernels.items():
        kernels.append(kernel_entry(
            name, res, paper_rows[False]["launches_total"][name],
            "paper_step (res 70, batch 8, grad_accum 2, no remat)"))
    kernels.append(kernel_entry("stencil", eval_kernels["stencil"],
                                ev["launches"]["stencil"], "eval"))
    kernels.append(kernel_entry("nearest", eval_kernels["nearest"],
                                ev["launches"]["nearest"], "eval"))
    for side, res in eval_kernels["tri_argmin"].items():
        kernels.append(kernel_entry("tri_argmin", res,
                                    ev["launches"]["tri_argmin"],
                                    f"eval: Hausdorff {side}"))
    for path, res, n in (
            ("render: training step, res 40, 25 tiles of 16x16",
             raster_rows["train"], r_counts["train"]),
            ("render: full frame 400x400, k 300", raster_rows["frame"],
             r_counts["frame"]),
            ("render: calibration count (k 0), one unbinned tile against "
             "every face", raster_rows["count"],
             r_counts["count"]),
            ("render_subdiv: full frame of the subdivided snapshot",
             raster_rows["subdiv"], s_counts["frame"])):
        kernels.append(kernel_entry("raster_hit", res, n, path))
    say("done", seconds=time.perf_counter() - t0, phase_seconds=phase_s,
        card=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
