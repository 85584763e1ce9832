"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on lines of its own:

1. header  — torch / CUDA versions and the card's name and power limit;
2. build   — the six CUDA kernels (csrc/*.cu), compiled anew, in parallel;
3. parity  — the small configuration in float32: one forward + backward on
   the CPU (plain PyTorch versions of the kernels) and one on the card
   (the kernels), from the same parameters and injected draws;
   parity_train — two res-4 steps with grad_accum=2, remat and the cosine
   lr, card against CPU, and on the card remat's gradients against none;
   parity_eval — the res-4 inference step, card against CPU;
   parity_lap_disn — two res-4 f32 steps, card against CPU, with the lap
   layer, with DISN at the tests' tiny width, and with both and remat;
   parity_gather — two res-4 f32 steps, card against CPU, on a res-2 grid
   split 1->8 (not a lattice, read from a .tet file) at the default
   budget and at max_boundary_faces=0 and on the res-4 lattice at budget
   0, then one inference step on the split grid;
   parity_se — the main cell's encoder (DEFAULT_BLOCKS, batch 4, 5,000
   points) with squeeze-excitation and without, one forward + backward in
   float32, card against CPU; the bf16 encoder timed with and without SE;
   lap_step — bench.py's configuration with the lap layer through
   ``Engine``: one warm-up and five timed steps (18 K1 launches each),
   the lap head's K1 inputs kept apart, then K1 checked at them;
   disn_step — bench.py's configuration with DISN at its default widths
   (VGG-16, 64 x 64 images rendered by make_example): six steps, the
   bytes each segment saves, a full-inference step at 100,000 points a
   side, then K1 (the Laplacian), K2 and K3 checked at its inputs;
4. main    — the full-width res-50 / batch-4 train step (bench.py's
   configuration, bf16) through ``Engine``: one warm-up step and five
   timed steps, launch counts per kernel read around them;
   eval — that engine's full-inference evaluation at 100,000 points a
   side (validate, validate_inference, timed inference steps), then the
   point-in-tet kernel at its inputs (4 x 20,000 SDF points against
   750,000 deformed tets) against the plain scan index for index: ms,
   bound, the plain scan's ms, the kernel's stats record; then the
   grid-probe kernel at the full-grid occupancy's calls (8 chunks of 4 x
   100,000 tet centres) against its plain version bit for bit: ms a
   step, bound, share, the plain version's ms, launches a step;
   uncompacted_step — the main path's configuration at
   max_boundary_faces=0 (the surface terms over every face: K2 over 1.5M
   samples, K3 against every face under the boundary mask), the statics'
   set-up with and without the edge arrays; then K2 and K3 checked at
   its inputs; gather_step — the main path's configuration on the res-25
   grid split 1->8 (750,000 tets, written and read as a .tet file)
   through Engine(config, statics=...): the gather paths, no K1 launch;
   gather_eval — one inference step on that grid at 100,000 points a
   side, and the point-in-tet and grid-probe kernels checked at its
   inputs as in eval (the probe's centres in the split grid's order);
   native_topology — the native (g++) topology builders on that
   grid: build and host seconds beside numpy's, every array held equal,
   and one step on statics from each topology (K2 and K3 once, no K1);
   lattice_statics — the res-50 lattice topology through the native and
   the numpy builders, with and without the face arrays: host seconds,
   every field equal, and the builders ``build_grid_statics`` took;
   then K2 and K3 checked at the gather step's inputs;
5. kernels — each kernel on the inputs the main path gave it, held
   against its plain version on the card and timed beside its bound and
   the nearest single PyTorch call (every K1 variant of the step, with
   their launch-weighted total per step), K2 also at the eval metrics'
   shape (100,000 against 100,000 points), then K1-K3 at the inference
   step's inputs; point_tet_edge_cases — the point-in-tet kernel against
   the plain scan on adversarial grids and queries (point_tet_cases);
   grid_probe_cases — the grid-probe kernel against its plain version,
   bit for bit, on grid_probe_cases;
   ddp_parity — two ranks sharing the card (gloo over CUDA tensors) take
   one res-4 f32 step with dropout, and one with grad_accum=2 and remat,
   held to the one-process step on the card (terms rtol 2e-4, gradients
   2e-3); then a one-rank NCCL world against an Engine without a world,
   bit for bit; ddp_step — the main path's configuration as two ranks of
   2 rows on the one card: per rank one warm-up and five timed steps,
   their launches (K1 10, K2 1, K3 1), peak memory, then K1-K3 checked at
   rank 0's inputs (two processes share the card: not a scaling number);
   dryrun — ``dryrun.entry()`` against the CPU, ``dryrun_multidevice(2)``;
   sampling — FPS, ball query and 3-NN on the card against the CPU at 2 x
   16,384 points and 1,024 centers, timed;
6. paper_step — bench.py's paper recipe (res 70, batch 8, grad_accum=2)
   with and without remat (which must lower the peak memory), the bytes
   each remat segment saves, and K1-K3 at its inputs; then the kernels'
   edge cases;
7. cli     — ``python -m deftet_tpu_torch.cli train`` then ``eval`` in
   subprocesses, and a restored engine's step against the uninterrupted
   one's; then ``preprocess --with_images`` over the bundled meshes,
   ``train --use_disn --use_lap_layer --mesh_dir`` and ``eval``;
8. the 2D-supervision renderer: render_parity (a small scene's mov and
   fix stages and one frame, card against CPU); render (the full-width
   protocol scene through run_pipeline: res-40 grid, k 300, carves,
   carve_and_subdivide at the real tet budget, four test-PSNR
   evaluations); render_subdiv (the bundled carved snapshot split 1->8,
   20 steps and a frame); render_split (one step and one frame split into
   their parts); kernel_raster_hit (the hit kernel against its plain
   version at each path's inputs, the first and the last training call
   among them, and at edge cases, timed against its bound); render_cli
   (``cli render`` in a subprocess);
   campaigns — ``scripts/torch_{disn,hard_geom,render}_campaign.py`` at
   toy sizes, at once in subprocesses: exit 0 and finite metrics;
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
                     "raster_hit": 0, "point_tet": 0,
                     "grid_probe": 0}
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
    # replaces XLA code: the JAX package's scan of every (point, tet) pair
    "point_tet": ("deftet_tpu_torch/csrc/point_tet.cu",
                  "deftet_tpu/ops/point_tet.py:28"),
    # replaces XLA code: the pyramid probe's gathers, products and sums
    "grid_probe": ("deftet_tpu_torch/csrc/grid_probe.cu",
                   "deftet_tpu/nn/model.py:34"),
}


def say(phase: str, **fields) -> None:
    # one write a line: ranks sharing this stdout do not split each other's
    sys.stdout.write(json.dumps({"phase": phase, **fields}) + "\n")
    sys.stdout.flush()


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


STEP_MEDIANS = {}  # label -> median step seconds of main_path's runs


def main_path(config, device="cuda", occ_res=64,
              expected=LAUNCHES_PER_STEP, label="main", key_fn=variant_key,
              batch=None, statics=None):
    """The train step through the port's Engine (on ``statics`` where
    given): one warm-up and TIMED_STEPS timed steps, on bench.py's batch
    (or ``batch``, numpy), each step's launches held to ``expected``."""
    from deftet_tpu_torch.ops import _cuda
    from deftet_tpu_torch.train import Engine

    t0 = time.perf_counter()
    engine = Engine(config, device=device, statics=statics)
    t_engine = time.perf_counter() - t0
    b = config.batch_size
    batch = engine._prep_batch(batch if batch is not None else
                               bench_batch(config, occ_res=occ_res))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    step_s, per_step = [], []
    with Recorder(key_fn) as rec:
        for step in range(1 + TIMED_STEPS):
            _cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            terms = engine.train_step(batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts = dict(_cuda.launch_counts)
            terms = {k: float(v) for k, v in terms.items()}
            say(f"{label}_step", step=step, warmup=step == 0, seconds=dt,
                launches=counts, terms=terms)
            bad = [k for k, v in terms.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"non-finite loss terms: {bad}")
            if counts != expected:
                raise AssertionError(
                    f"launches {counts} != expected {expected}")
            per_step.append(counts)
            if step:
                step_s.append(dt)
    launches = {k: sum(c[k] for c in per_step) for k in expected}
    STEP_MEDIANS[label] = statistics.median(step_s)
    say(label, config=f"res={config.res} batch={b} {config.precision}",
        engine_init_s=t_engine, steps=TIMED_STEPS,
        median_step_s=statistics.median(step_s), step_s=step_s,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        launches_total=launches, launches_per_step=expected)
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


def stencil_launches():
    """check_stencil_launches on inputs of the main path's GCN shape
    (bf16, 4 x 51^3 x 256, the lattice's 14 offsets), run first in the
    process: on an H100 (torch 2.11) torch.profiler recorded no device
    events in sessions that followed the kernel checks' cdist calls (16
    GB matrices) in the same process."""
    from deftet_tpu_torch.ops import stencil
    from deftet_tpu_torch.tetgrid import build_tet_grid
    from deftet_tpu_torch.train.statics import lattice_offsets

    n = bench_config().res + 1
    offsets = lattice_offsets(build_tet_grid(2))
    g = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randn((4, n**3, 256), generator=g, device=DEVICE).to(
        torch.bfloat16)
    inv_deg = 1.0 / torch.randint(1, 15, (n**3,), generator=g,
                                  device=DEVICE).float()
    # one forward and backward first: the first launch for a lattice also
    # copies its offset table to the card
    xg = x.detach().requires_grad_()
    y = stencil.lattice_neighbor_mean(xg, inv_deg, n, offsets)
    torch.autograd.grad(y, xg, torch.ones_like(y))
    kernels = check_stencil_launches(x, n, offsets, inv_deg)
    say("stencil_launches", shape=list(x.shape), kernels=kernels)


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
                  row_key=("stencil", "bfloat16", 256, "forward")):
    """Every K1 variant of a path, plus the bf16 GCN inputs in f32 (the
    precision="f32" path), against the plain version: equal bit for bit
    (same f32 sums in the same order, same roundings).  Each of the
    path's variants is timed beside its bound, its plain version and the
    depthwise conv3d that computes the same function; their times
    weighted by launches per step give K1's device time per step."""
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
                       plain_ms=cuda_ms(lambda: stencil.stencil_sum_plain(
                           x, n, offsets, scale, in_scale), 3),
                       library_ms=cuda_ms(library, 10),
                       library_max_abs_err=lib_err)
            step_ms += ms * per_step[key]
        report["/".join(map(str, key[1:]))] = row

    # the kernels line reports ``row_key``: the dominant call, the GCN
    # forward at C = 256 (the Laplacian's forward where the path has no GCN)
    x, n, offsets, scale, _ = cases[row_key]
    fwd = report["/".join(map(str, row_key[1:]))]
    plain_ms = cuda_ms(
        lambda: stencil.stencil_sum_plain(x, n, offsets, scale), 3)
    worst = max(r["max_abs_err"] for r in report.values())
    say(label, variants=report, step_ms=step_ms)
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


def check_tri_argmin(args, label="kernel_tri_argmin", reps=20,
                     plain_points=None):
    """K3 on one call's inputs of a path against the plain version: the
    same index for every point (same region order and arithmetic, no FMA
    contraction, ties to the lowest index), hence the same distance at
    it.  With ``plain_points`` the plain version (timed once, by that same
    run) covers the first ``plain_points`` points of each batch element
    only; the kernel still runs on every point."""
    from deftet_tpu_torch.ops import tri_distance

    pts, tri, mask, n_active = args
    # the plain version's (points, faces) temporaries at most 2^26 floats
    chunk = max(1, min(1024, (1 << 26) // max(tri.shape[1], 1)))

    def d2_at(p, idx):
        sel = torch.gather(tri, 1, idx.long()[:, :, None, None].expand(
            -1, -1, 3, 3))
        return tri_distance.point_triangle_squared_distance(
            p, sel[..., 0, :], sel[..., 1, :], sel[..., 2, :])

    i = tri_distance.tri_argmin(pts, tri, mask)
    if plain_points is None:
        i_ref = tri_distance.tri_argmin_plain(pts, tri, mask, n_active,
                                              chunk)
        plain_pts = pts
    else:
        plain_pts = pts[:, :plain_points].contiguous()
        i = i[:, :plain_points]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        i_ref = tri_distance.tri_argmin_plain(plain_pts, tri, mask, n_active,
                                              chunk)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
    d, d_ref = d2_at(plain_pts, i), d2_at(plain_pts, i_ref)
    err = float((d - d_ref).abs().max())
    n_diff = int((i != i_ref).sum())
    if n_diff or err:
        raise AssertionError(
            f"tri_argmin {label}: {n_diff} indices differ, distance err "
            f"{err}")

    ms = cuda_ms(lambda: tri_distance.tri_argmin(pts, tri, mask), reps)
    if plain_points is None:
        plain_ms = cuda_ms(
            lambda: tri_distance.tri_argmin_plain(pts, tri, mask, n_active,
                                                  chunk),
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
        flops_per_pair=n_flops / pairs, plain_points=plain_points,
        # built with -fmad=false: no instruction does two flops, so the
        # float32 ceiling is half the peak the bound assumes
        no_fma_ceiling_ms=2 * bms)
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=None, max_abs_err=err, no_fma_ceiling_ms=2 * bms,
               shape=f"points {list(pts.shape)} faces {list(tri.shape)} f32")
    if plain_points is not None:
        out["plain_points"] = plain_points
    return out


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


def step_draws(cfg, rng, batch_size, n_faces=None):
    """One microbatch's injected draws (numpy): input noise, the center
    subsample and the chamfer barycentrics, over the compacted working set
    or, at budget 0 on a grid of ``n_faces`` faces, over every face."""
    k = cfg.resolved_max_boundary_faces() or n_faces
    per_face = cfg.per_face_samples
    if cfg.chamfer_samples_cap > 0:
        per_face = max(1, min(per_face, cfg.chamfer_samples_cap // k))
    bary = (batch_size, k, per_face, 1)
    return {"noise": rng.normal(size=(batch_size, cfg.n_point, 3)),
            "center_idx": rng.integers(0, 6 * cfg.res**3, cfg.occ_sample),
            "bary_u": rng.uniform(size=bary),
            "bary_v": rng.uniform(size=bary)}


def train_runs(cfg, batch, draws, devices, statics=None):
    """(initial state, {device: run}): on each device an engine (on
    ``statics`` where given) from the first device's initial parameters
    takes one train step per entry of ``draws`` (a dict, or a list of one
    per microbatch); a run holds the terms and BatchNorm statistics after
    each step, each parameter's update and Adam's first moment."""
    from deftet_tpu_torch.train import Engine

    state, runs = None, {}
    for device in devices:
        engine = Engine(cfg, device=device, statics=statics)
        if state is None:
            state = {n: v.clone() for n, v in
                     engine.model.state_dict().items()}
        engine.model.load_state_dict(state)
        prepped = engine._prep_batch(batch)
        terms, stats = [], []
        for step in draws:
            d = ([on_device(x, device) for x in step]
                 if isinstance(step, list) else on_device(step, device))
            t = engine.train_step(prepped, draws=d)
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
    return state, runs


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
    mb = cfg.batch_size // cfg.grad_accum
    draws = [[step_draws(cfg, rng, mb) for _ in range(cfg.grad_accum)]
             for _ in range(2)]
    batch = bench_batch(cfg, level=1, occ_res=16)
    state, runs = train_runs(cfg, batch, draws, devices)
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

        if use_remat:
            with remat.segmented(engine.generator):
                total, _ = loss()
        else:
            total, _ = loss()
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


def eval_batch(seeds, n_surface, n_sdf, level, occ_res, with_image=False):
    """Records of the port's make_example for random_shape(seed, level),
    padded as ShapeDataset pads them (numpy); with an image and camera
    each if ``with_image`` (drawn after the rest, which is unchanged)."""
    from deftet_tpu_torch.data.pipeline import make_example
    from deftet_tpu_torch.data.shapes import random_shape, shape_family

    exs = []
    for seed in seeds:
        verts, faces = random_shape(seed, level=level)
        exs.append(make_example(verts, faces, n_surface, n_sdf,
                                np.random.default_rng(seed),
                                occ_grid_res=occ_res, with_image=with_image))
    b = len(exs)
    nv = max(e["verts"].shape[0] for e in exs)
    nf = max(e["faces"].shape[0] for e in exs)
    keys = ("surface_points", "sdf_points", "sdf", "occ_grid") + (
        ("imgs", "cam_matrix") if with_image else ())
    batch = {k: np.stack([e[k] for e in exs]) for k in keys}
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
                engine.model, prepped, engine.statics, cfg, noise=d["noise"])
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


# ------------------------------------------- the lap layer and DISN paths
DISN_TINY = dict(use_disn=True, disn_width=0.05, disn_encoding_dim=64,
                 disn_image_size=32, disn_local_feature_size=16)
# launches per full-width step: both GCN heads (4 + 4 forward, 4 + 4
# backward) and the Laplacian's forward and backward; DISN runs no GCN
LAP_LAUNCHES = {"stencil": 18, "nearest": 1, "tri_argmin": 1,
                "raster_hit": 0, "point_tet": 0,
                "grid_probe": 0}
DISN_LAUNCHES = {"stencil": 2, "nearest": 1, "tri_argmin": 1,
                 "raster_hit": 0, "point_tet": 0,
                 "grid_probe": 0}


def leaf_ratio(got, ref, rtol, atol) -> float:
    """||got - ref|| / (rtol ||ref|| + atol sqrt(n)): within tolerance when
    <= 1."""
    got, ref = (torch.as_tensor(x).double().cpu() for x in (got, ref))
    if not ref.numel():
        return 0.0
    return float(torch.linalg.norm(got - ref) / (
        rtol * torch.linalg.norm(ref) + atol * ref.numel() ** 0.5))


def image_batch(batch, seeds):
    """``batch`` (numpy) with the images and cameras that the port's
    make_example(with_image=True) renders of random_shape(0, level 2),
    bench_batch's shape, one camera per seed."""
    from deftet_tpu_torch.data.pipeline import make_example
    from deftet_tpu_torch.data.shapes import random_shape

    verts, faces = random_shape(0, level=2)
    exs = [make_example(verts, faces, 16, 16, np.random.default_rng(seed),
                        occ_grid_res=8, with_image=True) for seed in seeds]
    return dict(batch, imgs=np.stack([e["imgs"] for e in exs]),
                cam_matrix=np.stack([e["cam_matrix"] for e in exs]))


def parity_lap_disn(devices=("cpu", DEVICE)):
    """The card against the CPU at res 4 in float32, two train steps each
    from the same parameters and injected draws, on three configurations:
    the point path with the lap layer, DISN at the tests' tiny width, and
    DISN with the lap layer and remat.  parity_train's tolerances: terms
    rtol 1e-4 / atol 1e-6; Adam's first moment rtol 1e-3 / atol 1e-6; the
    live updates rtol 1e-3 / atol 1e-7 and every update within 3 lr a
    step; BatchNorm statistics rtol 1e-4 / atol 1e-6 (the running means
    of the second step within 2 lr).  As in the CPU tests of these paths
    (tests/test_torch_lap.py): the moments and updates are held per leaf
    in norm (a DISN decoder's ReLU input can sit within the devices'
    float32 difference of 0 and switch for one point), and the normal
    term's per-face fields run in float32 on both devices (in bf16 a
    field within that difference of a rounding boundary flips)."""
    from deftet_tpu_torch.losses import surface

    configs = {
        "lap": small_config(use_lap_layer=True),
        "disn": small_config(**DISN_TINY),
        "disn_lap_remat": small_config(use_lap_layer=True, remat=True,
                                       **DISN_TINY),
    }
    field_dtype = surface.NORMAL_FIELD_DTYPE
    surface.NORMAL_FIELD_DTYPE = torch.float32
    report = {}
    try:
        for name, cfg in configs.items():
            rng = np.random.default_rng(14)
            draws = [step_draws(cfg, rng, cfg.batch_size) for _ in range(2)]
            batch = bench_batch(cfg, level=1, occ_res=16)
            if cfg.use_disn:
                batch = image_batch(batch, range(cfg.batch_size))
            _, runs = train_runs(cfg, batch, draws, devices)
            cpu, gpu = (runs[d] for d in devices)
            noise = 3 * cfg.lr * len(draws)
            live = {n: cpu["mu"][n].abs() > 1e-6 for n in cpu["mu"]}
            worst = {
                "terms": max(ratio(g[n], c[n], 1e-4, 1e-6)
                             for g, c in zip(gpu["terms"], cpu["terms"])
                             for n in c),
                "mu": max(leaf_ratio(gpu["mu"][n], v, 1e-3, 1e-6)
                          for n, v in cpu["mu"].items()),
                "update": max(leaf_ratio(gpu["update"][n][live[n]],
                                         v[live[n]], 1e-3, 1e-7)
                              for n, v in cpu["update"].items()),
                "update_noise": max(
                    float((gpu["update"][n] - v).abs().max()) / noise
                    for n, v in cpu["update"].items()),
            }
            if cpu["stats"][0]:
                (s1, s2), (c1, c2) = gpu["stats"], cpu["stats"]
                worst["batch_stats_step1"] = max(
                    ratio(s1[n], v, 1e-4, 1e-6) for n, v in c1.items())
                worst["running_var_step2"] = max(
                    ratio(s2[n], v, 1e-4, 1e-6) for n, v in c2.items()
                    if "var" in n)
                worst["running_mean_step2"] = max(
                    ratio(s2[n], v, 0.0, 2 * cfg.lr) for n, v in c2.items()
                    if "mean" in n)
            report[name] = dict(worst_ratios=worst, terms_cuda=gpu["terms"],
                                terms_cpu=cpu["terms"])
    finally:
        surface.NORMAL_FIELD_DTYPE = field_dtype
    say("parity_lap_disn", **report)
    bad = {n: r["worst_ratios"] for n, r in report.items()
           if not all(v <= 1.0 for v in r["worst_ratios"].values())}
    if bad:
        raise AssertionError(f"lap / DISN parity failed: {bad}")


def lap_key():
    """variant_key, with the GCN stencil calls (bf16, C = 256) told apart
    by head: in a step the first head's four forwards come before the lap
    head's, and the lap head's four backwards before the first head's."""
    seen = {}

    def key(name, args):
        k = variant_key(name, args)
        if name != "stencil" or k[1:3] != ("bfloat16", 256):
            return k
        i = seen.get(k, 0)
        seen[k] = i + 1
        early = i % 8 < 4
        lap = not early if k[3] == "forward" else early
        return k + ("lap" if lap else "first",)
    return key


def lap_config():
    """bench.py's configuration with the lap layer."""
    cfg = bench_config()
    cfg.use_lap_layer = True
    return cfg


def lap_step():
    """The res-50 / batch-4 bf16 step with the lap layer through Engine:
    one warm-up and five timed steps, 18 K1 launches each; the lap head's
    K1 inputs kept apart from the first head's."""
    inputs, launches, per_variant, engine = main_path(
        lap_config(), device=DEVICE, expected=LAP_LAUNCHES,
        label="lap_step", key_fn=lap_key())
    del engine
    torch.cuda.empty_cache()
    return inputs, launches, per_variant


def check_lap_kernels(inputs, per_variant):
    """K1 at the lap path's inputs: the lap head's GCN forward and
    backward (C = 256) and the Laplacian's, exact against the plain
    version; the per-step time weights the lap head's calls by both
    heads' launches (the first head's inputs have the same shape)."""
    cases = {k[:4]: v for k, v in inputs.items()
             if k[0] == "stencil" and (len(k) == 4 or k[4] == "lap")}
    per_step = {}
    for k, c in per_variant.items():
        if k[0] == "stencil":
            per_step[k[:4]] = per_step.get(k[:4], 0) + c
    return check_stencil(cases, per_step, label="kernel_stencil_lap")


def disn_config():
    """bench.py's configuration with the DISN branch at its defaults:
    VGG-16 at full width, a 1,000-wide global code, 64 x 64 images and
    64 x 64 local maps."""
    cfg = bench_config()
    cfg.use_disn = True
    return cfg


def disn_step(eval_batch_np):
    """The res-50 / batch-4 step of the image-conditioned network through
    Engine on bench_batch's shape rendered from four cameras: one warm-up
    and five timed steps (K1 only for the Laplacian), the bytes each
    forward segment saves, then one full-inference step at 100,000 points a
    side on the eval batch with images (a first call, then a timed one,
    and its forward with the full-grid occupancy alone)."""
    from deftet_tpu_torch.evals import harness
    from deftet_tpu_torch.ops import _cuda

    cfg = disn_config()
    batch = image_batch(bench_batch(cfg, occ_res=64), range(cfg.batch_size))

    inputs, launches, per_variant, engine = main_path(
        cfg, device=DEVICE, expected=DISN_LAUNCHES, label="disn_step",
        batch=batch)
    say("disn_segments", saved_bytes_by_segment=segment_bytes(
        engine, engine._prep_batch(batch)))
    cfg.eval_points = EVAL_POINTS
    prepped = engine._prep_batch(eval_batch_np)
    infer = engine.inference_step()
    gen = torch.Generator(device=engine.device).manual_seed(cfg.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    out = {n: float(v) for n, v in infer(prepped, engine.statics,
                                         gen).items()}
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    infer_launches = dict(_cuda.launch_counts)
    gen = torch.Generator(device=engine.device).manual_seed(cfg.seed)
    t = time.perf_counter()
    infer(prepped, engine.statics, gen)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t
    with torch.no_grad():
        predict_ms = host_ms(lambda: harness._predict(
            engine.model, prepped, engine.statics, cfg), 2)
    say("disn_infer", first_s=first_s, seconds=infer_s,
        predict_forward_and_occupancy_ms=predict_ms, metrics=out,
        launches=infer_launches,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    bad = [n for n, v in out.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"DISN inference: non-finite {bad}")
    if infer_launches["nearest"] == 0 or infer_launches["tri_argmin"] == 0:
        raise AssertionError(f"DISN inference launched {infer_launches}")
    del engine, prepped
    torch.cuda.empty_cache()
    return inputs, launches, per_variant


def check_disn_kernels(inputs, per_variant):
    """K1 (the Laplacian, C = 3), K2 and K3 at the DISN path's inputs,
    exact against their plain versions and timed beside their bounds."""
    return {
        "stencil": check_stencil(
            {k: v for k, v in inputs.items() if k[0] == "stencil"},
            {k: c for k, c in per_variant.items() if k[0] == "stencil"},
            label="kernel_stencil_disn",
            row_key=("stencil", "float32", 3, "forward")),
        "nearest": check_nearest(inputs[("nearest",)],
                                 label="kernel_nearest_disn"),
        "tri_argmin": check_tri_argmin(inputs[("tri_argmin",)],
                                       label="kernel_tri_argmin_disn"),
    }


# ------------- general grids (the gather paths) and the uncompacted path
# launches per full-width step on a general grid: no stencil (the GCN and
# the Laplacian take the padded gather), chamfer and the analytic term once
GATHER_LAUNCHES = {"stencil": 0, "nearest": 1, "tri_argmin": 1,
                   "raster_hit": 0, "point_tet": 0,
                   "grid_probe": 0}
GATHER_DIR = ROOT / "build" / "smoke_gather"


def uncompacted_config():
    """bench.py's configuration with ``max_boundary_faces=0``: the surface
    terms over every interior face (the reference's own semantics)."""
    cfg = bench_config()
    cfg.max_boundary_faces = 0
    return cfg


def statics_seconds(res=50):
    """Seconds to build the res-``res`` lattice statics on the card with
    and without the face-derived gather tables (which only the
    uncompacted normal term reads)."""
    from deftet_tpu_torch.train import build_grid_statics

    out = {}
    for face_arrays in (False, True):
        t = time.perf_counter()
        build_grid_statics(res, device=DEVICE, face_arrays=face_arrays)
        torch.cuda.synchronize()
        out["with_face_arrays" if face_arrays else "without_face_arrays"] = (
            time.perf_counter() - t)
    return out


def uncompacted_step():
    """The res-50 / batch-4 bf16 lattice step at ``max_boundary_faces=0``
    through Engine: one warm-up and five timed steps (K1 10, K2 1, K3 1
    launches each), the statics' set-up seconds with and without the edge
    arrays; returns the kernels' inputs for their checks."""
    setup_s = statics_seconds()
    inputs, launches, _, engine = main_path(
        uncompacted_config(), device=DEVICE, label="uncompacted_step")
    say("uncompacted_setup", statics_s=setup_s,
        n_faces=int(engine.statics.face_fx3.shape[0]),
        lattice_median_step_s=STEP_MEDIANS.get("main"))
    del engine
    torch.cuda.empty_cache()
    return inputs, launches


def split_grid_50():
    """``build_tet_grid(25)`` split 1->8 by ``subdivide_tets`` (132,651
    vertices, 750,000 tets: the main path's size, not a lattice), written
    by ``save_tet_file`` and read back by ``read_tet_file``, with the
    seconds of each."""
    from deftet_tpu_torch.tetgrid import (TetGrid, build_tet_grid,
                                          read_tet_file, save_tet_file,
                                          subdivide_tets)

    t0 = time.perf_counter()
    g = build_tet_grid(25)
    points, _, tets = subdivide_tets(g.tets, g.vertices)
    GATHER_DIR.mkdir(parents=True, exist_ok=True)
    path = GATHER_DIR / "split25.tet"
    t1 = time.perf_counter()
    save_tet_file(TetGrid(vertices=points, tets=tets,
                          interior_mask=np.zeros_like(points)), str(path))
    t2 = time.perf_counter()
    grid = read_tet_file(str(path))
    t3 = time.perf_counter()
    path.unlink()
    return grid, {"build_and_split_s": t1 - t0, "save_tet_file_s": t2 - t1,
                  "read_tet_file_s": t3 - t2}


def gather_step():
    """bench.py's configuration on the split grid (not a lattice) through
    ``Engine(config, statics=build_grid_statics(50, grid=...))``: one
    warm-up and five timed steps, no K1 launch (the padded gathers), K2
    and K3 once each; the set-up seconds (``build_topology`` among them),
    and the step beside the lattice step's at the same widths.  Returns
    the kernels' inputs, the engine (for gather_eval) and (grid, its numpy
    topology, that topology's seconds) for native_topology."""
    from deftet_tpu_torch.tetgrid import build_topology
    from deftet_tpu_torch.train import build_grid_statics

    grid, io_s = split_grid_50()
    t = time.perf_counter()
    topology = build_topology(grid.tets, grid.n_vertices)
    topology_s = time.perf_counter() - t
    statics = build_grid_statics(50, grid=grid, topology=topology,
                                 device=DEVICE)
    torch.cuda.synchronize()
    statics_s = time.perf_counter() - t
    inputs, launches, _, engine = main_path(
        bench_config(), device=DEVICE, expected=GATHER_LAUNCHES,
        label="gather_step", statics=statics)
    st = engine.statics
    say("gather_setup", **io_s, build_grid_statics_s=statics_s,
        build_topology_s=topology_s, vertices=st.n_vertices, tets=st.n_tets,
        faces=int(st.face_fx3.shape[0]),
        adjacency_width=int(st.vert_adj_idx.shape[1]),
        vertex_tet_width=int(st.vert_tet_inc_idx.shape[1]),
        gather_median_step_s=STEP_MEDIANS["gather_step"],
        lattice_median_step_s=STEP_MEDIANS.get("main"))
    if st.lattice is not None or st.n_tets != 750_000:
        raise AssertionError("gather_step did not run a non-lattice grid")
    gather_determinism(st)
    return inputs, launches, engine, (grid, topology, topology_s)


def gather_determinism(st):
    """``incidence_gather`` (the tet corners of every tet) and
    ``edge_face_sum`` (bf16 per-face fields) backpropagate by gathers: on
    the card two backward passes of the same cotangent give the same
    bits."""
    from deftet_tpu_torch.ops.geometry import edge_face_sum, incidence_gather

    gen = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn((4, st.n_vertices), generator=gen).to(DEVICE)
    flat = st.tet_tx4.t().reshape(-1)
    cot = torch.randn((4, flat.shape[0]), generator=gen).to(DEVICE)
    fields = torch.randn((16, st.face_fx3.shape[0]), generator=gen).to(
        DEVICE, torch.bfloat16)
    cot_e = torch.randn((16, st.edge_face_idx.shape[0]), generator=gen).to(
        DEVICE)
    grads = []
    for _ in range(2):
        xg = x.clone().requires_grad_()
        fg = fields.clone().requires_grad_()
        out = incidence_gather(xg, flat, st.vert_tet_inc_idx,
                               st.vert_tet_inc_mask)
        sums = edge_face_sum(fg, st.edge_face_idx, st.edge_face_mask,
                             st.face_edge_ids)
        grads.append(torch.autograd.grad([out, sums], [xg, fg],
                                         [cot, cot_e]))
    same = [torch.equal(a, b) for a, b in zip(*grads)]
    say("gather_determinism", incidence_gather_same=same[0],
        edge_face_sum_same=same[1])
    if not all(same):
        raise AssertionError("gather backward differs between two runs")


def gather_eval(engine, data):
    """One inference step of the gather engine at 100,000 points a side on
    ``data`` (eval_data): a first call, then a timed one with its peak and
    launches, and ``points_in_tets_soa`` alone.  Trains on the batch until
    there is a predicted surface (at most 40 steps, and says so).  Returns
    the point-in-tet kernel's and the grid-probe kernel's checks at this
    step's calls (the occupancy rows of 750,000 centres in the split
    grid's order, not the lattice's)."""
    from deftet_tpu_torch.evals import harness
    from deftet_tpu_torch.ops import _cuda, point_tet

    cfg = engine.config
    cfg.eval_points = EVAL_POINTS
    prepped = engine._prep_batch(data[0])
    infer = engine.inference_step()

    def run():
        gen = torch.Generator(device=engine.device).manual_seed(cfg.seed)
        return {n: float(v) for n, v in infer(prepped, engine.statics,
                                             gen).items()}

    trained = 0
    first = time.perf_counter()
    out = run()
    first_s = time.perf_counter() - first
    while out["n_boundary"] <= 0 and trained < 40:
        engine.train_step(prepped)
        trained += 1
        out = run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t
    launches = dict(_cuda.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        _, soa, _ = harness._predict(engine.model, prepped, engine.statics,
                                     cfg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        point_tet.points_in_tets_soa(soa, prepped["sdf_points"])
        torch.cuda.synchronize()
        pit_s = time.perf_counter() - t
    say("gather_eval", first_s=first_s, seconds=infer_s,
        trained_for_surface=trained, metrics=out, launches=launches,
        max_memory_allocated_bytes=peak, points_in_tets_s=pit_s,
        points_in_tets_share=pit_s / infer_s)
    bad = [n for n, v in out.items() if not np.isfinite(v)]
    if bad or out["n_boundary"] <= 0:
        raise AssertionError(f"gather_eval: non-finite {bad} or no surface")
    if launches["stencil"] or not (launches["nearest"]
                                   and launches["tri_argmin"]
                                   and launches["point_tet"]
                                   and launches["grid_probe"]):
        raise AssertionError(f"gather_eval launched {launches}")
    pit = check_point_tet(soa, prepped["sdf_points"],
                          "kernel_point_tet_gather", launches["point_tet"])
    del soa
    gp_calls = grid_probe_calls(engine, prepped)
    probe = check_grid_probe(gp_calls, "kernel_grid_probe_gather",
                             launches["grid_probe"])
    return pit, probe


def check_uncompacted_kernels(inputs):
    """K2 and K3 at the uncompacted step's shapes, exact against their
    plain versions: chamfer over 4 x (1 sample on each of the 1.5M face
    slots) against 5,000 points, and the analytic term's 4 x 5,000 points
    against every face under the boundary mask (the plain version over
    the first 1,000 points of each batch element)."""
    return {
        "nearest": check_nearest(inputs[("nearest",)],
                                 label="kernel_nearest_uncompacted",
                                 reps=10),
        "tri_argmin": check_tri_argmin(inputs[("tri_argmin",)],
                                       label="kernel_tri_uncompacted",
                                       reps=5, plain_points=1000),
    }


def check_gather_kernels(inputs):
    """K2 and K3 at the gather step's inputs (the main path's shapes on
    the split grid), exact against their plain versions."""
    return {
        "nearest": check_nearest(inputs[("nearest",)],
                                 label="kernel_nearest_gather"),
        "tri_argmin": check_tri_argmin(inputs[("tri_argmin",)],
                                       label="kernel_tri_gather"),
    }


def _pair_keys(topo):
    """The edge-face pairs of ``topo`` as sorted int64 keys fa * F + fb."""
    f = np.int64(topo.face_fx3.shape[0])
    return np.sort(topo.edge_pair_fa.astype(np.int64) * f
                   + topo.edge_pair_fb.astype(np.int64))


def topology_differences(got, ref):
    """(fields of two ``Topology`` values that differ in dtype, shape or
    value, whether their edge-face pairs are in the same order): the pairs
    are held as sorted pair sets, the native builders listing them by
    edge.  Fields that neither built (None) are equal."""
    differ, pairs_same_order = [], None
    for field in dataclasses.fields(got):
        a, b = getattr(got, field.name), getattr(ref, field.name)
        arrays = isinstance(a, np.ndarray), isinstance(b, np.ndarray)
        if all(arrays):
            same = (a.dtype == b.dtype and a.shape == b.shape
                    and np.array_equal(a, b))
        else:
            same = not any(arrays) and a == b  # counts, or None for both
        if field.name in ("edge_pair_fa", "edge_pair_fb") and \
                got.edge_pair_fa is not None:
            pairs_same_order = bool(same) and pairs_same_order is not False
        elif not same:
            differ.append(field.name)
    if got.edge_pair_fa is not None and not np.array_equal(
            _pair_keys(got), _pair_keys(ref)):
        differ.append("edge_pair_fa/fb (as a set)")
    return differ, pairs_same_order


def native_topology(grid, numpy_topo, numpy_s, numpy_statics):
    """The native (g++) topology builders on the gather step's 750,000-tet
    split grid, on the card machine's host: the library's build and
    ``build_topology_native``'s seconds beside the numpy ``build_topology``
    (``numpy_s``, built once by gather_step), every ``Topology`` field held
    equal array for array (the edge-face pairs as sorted pair sets: the
    native builder lists them by edge); then one train step of
    bench.py's configuration on statics built from each topology, from
    the same parameters and injected draws with deterministic algorithms
    on: terms equal bit for bit where every array (pair order included)
    is equal, else each within relative 1e-4.  K2 and K3 launch once in
    the native-statics step, K1 never."""
    import warnings

    from deftet_tpu_torch.native import build as native_build
    from deftet_tpu_torch.native import build_topology_native
    from deftet_tpu_torch.ops import _cuda
    from deftet_tpu_torch.train import Engine, build_grid_statics

    t = time.perf_counter()
    native_build.build_library("topology", force=True)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    topo = build_topology_native(grid.tets, grid.n_vertices)
    native_s = time.perf_counter() - t

    differ, pairs_same_order = topology_differences(topo, numpy_topo)
    pairs_same_set = "edge_pair_fa/fb (as a set)" not in differ

    t = time.perf_counter()
    statics = build_grid_statics(50, grid=grid, topology=topo, device=DEVICE)
    torch.cuda.synchronize()
    statics_s = time.perf_counter() - t
    statics_same = all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x, y))
        for x, y in zip(statics, numpy_statics))

    cfg = bench_config()
    batch = bench_batch(cfg)
    draws = step_draws(cfg, np.random.default_rng(17), cfg.batch_size)
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    state, terms, launches = None, {}, None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for label, st in (("numpy", numpy_statics), ("native", statics),
                              ("numpy_again", numpy_statics)):
                engine = Engine(cfg, device=DEVICE, statics=st)
                if state is None:
                    state = {n: v.clone() for n, v in
                             engine.model.state_dict().items()}
                engine.model.load_state_dict(state)
                prepped = engine._prep_batch(batch)
                _cuda.reset_launch_counts()
                out = engine.train_step(prepped,
                                        draws=on_device(draws, DEVICE))
                torch.cuda.synchronize()
                if label == "native":
                    launches = dict(_cuda.launch_counts)
                terms[label] = {n: float(v) for n, v in out.items()}
                del engine, prepped
                if label == "native" and terms["native"] == terms["numpy"]:
                    break
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.backends.cudnn.deterministic = prev[1]
    del statics
    torch.cuda.empty_cache()

    all_equal = not differ and pairs_same_order
    bitwise = terms["native"] == terms["numpy"]
    worst = max(abs(terms["native"][n] - v) / max(abs(v), 1e-30)
                for n, v in terms["numpy"].items())
    say("native_topology", tets=int(topo.n_tets), faces=int(
        topo.face_fx3.shape[0]), pairs=int(topo.edge_pair_fa.shape[0]),
        gxx_build_s=build_s, build_topology_native_s=native_s,
        build_topology_numpy_s=numpy_s, native_statics_s=statics_s,
        fields_differ=differ, pairs_same_set=bool(pairs_same_set),
        pairs_same_order=bool(pairs_same_order),
        statics_equal=bool(statics_same), terms_numpy=terms["numpy"],
        terms_native=terms["native"], terms_bitwise=bitwise,
        numpy_repeat_bitwise=(terms["numpy_again"] == terms["numpy"]
                              if "numpy_again" in terms else None),
        worst_term_rel=worst, launches=launches,
        note="host seconds on the card machine's CPU")
    if differ:
        raise AssertionError(f"native topology differs from numpy: {differ}")
    if launches != GATHER_LAUNCHES:
        raise AssertionError(f"native-statics step launched {launches}")
    if all_equal and not bitwise and \
            terms.get("numpy_again") == terms["numpy"]:
        raise AssertionError("equal topologies, but the steps' terms differ")
    if not worst <= 1e-4:
        raise AssertionError(f"native-statics step terms off by {worst}")


def lattice_statics(res=50):
    """The res-``res`` lattice topology through ``build_lattice_topology``'s
    dispatch (the native builders, since g++ is on the path) and through
    its numpy builders (``native_available`` made false for the call),
    each with and without the face arrays: host seconds of each on the
    card machine's CPU, every field held equal (dtype, shape, values; the
    edge-face pairs as sorted pair sets, the native builder listing them
    by edge).  Then which builders ``build_grid_statics`` took, and its
    seconds.  The g++ build is native_topology's and is not timed here."""
    from deftet_tpu_torch.native import build as native_build
    from deftet_tpu_torch.native import topology as native
    from deftet_tpu_torch.tetgrid import build_lattice_topology, build_tet_grid
    from deftet_tpu_torch.train import build_grid_statics

    if not native_build.native_available():
        raise AssertionError("no g++ on the card machine: the statics cannot "
                             "take the native builders")
    native_build.load_library("topology")
    grid = build_tet_grid(res)
    available = native_build.native_available
    seconds, topos = {}, {}
    for face_arrays in (True, False):
        for path in ("native", "numpy"):
            if path == "numpy":
                native_build.native_available = lambda: False
            try:
                t = time.perf_counter()
                topos[path, face_arrays] = build_lattice_topology(
                    grid, face_arrays=face_arrays)
                key = "with" if face_arrays else "without"
                seconds[f"{path}_{key}_face_arrays_s"] = (
                    time.perf_counter() - t)
            finally:
                native_build.native_available = available
    differ, pairs_same_order = topology_differences(topos["native", True],
                                                    topos["numpy", True])
    differ += [f"{name} (without face arrays)" for name in
               topology_differences(topos["native", False],
                                    topos["numpy", False])[0]]
    del topos

    calls = []
    counted = native.build_vertex_adjacency_native

    def counting(*args):
        calls.append(1)
        return counted(*args)

    native.build_vertex_adjacency_native = counting
    try:
        t = time.perf_counter()
        statics = build_grid_statics(res, grid=grid, device=DEVICE)
        torch.cuda.synchronize()
        statics_s = time.perf_counter() - t
    finally:
        native.build_vertex_adjacency_native = counted
    path = "native" if calls else "numpy"
    del statics
    say("lattice_statics", res=res, tets=int(grid.n_tets), **seconds,
        build_grid_statics_s=statics_s, build_grid_statics_path=path,
        fields_differ=differ, pairs_same_order=pairs_same_order,
        note="host seconds on the card machine's CPU")
    if differ:
        raise AssertionError(f"native lattice topology differs: {differ}")
    if path != "native":
        raise AssertionError("build_grid_statics took the numpy builders "
                             "with g++ on the path")


def encoder_pass(model, pts, cots):
    """One train-mode forward of a PVCNN encoder and the backward of the
    loss sum_i mean(pyramid_i * cot_i); returns the pyramid."""
    model.zero_grad(set_to_none=True)
    pyramid = model(pts, True)
    sum((v * c).mean() for v, c in zip(pyramid, cots)).backward()
    return pyramid


def parity_se(devices=("cpu", DEVICE)):
    """The main cell's encoder (DEFAULT_BLOCKS, batch 4, 5,000 points)
    with squeeze-excitation (``with_se=True``), and without it for
    comparison: one train-mode forward and backward on the card against
    the CPU from the same parameters, in float32 (TF32 off), at
    ``parity``'s tolerances: every parameter gradient and running
    statistic as its gradients (rtol 1e-3 / atol 1e-5), the pyramid as its
    terms at rtol 1e-4, with an atol of 1e-4 of each level's largest
    magnitude (its entries cross 0 after BatchNorm, and the two devices
    sum the up to 13,824-term float32 convolutions in other orders: the
    phase prints how far apart, with and without SE); then, on the card,
    the bf16 encoder's forward + backward time with and without SE (the
    main cell's precision)."""
    from deftet_tpu_torch.nn.pvcnn import DEFAULT_BLOCKS, PVCNNEncoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(13)
    pts_np = rng.uniform(-0.45, 0.45, (4, 5000, 3)).astype(np.float32)
    cots_np = [rng.normal(size=(4, r, r, r, c)).astype(np.float32)
               for c, nb, r in DEFAULT_BLOCKS for _ in range(nb)]

    def make(device, dtype=None, with_se=True):
        return PVCNNEncoder(DEFAULT_BLOCKS, dtype=dtype, with_se=with_se,
                            generator=torch.Generator().manual_seed(0)
                            ).to(device)

    report, failed = {}, []
    for with_se in (True, False):
        runs = {}
        for device in devices:
            model = make(device, with_se=with_se)
            pts = torch.tensor(pts_np, device=device)
            cots = [torch.tensor(c, device=device) for c in cots_np]
            pyramid = encoder_pass(model, pts, cots)
            runs[device] = (
                [v.detach().cpu() for v in pyramid],
                {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 .detach().cpu() for n, p in model.named_parameters()},
                {n: b.detach().cpu().clone()
                 for n, b in model.named_buffers()})
            del model, pyramid
        (p_ref, g_ref, s_ref), (p_got, g_got, s_got) = (runs[d]
                                                        for d in devices)
        row = {
            "worst_pyramid_ratio": max(
                ratio(g, r, 1e-4, 1e-4 * float(r.abs().max()))
                for g, r in zip(p_got, p_ref)),
            "worst_grad_ratio": max(ratio(g_got[n], g, 1e-3, 1e-5)
                                    for n, g in g_ref.items()),
            "worst_stat_ratio": max(ratio(s_got[n], v, 1e-3, 1e-5)
                                    for n, v in s_ref.items()),
            "pyramid_max_abs_diff": [float((g - r).abs().max())
                                     for g, r in zip(p_got, p_ref)],
            "pyramid_max_abs": [float(r.abs().max()) for r in p_ref],
            "se_weights": sum(".SE3d_0." in n for n in g_ref),
        }
        report["with_se" if with_se else "without_se"] = row
        if row["se_weights"] != (8 if with_se else 0) or not max(
                row["worst_pyramid_ratio"], row["worst_grad_ratio"],
                row["worst_stat_ratio"]) <= 1.0:
            failed.append(("with_se" if with_se else "without_se", row))

    ms = {}
    if torch.device(devices[-1]).type == "cuda":
        pts = torch.tensor(pts_np, device=devices[-1])
        cots = [torch.tensor(c, device=devices[-1]) for c in cots_np]
        for with_se in (False, True):
            model = make(devices[-1], torch.bfloat16, with_se)
            out = encoder_pass(model, pts, cots)
            if not all(bool(torch.isfinite(v).all()) for v in out):
                raise AssertionError("parity_se: non-finite bf16 pyramid")
            ms["with_se" if with_se else "without_se"] = cuda_ms(
                lambda: encoder_pass(model, pts, cots), reps=10)
            del model, out
        torch.cuda.empty_cache()
    say("parity_se", shape="batch 4, 5,000 points, DEFAULT_BLOCKS",
        f32_card_against_cpu=report, bf16_forward_backward_ms=ms)
    if failed:
        raise AssertionError(f"parity_se failed (ratios must be <= 1, 8 SE "
                             f"weights with SE, none without): {failed}")


def small_split_statics():
    """(statics on the CPU, faces) of the res-2 grid split 1->8, through a
    ``.tet`` file: a non-lattice grid of 384 tets for the res-4 parity."""
    from deftet_tpu_torch.tetgrid import (TetGrid, build_tet_grid,
                                          read_tet_file, save_tet_file,
                                          subdivide_tets)
    from deftet_tpu_torch.train import build_grid_statics

    g = build_tet_grid(2)
    points, _, tets = subdivide_tets(g.tets, g.vertices)
    GATHER_DIR.mkdir(parents=True, exist_ok=True)
    path = GATHER_DIR / "split2.tet"
    save_tet_file(TetGrid(vertices=points, tets=tets,
                          interior_mask=np.zeros_like(points)), str(path))
    statics = build_grid_statics(4, grid=read_tet_file(str(path)))
    path.unlink()
    return statics


def forward_grads(cfg, batch, draws, devices, statics=None):
    """{device: (terms, gradients)} of one forward_losses with gradients
    from the same initial parameters and injected draws on each device."""
    from deftet_tpu_torch.train import Engine

    state, out = None, {}
    for device in devices:
        engine = Engine(cfg, device=device, statics=statics)
        if state is None:
            state = {n: v.clone() for n, v in
                     engine.model.state_dict().items()}
        engine.model.load_state_dict(state)
        total, terms = engine.forward_losses(
            engine._prep_batch(batch), train=True,
            draws=on_device(draws, device))
        params = dict(engine.model.named_parameters())
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        out[device] = (
            {n: float(v.detach()) for n, v in terms.items()}
            | {"total": float(total.detach())},
            {n: (torch.zeros_like(p) if g is None else g).detach().cpu()
             for (n, p), g in zip(params.items(), grads)})
    return out


def parity_gather(devices=("cpu", DEVICE)):
    """Card against CPU at res 4 in float32 (small_config) from the same
    parameters and injected draws, on the split res-2 grid at the default
    budget and at budget 0 and on the res-4 lattice at budget 0: one
    forward with gradients (terms rtol 1e-4 / atol 1e-6, every gradient
    rtol 1e-3 / atol 1e-5, as ``parity`` and the CPU tests hold them),
    then two train steps at parity_train's tolerances for the terms,
    Adam's first moment (rtol 1e-3 / atol 1e-6), every update within 3 lr
    a step and the BatchNorm statistics (rtol 1e-4 / atol 1e-6, the second
    step's running means within 2 lr); then one inference step on the
    split grid, every metric rtol 1e-4 / atol 1e-6.  parity_train's
    entrywise hold of the live updates (first moment above 1e-6) is
    reported, not held: here entries along a BatchNorm's null direction
    (the GCN block's biases, whose exact gradient is 0) carry gradients
    up to the 1e-5 noise that the gradient check allows, and Adam turns
    that into an O(lr) update difference.  The normal term's per-face
    fields run in float32 on both devices, as in parity_lap_disn (in bf16
    a field within the devices' float32 difference of a rounding boundary
    flips)."""
    from deftet_tpu_torch.losses import surface
    from deftet_tpu_torch.train import Engine

    split = small_split_statics()
    configs = {
        "split_default": (small_config(), split),
        "split_budget0": (small_config(max_boundary_faces=0), split),
        "lattice_budget0": (small_config(max_boundary_faces=0), None),
    }
    field_dtype = surface.NORMAL_FIELD_DTYPE
    surface.NORMAL_FIELD_DTYPE = torch.float32
    report = {}
    try:
        for name, (cfg, statics) in configs.items():
            rng = np.random.default_rng(15)
            n_faces = (12 * cfg.res**3 if statics is None
                       else int(statics.face_fx3.shape[0]))
            draws = [step_draws(cfg, rng, cfg.batch_size, n_faces)
                     for _ in range(2)]
            batch = bench_batch(cfg, level=1, occ_res=16)
            fwd = forward_grads(cfg, batch, draws[0], devices, statics)
            (t_cpu, g_cpu), (t_gpu, g_gpu) = (fwd[d] for d in devices)
            _, runs = train_runs(cfg, batch, draws, devices, statics)
            cpu, gpu = (runs[d] for d in devices)
            noise = 3 * cfg.lr * len(draws)
            live = {n: cpu["mu"][n].abs() > 1e-6 for n in cpu["mu"]}
            (s1, s2), (c1, c2) = gpu["stats"], cpu["stats"]
            worst = {
                "forward_terms": max(ratio(t_gpu[n], v, 1e-4, 1e-6)
                                     for n, v in t_cpu.items()),
                "gradients": max(ratio(g_gpu[n], g, 1e-3, 1e-5)
                                 for n, g in g_cpu.items()),
                "terms": max(ratio(g[n], c[n], 1e-4, 1e-6)
                             for g, c in zip(gpu["terms"], cpu["terms"])
                             for n in c),
                "mu": max(ratio(gpu["mu"][n], v, 1e-3, 1e-6)
                          for n, v in cpu["mu"].items()),
                "update_noise": max(
                    float((gpu["update"][n] - v).abs().max()) / noise
                    for n, v in cpu["update"].items()),
                "batch_stats_step1": max(ratio(s1[n], v, 1e-4, 1e-6)
                                         for n, v in c1.items()),
                "running_var_step2": max(ratio(s2[n], v, 1e-4, 1e-6)
                                         for n, v in c2.items()
                                         if "var" in n),
                "running_mean_step2": max(ratio(s2[n], v, 0.0, 2 * cfg.lr)
                                          for n, v in c2.items()
                                          if "mean" in n),
            }
            entrywise = {n: ratio(gpu["update"][n][live[n]], v[live[n]],
                                  1e-3, 1e-7)
                         for n, v in cpu["update"].items()}
            leaf = max(entrywise, key=entrywise.get)
            diff = (gpu["update"][leaf] - cpu["update"][leaf]).abs()
            at = int(torch.argmax(diff.masked_fill(~live[leaf], 0)))
            report[name] = dict(
                worst_ratios=worst, terms_cuda=gpu["terms"],
                terms_cpu=cpu["terms"],
                live_update_entrywise={
                    "ratio": entrywise[leaf], "leaf": leaf,
                    "mu_cpu": float(cpu["mu"][leaf].flatten()[at]),
                    "mu_cuda": float(gpu["mu"][leaf].flatten()[at]),
                    "grad_cpu": float(g_cpu[leaf].flatten()[at]),
                    "grad_cuda": float(g_gpu[leaf].flatten()[at]),
                    "update_cpu": float(cpu["update"][leaf].flatten()[at]),
                    "update_cuda": float(gpu["update"][leaf].flatten()[at])})

        # one inference step on the split grid, card against CPU
        n_res = 300
        cfg = small_config(eval_points=n_res)
        batch = eval_batch((1, 2), 256, 400, level=1, occ_res=16)
        rng = np.random.default_rng(16)
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
            engine = Engine(cfg, device=device, statics=split)
            if state is None:
                state = {n: v.clone() for n, v in
                         engine.model.state_dict().items()}
                # the threshold in the widest gap above the median
                # probability: a surface, and no probability near it
                from deftet_tpu_torch.evals import harness

                d = on_device(draws, device)
                _, _, logits = harness._predict(
                    engine.model, engine._prep_batch(batch), engine.statics,
                    cfg, noise=d["noise"])
                probs = np.sort(torch.sigmoid(logits).cpu().numpy()
                                .reshape(-1))
                half = len(probs) // 2
                i = half + int(np.argmax(np.diff(probs[half:])))
                cfg.occ_threshold = float((probs[i] + probs[i + 1]) / 2)
            engine.model.load_state_dict(state)
            out[device] = {n: float(v) for n, v in engine.inference_step()(
                engine._prep_batch(batch), engine.statics,
                draws=on_device(draws, device)).items()}
        cpu, gpu = (out[d] for d in devices)
        report["split_inference"] = dict(
            worst_ratios={"metrics": max(ratio(gpu[n], v, 1e-4, 1e-6)
                                         for n, v in cpu.items())},
            metrics_cuda=gpu, metrics_cpu=cpu)
        if cpu["n_boundary"] <= 0:
            raise AssertionError("parity_gather: no predicted surface")
    finally:
        surface.NORMAL_FIELD_DTYPE = field_dtype
    say("parity_gather", **report)
    bad = {n: r["worst_ratios"] for n, r in report.items()
           if not all(v <= 1.0 for v in r["worst_ratios"].values())}
    if bad:
        raise AssertionError(f"gather parity failed: {bad}")


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


def eval_data():
    """(batch, seconds to build it) of the full-width evaluations (the
    point path's and DISN's): four shapes of the port's make_example
    (random_shape 0-3, level 2; 5,000 surface points, 20,000 SDF points,
    a 64^3 texture, a 64 x 64 image and its camera)."""
    t0 = time.perf_counter()
    batch = eval_batch(range(4), 5000, EVAL_SDF, level=2, occ_res=64,
                       with_image=True)
    return batch, time.perf_counter() - t0


def eval_phase(engine, data):
    """The main path's res-50 / batch-4 / bf16 engine after its steps,
    evaluated on ``data`` (eval_data) at 100,000 surface points a side: validate and
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
    batch, data_s = data
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
    idle = [n for n in ("stencil", "nearest", "tri_argmin", "point_tet",
                        "grid_probe") if launches[n] == 0]
    if idle:
        raise AssertionError(f"eval path never launched {idle}")

    with torch.no_grad():
        _, soa, _ = harness._predict(engine.model, prepped, engine.statics,
                                     cfg)
        predict_ms = host_ms(lambda: harness._predict(
            engine.model, prepped, engine.statics, cfg), 3)
        pit_ms = host_ms(lambda: point_tet.points_in_tets_soa(
            soa, prepped["sdf_points"]), 3)
        pit = check_point_tet(soa, prepped["sdf_points"],
                              "kernel_point_tet_eval",
                              launches["point_tet"] / (1 + EVAL_RUNS))
    gp_calls = grid_probe_calls(engine, prepped)
    probe = check_grid_probe(gp_calls, "kernel_grid_probe_eval",
                             launches["grid_probe"] / (1 + EVAL_RUNS))
    del gp_calls
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
                points_in_tets_ms=pit_ms, point_tet=pit, grid_probe=probe)


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
                       label="kernel_stencil_eval")
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


def point_tet_bound(soa, q):
    """(ms, by) of one point-in-tet call at the card's peak: the corners
    read once (12 floats a tet), the queries read and the answers
    written once; no operation count (the tests a query needs depend on
    the bins)."""
    b, t = soa[0][0].shape
    return bound_ms(48 * b * t + 12 * q.shape[0] * q.shape[1]
                    + 4 * q.shape[0] * q.shape[1], 0.0)


def check_point_tet(soa, q, label, launches, reps=20):
    """The point-in-tet kernel at a path's inputs against the plain scan
    on the card, index for index: its ms (CUDA events over ``reps`` calls,
    each call's host read of the entry count included), its bound, the
    plain scan's ms (host clock, one call) and the kernel's stats
    record."""
    from deftet_tpu_torch.ops import point_tet

    got = point_tet.points_in_tets_soa(soa, q)
    torch.cuda.synchronize()
    stats = point_tet.kernel_stats()
    t = time.perf_counter()
    ref = point_tet.points_in_tets_plain(soa, q)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    wrong = int((got != ref).sum())
    ms = cuda_ms(lambda: point_tet.points_in_tets_soa(soa, q), reps)
    bound, by = point_tet_bound(soa, q)
    res = {"shape": f"{tuple(q.shape)} queries against "
                    f"{tuple(soa[0][0].shape)} tets",
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "library_ms": None, "max_abs_err": wrong,
           "launches_per_run": launches, "stats": stats,
           "found": int((ref >= 0).sum())}
    say(label, **res)
    if wrong:
        raise AssertionError(f"{label}: {wrong} indices differ from the "
                             "plain scan")
    return res


def point_tet_cases(seed=7):
    """The point-in-tet kernel's adversarial cases: (name, corners (B, T,
    4, 3), queries (B, P, 3)), numpy float32, on res-4 and res-8 Kuhn
    grids in [-0.5, 0.5]^3 (spacing 0.25 and 0.125)."""
    from deftet_tpu_torch.tetgrid import build_tet_grid

    rng = np.random.default_rng(seed)
    g4, g8 = build_tet_grid(4), build_tet_grid(8)
    v4 = g4.centered_vertices().astype(np.float32)
    # lattice vertices, edge midpoints, face and cell centres: each shared
    # by two or more tets, so the lowest index has to win
    axis = np.arange(-0.5, 0.5001, 0.125, dtype=np.float32)
    lattice = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                       -1).reshape(-1, 3)
    cases = [("lattice_points", v4[g4.tets][None], lattice[None])]

    # on the boundary, just outside it, far outside, NaN and infinities
    face = rng.uniform(-0.5, 0.5, (600, 3)).astype(np.float32)
    face[np.arange(600), rng.integers(0, 3, 600)] = rng.choice(
        np.float32([-0.5, 0.5]), 600)
    out = np.nextafter(face, np.sign(face) * np.float32(np.inf))
    special = np.float32([[np.nan, 0, 0], [0, np.inf, 0], [-np.inf, 0, 0.1],
                          [2, 0, 0], [0, -1e6, 0], [0, 0, 1e30],
                          [3e24, 0, 0]])  # four scan every tet
    q = np.concatenate([face, out, special])[None]
    cases.append(("boundary_and_outside", v4[g4.tets][None], q))

    # per batch element another deformation; element 0 holds flat tets
    # (coplanar corners, one point, four on a line, flat up to 1e-7) at
    # indices 200-203, which contain every query; element 1 one tet
    # across the whole domain at index 150 (this grid has a few cells, so
    # it is binned into all of them)
    pos = v4[None] + rng.uniform(-0.06, 0.06, (2,) + v4.shape).astype(
        np.float32)
    corners = pos[:, g4.tets].copy()
    c = corners[0]
    c[200, :, 2] = c[200, 0, 2]
    c[201] = c[201, 0]
    c[202] = c[202, 0] + np.float32([0.1, 0.2, 0.3]) * np.float32(
        [0, 1, 2, 3])[:, None]
    c[203, :, 2] = c[203, 0, 2]
    c[203, 3, 2] += np.float32(1e-7)
    corners[1, 150] = np.float32([[-0.7, -0.7, -0.7], [0.7, -0.7, -0.7],
                                  [-0.7, 0.7, -0.7], [0, 0, 0.7]])
    q = rng.uniform(-0.6, 0.6, (2, 3000, 3)).astype(np.float32)
    cases.append(("degenerate_and_across", corners, q))

    # nothing inside: every answer -1
    q = rng.uniform(1.0, 5.0, (1, 500, 3)).astype(np.float32) * \
        rng.choice(np.float32([-1, 1]), (1, 500, 3))
    cases.append(("empty", v4[g4.tets][None], q))

    # a res-8 grid deformed by up to 0.4 of a spacing, three elements;
    # in element 1 tet 1500 spans the domain, more cells than a binned tet
    # may cover, so it goes to the overflow list
    v8 = g8.centered_vertices().astype(np.float32)
    pos = v8[None] + rng.uniform(-0.05, 0.05, (3,) + v8.shape).astype(
        np.float32)
    corners = pos[:, g8.tets].copy()
    corners[1, 1500] = np.float32([[-0.6, -0.6, -0.6], [0.6, -0.6, -0.6],
                                   [-0.6, 0.6, -0.6], [0, 0, 0.6]])
    q = rng.uniform(-0.55, 0.55, (3, 5000, 3)).astype(np.float32)
    cases.append(("deformed_res8", corners, q))
    return cases


def check_point_tet_edge_cases(device=DEVICE):
    """The kernel against the plain scan on the card, index for index, on
    ``point_tet_cases``, with the corners as strided views of one tensor
    (the gather path's layout); the flat tets and the tet across the
    domain must reach the overflow list, the empty case answer -1 alone."""
    from deftet_tpu_torch.ops import point_tet

    rows = {}
    for name, corners, q in point_tet_cases():
        b, t = corners.shape[:2]
        flat = torch.tensor(corners, device=device).permute(0, 2, 3, 1)
        flat = flat.reshape(b, 12 * t)  # k-major, then axis, then tet
        soa = [[flat[:, (3 * k + c) * t:(3 * k + c + 1) * t]
                for c in range(3)] for k in range(4)]
        qt = torch.tensor(q, device=device)
        got = point_tet.points_in_tets_soa(soa, qt)
        stats = point_tet.kernel_stats()
        ref = point_tet.points_in_tets_plain(soa, qt)
        wrong = int((got != ref).sum())
        rows[name] = {"wrong": wrong, "found": int((ref >= 0).sum()),
                      "queries": int(ref.numel()), "stats": stats}
        if wrong:
            raise AssertionError(f"point_tet case {name}: {wrong} indices "
                                 "differ from the plain scan")
    if (rows["degenerate_and_across"]["stats"]["overflow_tets"] < 2
            or rows["deformed_res8"]["stats"]["overflow_tets"] < 1):
        raise AssertionError(f"flat or spanning tets not in overflow: {rows}")
    if rows["empty"]["found"] or not rows["lattice_points"]["found"]:
        raise AssertionError(f"point_tet cases: {rows}")
    if rows["boundary_and_outside"]["stats"]["all_tets_queries"] != 4:
        raise AssertionError(f"infinite/huge queries: {rows}")
    say("point_tet_edge_cases", cases=rows)
    return rows


# the default encoder's pyramid (nn/pvcnn.py DEFAULT_BLOCKS): (C, r)
DEFAULT_PYRAMID = ((64, 32), (128, 16), (128, 16), (512, 8))


def grid_probe_cases(device=DEVICE, seed=11):
    """The grid-probe kernel's cases: (name, points (B, n, 3), pyramid),
    float32 tensors on ``device``.  Points on voxel faces of every level
    (coordinates that are whole numbers), on and past the r - 1 border,
    and outside [-0.5, 0.5] on every side; the default pyramid, and one
    of odd, even and single-voxel levels; n not a multiple of a tile and
    n = 0; B = 1 and 4; strided and expanded points, a level stored
    channels-first, one expanded over the batch and one a float off
    16-byte alignment; levels of -0.0 and negative values, so that
    products of exactly -0.0 start and fill the corner sums."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    def pyramid(b, spec):
        return [(torch.randn((b, r, r, r, c), generator=gen)).to(device)
                for c, r in spec]

    # faces of each level: (p + 0.5) r a whole number, p = k / r - 0.5
    faces = torch.cat([torch.arange(r + 1, dtype=torch.float32) / r - 0.5
                       for r in (32, 16, 8)])
    border = torch.tensor([0.5 - 1 / 32, 0.5 - 1 / 16, 0.5 - 1 / 8, 0.5,
                           0.49, 0.5 - 1e-7, -0.5, -0.5 + 1e-7])
    outside = torch.tensor([-0.7, 0.9, -3.0, 2.5, -1e6, 1e6, -0.5000001,
                            0.5000001])
    special = torch.cat([faces, border, outside])
    n = 1001
    pts = rand(4, n, 3) * 1.2 - 0.6
    pick = torch.randint(0, special.numel(), (4, n, 3), generator=gen)
    use = rand(4, n, 3) < 0.6
    pts = torch.where(use, special[pick], pts)
    cases = [("faces_border_outside", pts.to(device),
              pyramid(4, DEFAULT_PYRAMID))]

    odd = [(7, 5), (6, 3), (2, 1)]  # one float, two, a single voxel
    cases.append(("odd_levels_b1", (rand(1, 37, 3) * 1.4 - 0.7).to(device),
                  pyramid(1, odd)))
    cases.append(("empty", torch.zeros((4, 0, 3), device=device),
                  pyramid(4, DEFAULT_PYRAMID[:2])))

    # strided points; a level stored channels-first, one expanded over the
    # batch, one a float off 16-byte alignment
    base = (rand(4, 2 * 333, 5) - 0.5).to(device)
    cf = torch.randn((4, 64, 32, 32, 32), generator=gen).to(device)
    one = torch.randn((1, 16, 16, 16, 128), generator=gen).to(device)
    flat = torch.randn(1 + 4 * 8**3 * 512, generator=gen).to(device)
    cases.append(("strided_views", base[:, ::2, 1:4],
                  [cf.permute(0, 2, 3, 4, 1), one.expand(4, -1, -1, -1, -1),
                   flat[1:].view(4, 8, 8, 8, 512)]))
    cases.append(("expanded_points",
                  (rand(1, 517, 3) - 0.5).to(device).expand(4, -1, -1),
                  pyramid(4, DEFAULT_PYRAMID)))

    # -0.0 and negative levels; half the points at voxel centres, whose far
    # corners weigh exactly 0
    r = 4
    neg = -torch.rand((1, r, r, r, 8), generator=gen)
    zeros = torch.full((1, r, r, r, 8), -0.0)
    centres = (torch.randint(0, r, (1, 200, 3), generator=gen).float()
               / r - 0.5)
    pts = torch.cat([centres, rand(1, 200, 3) - 0.5], dim=1)
    cases.append(("negative_zero", pts.to(device),
                  [zeros.to(device), neg.to(device)]))
    return cases


GRID_PROBE_MODES = [(dt, app) for dt in (torch.bfloat16, torch.float32)
                    for app in (True, False)]


def bitwise_differences(got, ref) -> int:
    """Elements whose bits differ (so +0.0 and -0.0 differ)."""
    view = {2: torch.int16, 4: torch.int32}[got.element_size()]
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{got.shape} {got.dtype} against {ref.shape} "
                             f"{ref.dtype}")
    return int((got.view(view) != ref.view(view)).sum())


def check_grid_probe_cases(device=DEVICE):
    """The kernel against its plain version on the card, bit for bit, on
    ``grid_probe_cases`` in bfloat16 and float32, with and without xyz;
    one launch a call with rows."""
    from deftet_tpu_torch.ops import _cuda, grid_probe as gp

    rows = {}
    for name, pts, pyr in grid_probe_cases(device):
        for dt, app in GRID_PROBE_MODES:
            before = _cuda.launch_counts["grid_probe"]
            with torch.no_grad():
                got = gp.grid_probe(pts, pyr, app, dt)
                ref = gp.grid_probe_plain(pts, pyr, app, dt)
            launched = _cuda.launch_counts["grid_probe"] - before
            wrong = bitwise_differences(got, ref)
            key = "/".join((name, str(dt).split(".")[-1],
                            "xyz" if app else "no_xyz"))
            rows[key] = {"wrong": wrong, "elements": ref.numel(),
                         "launches": launched}
            if wrong or launched != int(pts.shape[0] * pts.shape[1] > 0):
                raise AssertionError(f"grid_probe case {key}: {rows[key]}")
    say("grid_probe_cases", cases=rows)
    return rows


def grid_probe_calls(engine, prepped):
    """The grid-probe calls of one inference forward of ``engine`` on
    ``prepped``: [(centres, pyramid, append_points, out_dtype)], one a
    chunk of ``decode_occ_full_grid``."""
    from deftet_tpu_torch.evals import harness
    from deftet_tpu_torch.ops import grid_probe as gp

    calls = []
    orig = gp._grid_probe_cuda

    def keep(points, pyramid, append_points, out_dtype):
        calls.append((points.clone(), list(pyramid), append_points,
                      out_dtype))
        return orig(points, pyramid, append_points, out_dtype)

    gp._grid_probe_cuda = keep
    try:
        with torch.no_grad():
            harness._predict(engine.model, prepped, engine.statics,
                             engine.config)
    finally:
        gp._grid_probe_cuda = orig
    return calls


def grid_probe_bound(calls):
    """(ms, by) of a path's grid-probe calls at the card's peak: each row
    written once, and each call's pyramid and points read once."""
    n_bytes = 0
    for pts, pyr, app, dt in calls:
        b, n, _ = pts.shape
        cols = sum(level.shape[-1] for level in pyr) + (3 if app else 0)
        n_bytes += (b * n * cols * dt.itemsize + 12 * b * n
                    + sum(4 * level.numel() for level in pyr))
    return bound_ms(n_bytes, 0.0)


def check_grid_probe(calls, label, launches, reps=10):
    """The kernel at a path's calls (a step's worth) against its plain
    version on the card, bit for bit: the calls' ms together (CUDA events
    over ``reps`` runs), their bound, the plain version's ms."""
    from deftet_tpu_torch.ops import grid_probe as gp

    wrong = 0
    with torch.no_grad():
        for c in calls:
            wrong += bitwise_differences(gp.grid_probe(*c),
                                         gp.grid_probe_plain(*c))
        ms = cuda_ms(lambda: [gp.grid_probe(*c) for c in calls], reps)
        plain_ms = cuda_ms(lambda: [gp.grid_probe_plain(*c) for c in calls],
                           2)
    bound, by = grid_probe_bound(calls)
    shapes = sorted({tuple(c[0].shape) for c in calls}, reverse=True)
    res = {"shape": f"{len(calls)} calls of {shapes} points against "
                    f"{[tuple(level.shape) for level in calls[0][1]]}, "
                    f"{calls[0][3]}, xyz {calls[0][2]}",
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "share": bound / ms, "library_ms": None,
           "max_abs_err": wrong, "launches_per_run": launches}
    say(label, **res)
    if wrong:
        raise AssertionError(f"{label}: {wrong} elements differ from the "
                             "plain version")
    return res


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


def segment_bytes(engine, batch):
    """Bytes each forward segment (``remat.segment``) saves for its
    backward when nothing is recomputed: one training forward of
    ``batch`` under a saved-tensor hook (no graph is kept), each storage
    counted once, under the segment that saved it first (``i:Module`` in
    call order; "outside" between segments)."""
    from deftet_tpu_torch import remat

    seen, current, calls = {}, ["outside"], [0]
    orig = remat.segment

    def segment(fn, *modules):
        current[0] = f"{calls[0]}:" + (type(modules[0]).__name__
                                       if modules else "")
        calls[0] += 1
        try:
            return fn()
        finally:
            current[0] = "outside"

    held = []  # storages stay alive until counted (no address reused)

    def pack(t):
        storage = t.untyped_storage()
        seen.setdefault(storage.data_ptr(), (current[0], storage.nbytes()))
        held.append(t.detach())  # detached: no cycle through grad_fn

    remat.segment = segment
    state = [b.detach().clone() for b in engine.model.buffers()]
    gen = engine.generator.get_state()
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda _: None):
            engine.forward_losses(batch, train=True)
    finally:
        held.clear()
        remat.segment = orig
        engine.generator.set_state(gen)
        with torch.no_grad():
            for buf, value in zip(engine.model.buffers(), state):
                buf.copy_(value)
    out = {}
    for name, n in seen.values():
        out[name] = out.get(name, 0) + n
    return out


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
        if not use_remat:  # one microbatch's activations, by segment
            micro = {k: v[:cfg.batch_size // cfg.grad_accum]
                     for k, v in batch.items()}
            saved_bytes = segment_bytes(engine, micro)
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
    peaks = {r: rows[r]["max_memory_allocated_bytes"] for r in rows}
    say("paper_step", config=f"res={cfg.res} batch={cfg.batch_size} "
        f"{cfg.precision} grad_accum={cfg.grad_accum}",
        remat=rows[True], no_remat=rows[False],
        microbatch_saved_bytes_by_segment=saved_bytes,
        remat_saves_bytes=peaks[False] - peaks[True])
    if peaks[True] >= peaks[False]:
        raise AssertionError(f"remat does not lower the peak: {peaks}")
    return inputs, per_step, rows


def check_paper_kernels(inputs, per_step):
    """K1-K3 at the paper recipe's inputs (res 70, microbatch 4), exact
    against their plain versions and timed beside their bounds."""
    return {
        "stencil": check_stencil(inputs, per_step,
                                 label="kernel_stencil_paper"),
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
# the image-conditioned network with the lap layer, trained by the CLI on
# the bundled meshes at DISN's default widths and a res-8 grid: one shape
# a step, two trained on and one held out, two epochs (each checkpoint
# holds two full VGG-16s with their Adam moments, 3.3 GB)
CLI_DISN = ["--res", "8", "--batch_size", "1", "--epochs", "2",
            "--use_disn", "--use_lap_layer", "--watertight_res", "32"]
MESHES = ROOT / "tests" / "assets" / "meshes"
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
    atomics may reorder float sums on the card).  Then the mesh-directory
    path: ``preprocess --with_images`` over the bundled meshes (host
    only), ``train --use_disn --use_lap_layer --mesh_dir`` on them and
    ``eval`` of that experiment, each exiting 0 with its files."""
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
    if not worst <= 1.0:
        raise AssertionError(f"restored engine diverged: ratio {worst}")

    data = work / "mesh_data"
    preprocess_s = run("preprocess", "--mesh_dir", str(MESHES),
                       "--dataset_root", str(data), "--watertight_res", "32",
                       "--with_images", "--num_workers", "3")
    shards = sorted(p.name for p in data.glob("mesh_*.npz"))
    for shard in shards:
        with np.load(data / shard) as d:
            if d["imgs"].shape != (64, 64, 3) or not np.isfinite(
                    d["imgs"]).all():
                raise AssertionError(f"{shard}: images {d['imgs'].shape}")
    if len(shards) != 3:
        raise AssertionError(f"preprocess wrote {shards}")
    disn_train_s = run("train", "--device", DEVICE, *CLI_DISN,
                       "--mesh_dir", str(MESHES), "--dataset_root", str(data),
                       "--logdir", str(work / "disn_exp"))
    (disn_exp,) = (work / "disn_exp").iterdir()
    disn_eval_s = run("eval", "--device", DEVICE, "--experiment_path",
                      str(disn_exp), "--eval_points", str(EVAL_POINTS))
    files = sorted(p.name for p in disn_exp.iterdir())
    disn_report = json.loads((disn_exp / "result_update.json").read_text())
    bad = [n for n in METRICS
           if not np.isfinite(disn_report["metrics"].get(n, np.nan))]
    cfg = json.loads((disn_exp / "config.json").read_text())
    if bad or not (cfg["use_disn"] and cfg["use_lap_layer"]) or \
            "result_update.txt" not in files or \
            "meshes" not in disn_report["per_category"]:
        raise AssertionError(f"DISN eval report lacks {bad}: {files} "
                             f"{disn_report}")
    say("cli", train_s=train_s, eval_s=eval_s, metrics=metrics,
        restore_worst_ratio=worst, restore_bit_identical=identical,
        preprocess_s=preprocess_s, shards=shards, disn_train_s=disn_train_s,
        disn_eval_s=disn_eval_s, disn_files=files,
        disn_metrics=disn_report["metrics"])


# The three campaign drivers at toy sizes: each trains (or optimizes) for
# a few steps on the card in a subprocess and writes its metrics.
CAMPAIGNS = {
    "disn": ["torch_disn_campaign.py", "--res", "8", "--epochs", "2",
             "--n_shapes", "8", "--disn_width", "0.125",
             "--eval_points", "2000"],
    # three meshes: a batch of 2 leaves a full validation batch
    "hard_geom": ["torch_hard_geom_campaign.py", "--res", "8",
                  "--batch_size", "2", "--epochs", "2", "--n_aug", "1",
                  "--eval_points", "2000",
                  "--extra", "--watertight_res 32"],
    # stages start while less than budget - reserve - 60 s has passed
    "render": ["torch_render_campaign.py", "--tetres", "8", "--n_views", "8",
               "--image_size", "64", "--sublevels", "1", "--steps_mov", "20",
               "--steps_fix", "20", "--budget_s", "150", "--reserve_s", "30",
               "--min_stage_s", "10"],
}


def campaigns_phase(timeout=600):
    """``scripts/torch_{disn,hard_geom,render}_campaign.py`` on the card at
    toy sizes, the three at once in subprocesses: each exits 0, the two
    training drivers write a ``result_update.json`` with every metric
    finite, the render driver a ``records.json`` whose stages and
    ``final_psnr`` are finite."""
    import os
    import shutil
    import signal

    work = ROOT / "build" / "smoke_campaigns"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    procs = {}
    try:
        for name, (script, *args) in CAMPAIGNS.items():
            out = work / name
            log = open(work / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, str(ROOT / "scripts" / script), "--device",
                 DEVICE, *args, "--outdir", str(out)], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True), log,
                time.perf_counter())
        seconds, rcs, t0 = {}, {}, time.perf_counter()
        while len(rcs) < len(procs):
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"campaign drivers still running after "
                                   f"{timeout} s: {set(procs) - set(rcs)}")
            for name, (proc, _, t) in procs.items():
                if name not in rcs and proc.poll() is not None:
                    rcs[name] = proc.returncode
                    seconds[name] = time.perf_counter() - t
            time.sleep(0.2)
    finally:
        # each driver's group: the driver and the CLI processes it started
        for proc, log, _ in procs.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            log.close()
    failed = {n: rc for n, rc in rcs.items() if rc}
    if failed:
        tails = {n: (work / f"{n}.log").read_text()[-3000:] for n in failed}
        raise RuntimeError(f"campaign drivers failed: {failed}\n{tails}")
    metrics = {}
    for name in ("disn", "hard_geom"):
        (exp,) = (work / name / "exp").iterdir()
        m = json.loads((exp / "result_update.json").read_text())["metrics"]
        bad = [n for n in METRICS if not np.isfinite(m.get(n, np.nan))]
        if bad:
            raise AssertionError(f"{name} campaign: metrics {bad} not "
                                 f"finite: {m}")
        metrics[name] = {n: m[n] for n in METRICS}
    records = json.loads((work / "render" / "records.json").read_text())
    psnrs = [s["psnr"] for s in records["stages"]]
    if not psnrs or not np.isfinite(psnrs + [records["final_psnr"]]).all():
        raise AssertionError(f"render campaign records: {records}")
    metrics["render"] = {"final_psnr": records["final_psnr"],
                         "stages": {s["stage"]: s["psnr"]
                                    for s in records["stages"]}}
    say("campaigns", seconds=seconds, metrics=metrics)


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


class HitRecorder(Recorder):
    """A Recorder of raster_hit's launches, keyed by ``hit_kind``, that
    also keeps the inputs of the last training call (``train_last``, not
    counted apart): the first call is the first step's, before any
    update."""

    def __init__(self):
        from deftet_tpu_torch.render import raster

        super().__init__(lambda name, args: hit_kind(args),
                         {"raster_hit": (raster, "_raster_hit_cuda")})

    def _wrap(self, name):
        launch = super()._wrap(name)

        def keep_last(*args):
            if hit_kind(args) == "train":
                self.inputs["train_last"] = tuple(
                    a.detach().clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
            return launch(*args)
        return keep_last


def hit_recorder():
    return HitRecorder()


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
    last_hit = []  # the last step's hit call: its inputs and counts

    def hit_call(*a):
        out = wrapped(orig_hit, "hit0", "hit1")(*a)
        last_hit[:] = [a, out[2]]
        return out

    parts = {k: [] for k in ("projection_lists", "hit_kernel",
                             "replay_composite", "backward", "adam")}
    try:
        raster._raster_hit_cuda = hit_call
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
    pairs, valid, hits, _ = hit_stats(*last_hit)
    hit_call_stats = {"pairs": pairs, "valid_entries": valid, "hits": hits,
                      "k": last_hit[0][-1], "list_width":
                      int(last_hit[0][5][1] - last_hit[0][5][0])}

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
        hit_call=hit_call_stats, frame_s=frame)


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
    * P not a multiple of the tile (1,000 pixels, tiles of 256);
    * stacks of equal z cut at k 100 and 600, kept whole at k 500, and
      cut at k 2100 (past the buffered rows): list order among equal z,
      counts exact."""
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
    # stacks of many equal z: ties at the cut (k 100 and 600, the buffered
    # rows' overflow), kept whole (k 500), and past the buffered rows
    tied = -(1.0 + torch.randint(0, 20, (2200,), generator=gen).float())
    tied = tied.to(device)
    stacks = {"ties_cut": (400, 100), "deep_rows": (400, 500),
              "deep_cut": (700, 600), "past_buffered_rows": (2200, 2100)}
    if device == "cuda" and raster.max_buffered_k() >= 2100:
        raise AssertionError("the deepest edge case no longer passes the "
                             "buffered rows")
    for name, (n_f, k) in stacks.items():
        cases[name] = (uniform(64, 2, lo=-0.9, hi=0.9),
                       tied[:n_f, None].expand(n_f, 3), big.expand(n_f, 3, 2),
                       None, 64, k)

    def stack_expect(n_f, k):
        order = torch.sort(tied[:n_f], descending=True, stable=True)[1][:k]
        want = torch.full((k,), -1, dtype=torch.int32, device=device)
        want[:order.shape[0]] = order.to(torch.int32)
        return lambda ids, zs, c: bool((c == n_f).all()) and torch.equal(
            ids, want.expand_as(ids))

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
        **{name: stack_expect(*nk) for name, nk in stacks.items()},
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



# ------------------------------------------------------------ data parallel
# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# device); a one-rank world runs on NCCL.  Tolerances of the data-parallel
# contract (tests/test_train.py's sharded-against-single test): terms rtol
# 2e-4 / atol 1e-6, gradients rtol 2e-3 / atol 1e-5.
DDP_TERMS, DDP_GRADS = (2e-4, 1e-6), (2e-3, 1e-5)
DDP_RANKS = 2


def ddp_config(**over):
    """The CPU tests' data-parallel configuration: the small network at res
    4 in float32, batch 4, dropout in both decoders, input noise and a
    random center subsample."""
    kw = dict(batch_size=4, occ_sample=64, occ_mlp_hidden="16,0.2,8",
              pos_mlp_hidden="8,0.3")
    kw.update(over)
    return small_config(**kw)


def ddp_record(cfg, batch, world=None, device=None):
    """One Engine step (of ``world``'s rank, or of one process): its
    terms, the gradient the optimizer was handed and the BatchNorm
    statistics after it, on the CPU."""
    from deftet_tpu_torch.train import Engine

    engine = Engine(cfg, device=device or DEVICE, world=world)
    grads = []
    step = engine.optimizer.step

    def record(g):
        grads.append([t.detach().cpu().clone() for t in g])
        step(g)

    engine.optimizer.step = record
    terms = engine.train_step(engine._prep_batch(batch))
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grads": grads[0],
            "stats": {n: v.detach().cpu().clone()
                      for n, v in engine.model.named_buffers()}}


def _ddp_parity_rank(world, cases):
    return {"backend": world.backend, "device": str(world.device),
            **{name: ddp_record(cfg, batch, world)
               for name, (cfg, batch) in cases.items()}}


def _one_rank_identity(world, cfg, batch):
    """A one-rank world's step against an Engine without one, in the same
    process, deterministic algorithms on for both; also two runs without
    a world, to show the determinism the comparison needs."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a = ddp_record(cfg, batch, device=world.device)
        b = ddp_record(cfg, batch, device=world.device)
        c = ddp_record(cfg, batch, world=world)

    def same(x, y):
        return (x["terms"] == y["terms"]
                and all(torch.equal(g, h)
                        for g, h in zip(x["grads"], y["grads"]))
                and all(torch.equal(x["stats"][k], y["stats"][k])
                        for k in x["stats"]))

    nondet = sorted({str(w.message)[:120] for w in caught
                     if "determinis" in str(w.message)})
    return {"backend": world.backend, "same_without_world": same(a, b),
            "same_with_world": same(a, c), "nondeterministic_ops": nondet}


def ddp_parity():
    """Two ranks sharing the card (gloo over CUDA tensors) against the
    one-process step on the card, with dropout, and with grad_accum=2 and
    remat; then a one-rank NCCL world against an Engine without a world,
    bit for bit."""
    import os

    from deftet_tpu_torch import parallel

    cases = {"dropout": ddp_config(),
             "accum_remat": ddp_config(grad_accum=2, remat=True)}
    cases = {k: (cfg, bench_batch(cfg, level=1, occ_res=16))
             for k, cfg in cases.items()}
    torch.cuda.empty_cache()
    ranks = parallel.run_ranks(_ddp_parity_rank, DDP_RANKS, cases,
                               device=DEVICE)
    report = {"backend": [r["backend"] for r in ranks],
              "devices": [r["device"] for r in ranks]}
    worst = 0.0
    for name, (cfg, batch) in cases.items():
        ref = ddp_record(cfg, batch)
        for rank, got in enumerate(ranks):
            got = got[name]
            r_terms = max(ratio(got["terms"][k], v, *DDP_TERMS)
                          for k, v in ref["terms"].items())
            r_grads = max(ratio(g, h, *DDP_GRADS)
                          for g, h in zip(got["grads"], ref["grads"]))
            r_stats = max(ratio(got["stats"][k], v, *DDP_TERMS)
                          for k, v in ref["stats"].items())
            report[f"{name}_rank{rank}"] = dict(terms=r_terms, grads=r_grads,
                                                stats=r_stats)
            worst = max(worst, r_terms, r_grads, r_stats)
    say("ddp_parity", worst_ratio=worst, ratios=report,
        tolerances={"terms": DDP_TERMS, "grads": DDP_GRADS})
    if report["backend"] != ["gloo"] * DDP_RANKS:
        raise AssertionError(f"two ranks on one card: {report['backend']}")
    if worst > 1.0:
        raise AssertionError(f"2-rank step differs from one process: {worst}")

    cfg, batch = cases["dropout"]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    one = parallel.run_ranks(_one_rank_identity, 1, cfg, batch,
                             device=DEVICE)[0]
    say("ddp_one_rank", **one)
    if one["backend"] != "nccl":
        raise AssertionError(f"a one-rank world on {one['backend']}")
    if not one["same_with_world"]:
        raise AssertionError("the one-rank NCCL step differs from the "
                             "step without a world")


def _ddp_step_rank(world, cfg, batch_np, smi):
    """bench.py's configuration as this rank's rows: one warm-up and
    TIMED_STEPS timed steps, each with its launches counted; rank 0 then
    holds K1-K3 against their plain versions at the inputs its path gave
    them, with the other rank finished."""
    from deftet_tpu_torch.ops import _cuda
    from deftet_tpu_torch.train import Engine

    engine = Engine(cfg, world=world)
    batch = engine._prep_batch(batch_np)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, per_step = [], []
    with Recorder(variant_key) as rec:
        for step in range(1 + TIMED_STEPS):
            torch.distributed.barrier()
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t = time.perf_counter()
            terms = engine.train_step(batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts = dict(_cuda.launch_counts)
            terms = {k: float(v) for k, v in terms.items()}
            bad = [k for k, v in terms.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"rank {world.rank}: non-finite {bad}")
            if counts != LAUNCHES_PER_STEP:
                raise AssertionError(f"rank {world.rank}: launches {counts}"
                                     f" != {LAUNCHES_PER_STEP}")
            per_step.append(counts)
            if step:
                step_s.append(dt)
    out = dict(rank=world.rank, backend=world.backend,
               device=str(world.device),
               rows=int(batch["surface_points"].shape[0]),
               median_step_s=statistics.median(step_s), step_s=step_s,
               spread_s=max(step_s) - min(step_s),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               launches_per_step=per_step[-1],
               launches_total={k: sum(c[k] for c in per_step)
                               for k in LAUNCHES_PER_STEP},
               terms=terms)
    say("ddp_step_rank", card=smi,
        note="two ranks share one card: not a scaling number", **out)
    torch.distributed.barrier()
    if world.rank == 0:
        per_variant = {k: c / (1 + TIMED_STEPS) for k, c in rec.counts.items()}
        out["kernels"] = {
            "stencil": check_stencil(rec.inputs, per_variant,
                                     label="kernel_stencil_ddp"),
            "nearest": check_nearest(rec.inputs[("nearest",)],
                                     label="kernel_nearest_ddp"),
            "tri_argmin": check_tri_argmin(rec.inputs[("tri_argmin",)],
                                           label="kernel_tri_argmin_ddp"),
        }
    return out


def ddp_step(smi):
    """The main cell (res 50, batch 4, bf16) as two ranks of 2 rows each
    on the one card, gloo over CUDA tensors: per rank the median step, its
    spread, the peak memory and the launches of each step (K1 10, K2 1,
    K3 1).  Two processes share one card here, so the step time is not a
    scaling number."""
    from deftet_tpu_torch import parallel

    cfg = bench_config()
    torch.cuda.empty_cache()
    ranks = parallel.run_ranks(_ddp_step_rank, DDP_RANKS, cfg,
                               bench_batch(cfg), smi, device=DEVICE)
    totals = {r["terms"]["total"] for r in ranks}
    say("ddp_step", backend=ranks[0]["backend"], card=smi,
        note="two ranks share one card: not a scaling number",
        median_step_s=[r["median_step_s"] for r in ranks],
        spread_s=[r["spread_s"] for r in ranks],
        max_memory_allocated_bytes=[r["max_memory_allocated_bytes"]
                                    for r in ranks],
        launches_per_step=[r["launches_per_step"] for r in ranks],
        equal_terms=len(totals) == 1)
    if len(totals) != 1:
        raise AssertionError(f"the ranks' terms differ: {totals}")
    return ranks[0]


def dryrun_phase():
    """``entry()`` on the card against the same forward on the CPU (rtol
    1e-4, atol 1e-5: float32, TF32 off), then ``dryrun_multidevice(2)``:
    two ranks sharing the card over gloo."""
    from deftet_tpu_torch import dryrun

    fn, args = dryrun.entry()
    fn(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t
    cpu_fn, _ = dryrun.entry(device="cpu")
    ref = cpu_fn(*(a.cpu() for a in args))
    ratios = [ratio(o, r, 1e-4, 1e-5) for o, r in zip(out, ref)]
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    multi = dryrun.dryrun_multidevice(2)
    say("dryrun", entry_s=entry_s, entry_shapes=[list(o.shape) for o in out],
        entry_ratios=ratios, multidevice=multi)
    if not finite or max(ratios) > 1.0:
        raise AssertionError(f"entry(): finite {finite}, ratios {ratios}")
    if any(r["backend"] != "gloo" for r in multi):
        raise AssertionError("two ranks on one card must share it over gloo")


def sampling_phase():
    """ops.sampling on the card against the CPU at a moderate size: FPS
    over 2 x 16,384 points to 1,024 (indices equal), ball query (radius
    0.1, 32 slots) and 3-NN at those 1,024 centers: indices equal except
    where a point lies within float32 rounding of the radius or of the
    third neighbour (each such row counted), 3-NN values within rtol 1e-5
    plus the error the expanded distance's rounding puts in its weights.
    FPS, ball query and 3-NN timed."""
    from deftet_tpu_torch.ops import sampling

    gen = torch.Generator().manual_seed(12)
    pts = torch.rand((2, 16384, 3), generator=gen) * 2 - 1
    feats = torch.randn((2, 1024, 32), generator=gen)
    g_pts, g_feats = pts.to(DEVICE), feats.to(DEVICE)

    idx = sampling.furthest_point_sample(g_pts, 1024)
    ref_idx = sampling.furthest_point_sample(pts, 1024)
    if not torch.equal(idx.cpu(), ref_idx):
        raise AssertionError("FPS indices differ between card and CPU")
    centers = sampling.gather_points(pts, ref_idx)
    g_centers = centers.to(DEVICE)

    bq = sampling.ball_query(g_centers, g_pts, 0.1, 32).cpu()
    bq_ref = sampling.ball_query(centers, pts, 0.1, 32)
    d2 = sampling._pairwise_sqdist(centers, pts)
    bq_ties = 0
    for b, m in torch.nonzero((bq != bq_ref).any(-1)).tolist():
        if not bool(((d2[b, m] - 0.01).abs() <= 1e-6).any()):
            raise AssertionError(f"ball query differs at {b, m}: no tie")
        bq_ties += 1

    # 3-NN: the neighbours equal (a stable sort of the expanded distance
    # on each device) except where the third and fourth are within
    # rounding; the values within what that distance's rounding allows.
    # It carries an absolute error of ~u (|p|^2 + |c|^2) (u = 2^-23), so
    # a weight w ~ 1/d moves by up to ~4 u (|p|^2 + |c|^2) / d_min of
    # itself: 3e-5 at a point 0.01 from its nearest center, and a point
    # that is itself a center (d ~ rounding noise, clamped at 1e-10) has
    # weights of noise on either device.
    dp, ip = sampling._pairwise_sqdist(pts, centers).sort(dim=-1, stable=True)
    g_dp, g_ip = sampling._pairwise_sqdist(g_pts, g_centers).sort(
        dim=-1, stable=True)
    nn_ties = 0
    for b, n in torch.nonzero(
            (g_ip[..., :3].cpu() != ip[..., :3]).any(-1)).tolist():
        if float(dp[b, n, 3] - dp[b, n, 2]) > 1e-6:
            raise AssertionError(f"3-NN neighbours differ at {b, n}: no "
                                 f"tie, d2 {dp[b, n, :4].tolist()}")
        nn_ties += 1
    del g_dp, g_ip
    nn = sampling.three_nn_interpolate(g_pts, g_centers, g_feats).cpu()
    nn_ref = sampling.three_nn_interpolate(pts, centers, feats)
    u = 2.0 ** -23
    scale = (pts * pts).sum(-1) + (centers * centers).sum(-1).amax(-1,
                                                                 keepdim=True)
    weight_err = 4 * u * scale / dp[..., 0].clamp(min=1e-10)
    tol = (1e-6 + 1e-5 * nn_ref.abs()
           + weight_err[..., None] * feats.abs().amax(dim=(1, 2))[:, None,
                                                                  None])
    nn_ratio = float(((nn - nn_ref).abs() / tol).max())
    at_center = int((dp[..., 0] <= 1e-6).sum())
    if nn_ratio > 1.0:
        raise AssertionError(f"3-NN values differ: ratio {nn_ratio}")
    fps_ms = cuda_ms(lambda: sampling.furthest_point_sample(g_pts, 1024), 3)
    bq_ms = cuda_ms(lambda: sampling.ball_query(g_centers, g_pts, 0.1, 32),
                    10)
    nn_ms = cuda_ms(lambda: sampling.three_nn_interpolate(
        g_pts, g_centers, g_feats), 10)
    say("sampling", fps_equal=True, ball_query_tie_rows=bq_ties,
        three_nn_tie_points=nn_ties, three_nn_points_at_a_center=at_center,
        three_nn_ratio=nn_ratio,
        three_nn_plain_ratio=ratio(nn, nn_ref, 1e-5, 1e-6),
        fps_ms=fps_ms, ball_query_ms=bq_ms, three_nn_ms=nn_ms,
        shape="2 x 16,384 points, 1,024 centers")


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
                  "pairs", "hits", "insertion_work", "plain_points",
                  "stats", "found", "share"):
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
    timed("stencil_launches", stencil_launches)
    timed("parity", parity)
    timed("parity_train", parity_train)
    timed("parity_eval", parity_eval)
    timed("parity_lap_disn", parity_lap_disn)
    timed("parity_gather", parity_gather)
    timed("parity_se", parity_se)
    lap_inputs, lap_launches, lap_per_variant = timed("lap_step", lap_step)
    lap_kernels = timed("lap_kernels", check_lap_kernels, lap_inputs,
                        lap_per_variant)
    del lap_inputs
    ev_data = timed("eval_data", eval_data)
    disn_inputs, disn_launches, disn_per_variant = timed(
        "disn_step", disn_step, ev_data[0])
    disn_kernels = timed("disn_kernels", check_disn_kernels, disn_inputs,
                         disn_per_variant)
    del disn_inputs
    torch.cuda.empty_cache()
    inputs, launches, per_variant, engine = timed("main", main_path,
                                                  bench_config())
    ev = timed("eval", eval_phase, engine, ev_data)
    del engine
    torch.cuda.empty_cache()
    results = timed("kernels", lambda: {
        "stencil": check_stencil(inputs, per_variant),
        "nearest": check_nearest(inputs[("nearest",)]),
        "tri_argmin": check_tri_argmin(inputs[("tri_argmin",)]),
    })
    nearest_eval = timed("kernel_nearest_eval", check_nearest_eval)
    eval_kernels = timed("eval_kernels", check_eval_kernels, ev)
    timed("point_tet_edge_cases", check_point_tet_edge_cases)
    timed("grid_probe_cases", check_grid_probe_cases)
    unc_inputs, unc_launches = timed("uncompacted_step", uncompacted_step)
    unc_kernels = timed("uncompacted_kernels", check_uncompacted_kernels,
                        unc_inputs)
    del unc_inputs
    g_inputs, g_launches, g_engine, g_topology = timed("gather_step",
                                                       gather_step)
    g_point_tet, g_grid_probe = timed("gather_eval", gather_eval, g_engine,
                                      ev_data)
    timed("native_topology", native_topology, *g_topology, g_engine.statics)
    timed("lattice_statics", lattice_statics)
    del g_engine, g_topology
    torch.cuda.empty_cache()
    g_kernels = timed("gather_kernels", check_gather_kernels, g_inputs)
    del g_inputs
    timed("ddp_parity", ddp_parity)
    ddp = timed("ddp_step", ddp_step, smi)
    timed("dryrun", dryrun_phase)
    timed("sampling", sampling_phase)
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
        "train_last": check_raster_hit(r_inputs["train_last"],
                                       "kernel_raster_hit_train_last"),
        "frame": check_raster_hit(r_inputs["frame"],
                                  "kernel_raster_hit_frame"),
        "count": check_raster_hit(r_inputs["count"],
                                  "kernel_raster_hit_count"),
        "subdiv": check_raster_hit(s_inputs["frame"],
                                   "kernel_raster_hit_subdiv"),
    })
    timed("raster_edge_cases", check_raster_edge_cases)
    timed("render_cli", render_cli)
    timed("campaigns", campaigns_phase)

    kernels = []
    for name, res in results.items():
        kernels.append(kernel_entry(name, res, launches[name], "main"))
        if name == "nearest":
            kernels[-1]["eval_shape"] = {
                k: nearest_eval[k] for k in ("shape", "ms", "plain_ms",
                                             "bound_ms", "no_fma_ceiling_ms",
                                             "plan")}
    for name, res in ddp["kernels"].items():
        kernels.append(kernel_entry(
            name, res, ddp["launches_total"][name],
            "ddp_step (res 50, batch 4, bf16 as 2 ranks of 2 rows sharing "
            "one card over gloo): rank 0"))
    for name, res in paper_kernels.items():
        kernels.append(kernel_entry(
            name, res, paper_rows[False]["launches_total"][name],
            "paper_step (res 70, batch 8, grad_accum 2, no remat)"))
    kernels.append(kernel_entry(
        "stencil", lap_kernels, lap_launches["stencil"],
        "lap_step (res 50, batch 4, bf16, use_lap_layer): the lap head's "
        "GCN forward at C = 256; step_ms weights its calls by both heads' "
        "launches"))
    for name, res in disn_kernels.items():
        kernels.append(kernel_entry(
            name, res, disn_launches[name],
            "disn_step (res 50, batch 4, use_disn, VGG-16 at full width)"
            + (": the Laplacian, C = 3" if name == "stencil" else "")))
    kernels.append(kernel_entry("stencil", eval_kernels["stencil"],
                                ev["launches"]["stencil"], "eval"))
    kernels.append(kernel_entry("nearest", eval_kernels["nearest"],
                                ev["launches"]["nearest"], "eval"))
    for side, res in eval_kernels["tri_argmin"].items():
        kernels.append(kernel_entry("tri_argmin", res,
                                    ev["launches"]["tri_argmin"],
                                    f"eval: Hausdorff {side}"))
    kernels.append(kernel_entry(
        "point_tet", ev["point_tet"], ev["launches"]["point_tet"],
        "eval: occupancy at the SDF points, 4 x 20,000 against 750,000 "
        "deformed tets"))
    kernels.append(kernel_entry(
        "grid_probe", ev["grid_probe"], ev["launches"]["grid_probe"],
        "eval: the full-grid occupancy's rows, 8 chunks of 4 x 100,000 tet "
        "centres (the last 4 x 50,000) against the 4-level pyramid"))
    kernels.append(kernel_entry(
        "point_tet", g_point_tet, g_point_tet["launches_per_run"],
        "gather_eval (res-25 grid split 1->8, 750,000 tets): 4 x 20,000 "
        "SDF points"))
    kernels.append(kernel_entry(
        "grid_probe", g_grid_probe, g_grid_probe["launches_per_run"],
        "gather_eval (res-25 grid split 1->8, 750,000 tets): the full-grid "
        "occupancy's rows, 8 chunks of 4 x 100,000 centres in the split "
        "grid's order"))
    for name, res in unc_kernels.items():
        kernels.append(kernel_entry(
            name, res, unc_launches[name],
            "uncompacted_step (res 50, batch 4, bf16, max_boundary_faces 0):"
            + (" chamfer, 1 sample on each of the 12 r^3 face slots"
               if name == "nearest" else " the analytic term against every "
               "face under the boundary mask; the plain version on the "
               "first 1,000 points of each batch element")))
    for name, res in g_kernels.items():
        kernels.append(kernel_entry(
            name, res, g_launches[name],
            "gather_step (res-25 grid split 1->8 from a .tet file, 750,000 "
            "tets, batch 4, bf16): no K1 launch"))
    for path, res, n in (
            ("render: training step, res 40, 25 tiles of 16x16 (first "
             "step)", raster_rows["train"], r_counts["train"]),
            ("render: full frame 400x400, k 300", raster_rows["frame"],
             r_counts["frame"]),
            ("render: calibration count (k 0), one unbinned tile against "
             "every face", raster_rows["count"],
             r_counts["count"]),
            ("render_subdiv: full frame of the subdivided snapshot",
             raster_rows["subdiv"], s_counts["frame"])):
        kernels.append(kernel_entry("raster_hit", res, n, path))
        if res is raster_rows["train"]:
            # the same path's last call: its launches are the row's own
            kernels[-1]["last_step"] = {
                k: raster_rows["train_last"][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "max_abs_err", "shape", "pairs", "hits")
                if k in raster_rows["train_last"]}
    say("done", seconds=time.perf_counter() - t0, phase_seconds=phase_s,
        card=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
