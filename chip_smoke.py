"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on lines of its own:

1. header  — torch / CUDA versions and the card's name and power limit;
2. build   — the three CUDA kernels (csrc/*.cu), compiled anew, in parallel;
3. parity  — the small configuration in float32: one forward + backward on
   the CPU (plain PyTorch versions of the kernels) and one on the card
   (the kernels), from the same parameters and injected draws;
4. main    — the full-width res-50 / batch-4 train step (bench.py's
   configuration, bf16) through ``Engine``: one warm-up step and five
   timed steps, launch counts per kernel read around them;
5. kernels — each kernel on the inputs the main path gave it, held
   against its plain version on the card and timed beside its bound and
   the nearest single PyTorch call;
6. the ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero and prints no result.
It needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM published peaks (dense): HBM3 bytes/s and float32
# CUDA-core FLOP/s.  Every kernel here computes in float32.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# Kernel launches per full-width train step (see PERF.md): the stencil
# runs 4x in the GCN (C = 256) and once for the Laplacian term (C = 3),
# each with its backward; chamfer and the analytic term launch once each.
LAUNCHES_PER_STEP = {"stencil": 10, "nearest": 1, "tri_argmin": 1}
TIMED_STEPS = 5

KERNEL_INFO = {
    "stencil": ("deftet_tpu_torch/csrc/stencil.cu",
                "deftet_tpu/ops/stencil_pallas.py:46"),
    "nearest": ("deftet_tpu_torch/csrc/nearest.cu",
                "deftet_tpu/ops/nearest_pallas.py:33"),
    "tri_argmin": ("deftet_tpu_torch/csrc/tri_argmin.cu",
                   "deftet_tpu/ops/tri_distance_pallas.py:32"),
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


class Recorder:
    """Wraps each kernel's launch function to keep a copy of the inputs
    of its first launch per variant during the main path."""

    def __init__(self):
        from deftet_tpu_torch.ops import nearest, stencil, tri_distance

        self.mods = {"stencil": (stencil, "_stencil_cuda"),
                     "nearest": (nearest, "_nearest_cuda"),
                     "tri_argmin": (tri_distance, "_tri_argmin_cuda")}
        self.orig = {k: getattr(m, a) for k, (m, a) in self.mods.items()}
        self.inputs = {}

    def _wrap(self, name):
        orig = self.orig[name]

        def launch(*args):
            if name == "stencil":
                x, n, offsets, scale = args
                key = (name, str(x.dtype).split(".")[-1], x.shape[-1],
                       "forward" if scale is not None else "backward")
            else:
                key = (name,)
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
    del engine, batch
    torch.cuda.empty_cache()
    return rec.inputs, launches


# ------------------------------------------------------------ kernel checks
def check_stencil(inputs):
    """Every K1 variant of the main path, plus the bf16 GCN inputs in f32
    (the precision="f32" path), against the plain version.  Same sum
    order in both, so they agree exactly; the tolerance (1e-6 relative,
    plus one bf16 rounding for bf16 outputs) only covers a reordered sum."""
    import torch.nn.functional as F

    from deftet_tpu_torch.ops import stencil

    cases = {k: v for k, v in inputs.items() if k[0] == "stencil"}
    for way in ("forward", "backward"):
        x, *rest = cases[("stencil", "bfloat16", 256, way)]
        cases[("stencil", "float32", 256, way)] = (x.float(), *rest)
    fwd = cases[("stencil", "bfloat16", 256, "forward")]
    report = {}
    for key, (x, n, offsets, scale) in sorted(cases.items(), key=str):
        got = stencil.stencil_sum(x, n, offsets, scale)
        ref = stencil.stencil_sum_plain(x, n, offsets, scale)
        err = float((got.float() - ref.float()).abs().max())
        tol = 1e-6 * float(ref.float().abs().max()) + (
            2.0**-8 * float(ref.float().abs().max())
            if x.dtype == torch.bfloat16 else 0.0)
        report["/".join(map(str, key[1:]))] = {"shape": list(x.shape),
                                               "max_abs_err": err}
        if not err <= tol:
            raise AssertionError(f"stencil {key}: max err {err} > {tol}")

    # timing on the dominant main-path call: the GCN forward at C = 256
    x, n, offsets, scale = fwd
    b, v, c = x.shape
    ms = cuda_ms(lambda: stencil.stencil_sum(x, n, offsets, scale), 20)
    plain_ms = cuda_ms(
        lambda: stencil.stencil_sum_plain(x, n, offsets, scale), 3)
    # the library yardstick: depthwise conv3d with the binary stencil
    # (channels-last view of x, no copy), times the per-vertex scale
    w = torch.zeros((c, 1, 3, 3, 3), dtype=x.dtype, device=x.device)
    for di, dj, dk in offsets:
        w[:, 0, 1 + di, 1 + dj, 1 + dk] = 1
    x5 = x.view(b, n, n, n, c).permute(0, 4, 1, 2, 3)
    s5 = scale.view(1, 1, n, n, n)

    def library():
        return (F.conv3d(x5, w, padding=1, groups=c).float() * s5).to(
            x.dtype)

    lib_err = float((library().permute(0, 2, 3, 4, 1).reshape(b, v, c)
                     .float() - stencil.stencil_sum_plain(
                         x, n, offsets, scale).float()).abs().max())
    library_ms = cuda_ms(library, 10)
    # in-lattice neighbour reads: the adds this input needs
    ijk = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    reads = sum(int(np.all((ijk + o >= 0) & (ijk + o < n), -1).sum())
                for o in np.asarray(offsets))
    n_flops = b * c * (reads + v)  # one add per read, one scale multiply
    n_bytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
    bms, by = bound_ms(n_bytes, n_flops)
    worst = max(r["max_abs_err"] for r in report.values())
    say("kernel_stencil", variants=report, library_max_abs_err=lib_err)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms, max_abs_err=worst,
                shape=f"x {list(x.shape)} {str(x.dtype).split('.')[-1]}")


def check_nearest(inputs):
    """K2 against the plain version: indices equal except at near-ties,
    and the distance at each returned index equal to 1e-6 relative (both
    compute the direct difference in the same order without FMA)."""
    from deftet_tpu_torch.ops import nearest

    q, r, n_valid, n_queries = inputs[("nearest",)]
    d, i = nearest.nearest_neighbor(q, r, n_valid, n_queries)
    d_ref, i_ref = nearest.nearest_neighbor_plain(q, r, n_valid, n_queries)
    err = float((d - d_ref).abs().max())
    tie = (d - d_ref).abs() <= 1e-6 * d_ref.abs() + 1e-12
    if not err <= 1e-6 * float(d_ref.abs().max()) + 1e-12:
        raise AssertionError(f"nearest distance max err {err}")
    if not bool(torch.all((i == i_ref) | tie)):
        raise AssertionError("nearest indices differ away from ties")
    n_diff = int((i != i_ref).sum())

    ms = cuda_ms(lambda: nearest.nearest_neighbor(q, r, n_valid, n_queries),
                 20)
    plain_ms = cuda_ms(
        lambda: nearest.nearest_neighbor_plain(q, r, n_valid, n_queries), 3)
    b, p, _ = q.shape
    tile = nearest.QUERY_TILE
    live = torch.clamp((n_queries + tile - 1) // tile * tile, max=p)
    pairs = int((live.long() * n_valid.long()).sum())
    n_flops = 8 * pairs  # 3 sub, 3 mul, 2 add per pair
    n_bytes = q.numel() * 4 + r.numel() * 4 + 8 * b * p
    bms, by = bound_ms(n_bytes, n_flops)

    def library():  # the (B, P, M) distance matrix, then its row minima
        return torch.cdist(q, r).min(dim=-1)

    library_ms = cuda_ms(library, 3)
    say("kernel_nearest", shape=[list(q.shape), list(r.shape)],
        n_queries=n_queries.tolist(), n_valid=n_valid.tolist(),
        pairs=pairs, max_abs_err=err, index_differences_at_ties=n_diff)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms, max_abs_err=err,
                shape=f"queries {list(q.shape)} refs {list(r.shape)} f32")


def check_tri_argmin(inputs):
    """K3 against the plain version: the point-triangle distance at the
    returned faces agrees to 1e-6 relative (same region order and
    arithmetic, no FMA); indices may differ only at near-ties."""
    from deftet_tpu_torch.ops import tri_distance

    pts, tri, mask, n_active = inputs[("tri_argmin",)]

    def d2_at(idx):
        sel = torch.gather(tri, 1, idx.long()[:, :, None, None].expand(
            -1, -1, 3, 3))
        return tri_distance.point_triangle_squared_distance(
            pts, sel[..., 0, :], sel[..., 1, :], sel[..., 2, :])

    i = tri_distance.tri_argmin(pts, tri, mask)
    i_ref = tri_distance.tri_argmin_plain(pts, tri, mask, n_active)
    d, d_ref = d2_at(i), d2_at(i_ref)
    err = float((d - d_ref).abs().max())
    if not err <= 1e-6 * float(d_ref.abs().max()) + 1e-12:
        raise AssertionError(f"tri_argmin distance max err {err}")
    n_diff = int((i != i_ref).sum())

    ms = cuda_ms(lambda: tri_distance.tri_argmin(pts, tri, mask), 20)
    plain_ms = cuda_ms(
        lambda: tri_distance.tri_argmin_plain(pts, tri, mask, n_active), 3)
    b, p, _ = pts.shape
    f_idx = torch.arange(tri.shape[1], device=tri.device)[None]
    scanned = (mask > 0) & (f_idx < n_active[:, None])
    pairs = int(scanned.sum()) * p
    # region-test closest point, interior path: 78 flops per pair
    n_flops = 78 * pairs
    n_bytes = pts.numel() * 4 + tri.numel() * 4 + mask.numel() * 4 + 4 * b * p
    bms, by = bound_ms(n_bytes, n_flops)
    say("kernel_tri_argmin", shape=[list(pts.shape), list(tri.shape)],
        n_active=n_active.tolist(), pairs=pairs, max_abs_err=err,
        index_differences_at_ties=n_diff)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, max_abs_err=err,
                shape=f"points {list(pts.shape)} faces {list(tri.shape)} f32")


def check_edge_cases(device="cuda"):
    """The kernels' masking and skip paths, which the main path's inputs
    (every query tile live, every face unmasked) do not reach: against
    the plain versions, small shapes, same tolerances as above."""
    from deftet_tpu_torch.ops import nearest, stencil, tri_distance
    from deftet_tpu_torch.tetgrid import build_tet_grid
    from deftet_tpu_torch.train.statics import lattice_offsets

    gen = torch.Generator(device="cpu").manual_seed(5)

    def uniform(*shape):
        return (torch.rand(shape, generator=gen) * 2 - 1).to(device)

    report = {}
    offsets = lattice_offsets(build_tet_grid(5))
    scale = torch.rand(6**3, generator=gen).to(device)
    for dtype in (torch.float32, torch.bfloat16):
        for c in (3, 40, 130):
            x = uniform(2, 6**3, c).to(dtype)
            for s in (scale, None):
                got = stencil.stencil_sum(x, 6, offsets, s)
                ref = stencil.stencil_sum_plain(x, 6, offsets, s)
                if not torch.equal(got, ref):
                    raise AssertionError(f"stencil edge case {dtype} C={c}")
    report["stencil"] = "C in (3, 40, 130), f32 and bf16, scaled and not"

    # n_valid masking (incl. no valid reference), the 512-query-tile skip
    # and more references than the TPU kernel's 16,384 VMEM cap
    q, r = uniform(3, 1300, 3), uniform(3, 20000, 3)
    nv = torch.tensor([20000, 17000, 0], dtype=torch.int32, device=device)
    nq = torch.tensor([300, 1030, 1300], dtype=torch.int32, device=device)
    d, i = nearest.nearest_neighbor(q, r, nv, nq)
    d_ref, i_ref = nearest.nearest_neighbor_plain(q, r, nv, nq)
    tie = (d - d_ref).abs() <= 1e-6 * d_ref.abs()
    if not (torch.allclose(d, d_ref, rtol=1e-6, atol=0)
            and bool(torch.all((i == i_ref) | tie))):
        raise AssertionError("nearest edge cases disagree")
    if not (bool(torch.all(d[0, 512:] == 0)) and bool(torch.all(i[2] == 0))
            and bool(torch.all(d[2] >= 1e29))):
        raise AssertionError("nearest skip / no-valid outputs wrong")
    report["nearest"] = "n_valid (0, 17000, 20000), n_queries tile skip"

    # masked faces, a face prefix past n_active, an all-masked batch
    pts, tri = uniform(3, 3000, 3), uniform(3, 2500, 3, 3)
    mask = (torch.rand(3, 2500, generator=gen) < 0.7).float().to(device)
    mask[1, 2000:] = 0
    mask[2] = 0
    i = tri_distance.tri_argmin(pts, tri, mask)
    i_ref = tri_distance.tri_argmin_plain(
        pts, tri, mask, tri_distance.active_face_count(mask))

    def d2_at(idx):
        sel = torch.gather(tri, 1, idx.long()[:, :, None, None].expand(
            -1, -1, 3, 3))
        return tri_distance.point_triangle_squared_distance(
            pts, sel[..., 0, :], sel[..., 1, :], sel[..., 2, :])

    if not torch.allclose(d2_at(i), d2_at(i_ref), rtol=1e-6, atol=1e-12):
        raise AssertionError("tri_argmin edge cases disagree")
    if not (bool(torch.all(i[2] == 0)) and int(i[1].max()) < 2000
            and bool(torch.all(mask.gather(1, i[:2].long()) > 0))):
        raise AssertionError("tri_argmin picked a masked face")
    report["tri_argmin"] = "masked faces, n_active 2000, all masked"
    say("kernel_edge_cases", **report)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import deftet_tpu_torch

    if Path(deftet_tpu_torch.__file__).resolve().parents[1] != ROOT:
        raise RuntimeError("deftet_tpu_torch must come from this checkout")

    t0 = time.perf_counter()
    smi = header()
    build()
    parity()
    inputs, launches = main_path(bench_config())
    results = {
        "stencil": check_stencil(inputs),
        "nearest": check_nearest(inputs),
        "tri_argmin": check_tri_argmin(inputs),
    }
    check_edge_cases()
    kernels = []
    for name, res in results.items():
        source, replaces = KERNEL_INFO[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            "shape": res["shape"],
        })
    say("done", seconds=time.perf_counter() - t0, card=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
