"""Time one kernel, or the paper recipe's step, of two checkouts of this
repository on one NVIDIA GPU, in turns; or split the hit kernel's time.

    python3 chip_compare.py OTHER_CHECKOUT [nearest|raster_hit|stencil|paper_step]
    python3 chip_compare.py --ablate

Each turn is a fresh process that imports ``deftet_tpu_torch`` from one
checkout (building its kernel there) and times the kernel's wrapper with
CUDA events on inputs from seeded generators.  Modes:

* nearest (the default), K2 at two shapes:
  main — the res-50 / batch-4 train step's chamfer call: 4 x 200,000
  queries against 5,000 references, uniform in a box;
  eval — the eval metrics' call: 100,000 against 100,000 points on the
  unit sphere (``chip_smoke.sphere_clouds``);
* raster_hit, the hit pass at the render path's shapes, 777,600 random
  triangles (centres uniform over the screen, corners within 0.04 NDC of
  them, ~95 faces over a pixel):
  count — the calibration's count-only call: one tile of 6,400 random
  pixels against every face, k 0;
  frame — a 400x400 frame in 625 tiles of 16x16 pixels, each tile's list
  the faces whose bounding box meets the tile's, ascending, k 300;
* stencil, K1's Laplacian backward at res 50: (4, 132,651, 3) float32
  with ``in_scale`` = 1 / degree;
* paper_step, the res-70 / batch-8 grad_accum=2 paper recipe without
  remat (``chip_smoke.paper_config``): a warm-up and three steps,
  the median step time and the peak (``max_memory_allocated`` from before
  the warm-up).  No checksum: two checkouts may round the bf16 network
  differently.

The turns run other, this, this, other.  Prints the card's name and power
limit, one JSON line per turn (with checksums of the outputs, which must
agree between the checkouts), then a summary line of the times.

``--ablate`` builds this checkout's hit kernel (``csrc/raster_hit.cu``) as
it stands and two cut-down copies, and times each on the raster_hit
mode's 400x400 frame (k 300) and on 25 of its tiles as training tiles
(lists -1-padded to 12,288 slots, k 300):

* full — the kernel as committed (checked equal to the plain version);
* no_rank — without the final ranking of each pixel's buffered hits;
* staging_only — without the pair tests either: the lists are staged and
  the rows padded, nothing is tested.

The cut-down copies write wrong rows; only their times mean anything.
Their differences split a call into the staging of the lists, the pair
tests with their appends, and the ranking.  A cut is a replacement of a
source line, and the mode fails if the kernel no longer has that line.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS = {"nearest": {"main": 20, "eval": 10},
        "raster_hit": {"count": 10, "frame": 20},
        "stencil": {"lap_backward": 50},
        "paper_step": {"no_remat": 3}}
ABLATE_OUT = ROOT / "build" / "ablate"
RANK = ("    write_ranked(bz, bid, fill, k, row_z, row_id);\n"
        "    for (int t = fill + lane")
PAIRS = "const bool hit = i < n && covers(s, i, q.x, q.y, q.lo, q.hi, z);"
CUTS = {
    "full": [],
    "no_rank": [(RANK, "    for (int t = fill + lane")],
    "staging_only": [(RANK, "    for (int t = fill + lane"),
                     (PAIRS, "const bool hit = false;")],
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nearest_shapes(smoke):
    import torch

    from deftet_tpu_torch.ops import nearest

    gen = torch.Generator(device="cpu").manual_seed(0)
    q = (torch.rand((4, 200_000, 3), generator=gen) - 0.5).cuda()
    r = (torch.rand((4, 5_000, 3), generator=gen) * 0.8 - 0.4).cuda()
    shapes = {
        "main": (q, r, torch.full((4,), 5_000, dtype=torch.int32,
                                  device="cuda"),
                 torch.full((4,), 200_000, dtype=torch.int32,
                            device="cuda")),
        "eval": smoke.sphere_clouds(),
    }

    def checksums(args):
        d, i = nearest.nearest_neighbor(*args)
        return {"index_sum": int(i.long().sum()),
                "distance_sum": float(d.double().sum())}
    return nearest.nearest_neighbor, shapes, checksums


def raster_faces(n_faces=777_600, radius=0.04, seed=0, device="cuda"):
    """(face z (F, 3), face xy (F, 3, 2)) from a seed."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    centre = torch.rand((n_faces, 1, 2), generator=gen) * 2.0 - 1.0
    corner = (torch.rand((n_faces, 3, 2), generator=gen) * 2.0 - 1.0)
    face_img = centre + radius * corner
    face_z = -1.0 - 4.0 * torch.rand((n_faces, 3), generator=gen)
    return face_z.to(device), face_img.to(device)


def frame_lists(face_img, size=400, tile=16):
    """Pixels in tile-major order and each tile's ascending list of the
    faces whose bounding box meets the tile's (CSR)."""
    import torch

    dev = face_img.device
    n_side = size // tile
    centre = (torch.arange(size, device=dev).float() + 0.5) / size * 2 - 1
    ty, tx, py, px = torch.meshgrid(
        *(torch.arange(n, device=dev) for n in (n_side, n_side, tile, tile)),
        indexing="ij")
    pix = torch.stack([centre[(tx * tile + px).reshape(-1)],
                       centre[(ty * tile + py).reshape(-1)]], dim=1)

    def to_tile(v):
        return ((v + 1.0) / 2.0 * n_side).floor().clamp(0, n_side - 1).long()

    lo, hi = to_tile(face_img.amin(dim=1)), to_tile(face_img.amax(dim=1))
    nx, ny = hi[:, 0] - lo[:, 0] + 1, hi[:, 1] - lo[:, 1] + 1
    n_faces = face_img.shape[0]
    face = torch.repeat_interleave(torch.arange(n_faces, device=dev),
                                   nx * ny)
    first = torch.cumsum(nx * ny, 0) - nx * ny
    rank = torch.arange(face.shape[0], device=dev) - first[face]
    tile_id = ((lo[face, 1] + rank // nx[face]) * n_side
               + lo[face, 0] + rank % nx[face])
    order = torch.argsort(tile_id * n_faces + face)
    counts = torch.bincount(tile_id, minlength=n_side * n_side)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0)])
    return pix.contiguous(), face[order].to(torch.int32), offsets


def raster_shapes(smoke):
    import torch

    from deftet_tpu_torch.render import raster

    face_z, face_img = raster_faces()
    gen = torch.Generator(device="cpu").manual_seed(1)
    pix = (torch.rand((6_400, 2), generator=gen) * 2.0 - 1.0).cuda()
    n_faces = face_z.shape[0]

    def ranges(p):
        return torch.tensor([[-1000.0, 0.0]], device="cuda").expand(
            p, 2).contiguous()

    cand = torch.arange(n_faces, dtype=torch.int32, device="cuda")
    offsets = torch.tensor([0, n_faces], device="cuda")
    fpix, fcand, foffsets = frame_lists(face_img)
    shapes = {
        "count": (pix, ranges(6_400), face_z, face_img, cand, offsets,
                  6_400, 0),
        "frame": (fpix, ranges(fpix.shape[0]), face_z, face_img, fcand,
                  foffsets, 256, 300),
    }

    def checksums(args):
        ids, z, counts = raster.raster_hit(*args)
        return {"index_sum": int(ids.long().sum()),
                "z_sum": float(z.double().sum()),
                "count_sum": int(counts.long().sum()),
                "entries": int(args[4].numel())}
    return raster.raster_hit, shapes, checksums


def stencil_shapes(smoke):
    import torch

    from deftet_tpu_torch.ops import stencil
    from deftet_tpu_torch.train.statics import build_grid_statics

    st = build_grid_statics(50)
    inv_deg = (1.0 / torch.clamp(st.vert_degree, min=1).float()).cuda()
    gen = torch.Generator(device="cpu").manual_seed(2)
    g = torch.randn((4, 51**3, 3), generator=gen).cuda()
    shapes = {"lap_backward": (g, 51, st.lattice.offsets, None, inv_deg)}

    def checksums(args):
        out = stencil.stencil_sum(*args)
        return {"sum": float(out.double().sum()),
                "abs_sum": float(out.double().abs().sum())}
    return stencil.stencil_sum, shapes, checksums


def paper_turn(smoke) -> dict:
    """The paper recipe without remat: a warm-up and REPS steps, the
    median step and the peak from before the warm-up."""
    import torch

    from deftet_tpu_torch.train import Engine

    cfg = smoke.paper_config(False)
    engine = Engine(cfg, device="cuda")
    batch = engine._prep_batch(smoke.bench_batch(cfg, occ_res=64))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for step in range(1 + REPS["paper_step"]["no_remat"]):
        t = time.perf_counter()
        engine.train_step(batch)
        torch.cuda.synchronize()
        if step:
            step_s.append(time.perf_counter() - t)
    return {"ms": 1e3 * statistics.median(step_s),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def turn(checkout: Path, mode: str) -> dict:
    """Time the kernel of ``mode`` in the package in ``checkout`` (this
    process only)."""
    sys.path.insert(0, str(checkout))
    import deftet_tpu_torch

    if Path(deftet_tpu_torch.__file__).resolve().parents[1] != checkout:
        raise RuntimeError(f"deftet_tpu_torch did not come from {checkout}")
    smoke = _chip_smoke()
    if mode == "paper_step":
        return {"checkout": str(checkout), "mode": mode,
                "no_remat": paper_turn(smoke)}
    fn, shapes, checksums = {"nearest": nearest_shapes,
                             "raster_hit": raster_shapes,
                             "stencil": stencil_shapes}[mode](smoke)
    out = {"checkout": str(checkout), "mode": mode}
    for name, args in shapes.items():
        out[name] = {"ms": smoke.cuda_ms(lambda: fn(*args),
                                         REPS[mode][name]),
                     **checksums(args)}
    return out


def ablate_build(cuda):
    """{cut: ctypes library}, one nvcc each, started together."""
    src = (cuda.CSRC_DIR / cuda.KERNELS["raster_hit"][0]).read_text()
    ABLATE_OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in CUTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel no longer has {old!r}")
            text = text.replace(old, new)
        (ABLATE_OUT / f"{name}.cu").write_text(text)
        cmd = [cuda._nvcc(), *cuda._ARCH, *cuda._COMMON,
               *cuda.KERNELS["raster_hit"][1], "-o",
               str(ABLATE_OUT / f"{name}.so"), str(ABLATE_OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(ABLATE_OUT / f"{name}.so"))
        fn = lib.deftet_raster_hit
        fn.argtypes = cuda._SIGNATURES["raster_hit"]["deftet_raster_hit"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def ablate_launch(lib, args):
    """One call of a built copy, as ``render.raster._raster_hit_cuda``
    makes it."""
    import torch

    pix, ranges, face_z, face_img, cand, offsets, tile, k = args
    p, t, f = pix.shape[0], offsets.shape[0] - 1, face_z.shape[0]
    ids = torch.empty((p, k), dtype=torch.int32, device="cuda")
    zs = torch.empty((p, k), dtype=torch.float32, device="cuda")
    counts = torch.empty((p,), dtype=torch.int32, device="cuda")
    table = torch.empty((f, 12), dtype=torch.float32, device="cuda")
    err = lib.deftet_raster_hit(
        pix.data_ptr(), ranges.data_ptr(), face_z.data_ptr(),
        face_img.data_ptr(), cand.data_ptr(), offsets.data_ptr(),
        table.data_ptr(), ids.data_ptr(), zs.data_ptr(), counts.data_ptr(),
        p, t, tile, f, cand.numel(), k,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"raster_hit copy failed: error {err}")
    return ids, zs, counts


def ablate() -> dict:
    """Times in ms of each cut on the frame and the training tiles."""
    import torch

    sys.path.insert(0, str(ROOT))
    from deftet_tpu_torch.ops import _cuda
    from deftet_tpu_torch.render import raster

    smoke = _chip_smoke()
    libs = ablate_build(_cuda)
    face_z, face_img = raster_faces()
    pix, cand, offsets = frame_lists(face_img)
    ranges = torch.tensor([[-1000.0, 0.0]], device="cuda").expand(
        pix.shape[0], 2).contiguous()
    gen = torch.Generator().manual_seed(5)
    pick = torch.randperm(625, generator=gen)[:25].tolist()
    lists = torch.full((25, 12288), -1, dtype=torch.int32, device="cuda")
    for row, t in enumerate(pick):
        entries = cand[offsets[t]:offsets[t + 1]]
        lists[row, :entries.numel()] = entries
    train_pix = pix.reshape(625, 256, 2)[pick].reshape(-1, 2).contiguous()
    shapes = {
        "frame": (pix, ranges, face_z, face_img, cand, offsets, 256, 300),
        "train": (train_pix, ranges[:6400].contiguous(), face_z, face_img,
                  lists.reshape(-1),
                  torch.arange(26, device="cuda") * 12288, 256, 300),
    }
    times = {}
    for shape, args in shapes.items():
        ref = raster.raster_hit_plain(*args)
        got = ablate_launch(libs["full"], args)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{shape}: the kernel differs from plain")
        times[shape] = {
            name: smoke.cuda_ms(lambda lib=lib: ablate_launch(lib, args), 20)
            for name, lib in libs.items()}
    return times


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--ablate":
        import torch

        if not torch.cuda.is_available():
            print("chip_compare: no CUDA device", file=sys.stderr)
            return 1
        print(_card(), flush=True)
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "mode": "ablate", "ms": ablate()}), flush=True)
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--turn":
        print(json.dumps(turn(Path(sys.argv[2]).resolve(), sys.argv[3])),
              flush=True)
        return 0
    if len(sys.argv) not in (2, 3) or (len(sys.argv) == 3
                                       and sys.argv[2] not in REPS):
        print(__doc__, file=sys.stderr)
        return 2
    mode = sys.argv[2] if len(sys.argv) == 3 else "nearest"
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve()
    if not (other / "deftet_tpu_torch").is_dir():
        raise RuntimeError(f"{other} holds no deftet_tpu_torch package")
    print(_card(), flush=True)
    runs = []
    for checkout in (other, ROOT, ROOT, other):
        res = subprocess.run(
            [sys.executable, str(ROOT / "chip_compare.py"), "--turn",
             str(checkout), mode],
            capture_output=True, text=True, timeout=900, cwd=checkout)
        if res.returncode != 0:
            raise RuntimeError(f"turn in {checkout} failed:\n"
                               f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for shape in REPS[mode]:
        sums = {tuple(sorted((k, v) for k, v in r[shape].items()
                             if k not in ("ms", "peak_bytes")))
                for r in runs}
        if len(sums) != 1:
            raise AssertionError(f"{shape}: the checkouts disagree: {sums}")
        summary[shape] = {
            f"{side}_{key}": [runs[a][shape][key], runs[b][shape][key]]
            for side, a, b in (("other", 0, 3), ("this", 1, 2))
            for key in ("ms", "peak_bytes") if key in runs[0][shape]}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "mode": mode,
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
