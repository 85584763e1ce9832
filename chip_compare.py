"""Time the K2 nearest-neighbour kernel of two checkouts of this
repository on one NVIDIA GPU, in turns.

    python3 chip_compare.py OTHER_CHECKOUT

Each turn is a fresh process that imports ``deftet_tpu_torch`` from one
checkout (building its kernel there) and times ``nearest_neighbor`` with
CUDA events at two shapes, from seeded generators:

* main — the res-50 / batch-4 train step's chamfer call: 4 x 200,000
  queries against 5,000 references, uniform in a box;
* eval — the eval metrics' call: 100,000 against 100,000 points on the
  unit sphere (``chip_smoke.sphere_clouds``).

The turns run other, this, this, other.  Prints the card's name and power
limit, one JSON line per turn (with checksums of the outputs, which must
agree between the checkouts), then a summary line of the mean times.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS = {"main": 20, "eval": 10}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(checkout: Path) -> dict:
    """Time K2 of the package in ``checkout`` (this process only)."""
    import torch

    sys.path.insert(0, str(checkout))
    import deftet_tpu_torch
    from deftet_tpu_torch.ops import nearest

    if Path(deftet_tpu_torch.__file__).resolve().parents[1] != checkout:
        raise RuntimeError(f"deftet_tpu_torch did not come from {checkout}")
    smoke = _chip_smoke()
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
    out = {"checkout": str(checkout)}
    for name, args in shapes.items():
        d, i = nearest.nearest_neighbor(*args)
        out[name] = {
            "ms": smoke.cuda_ms(lambda: nearest.nearest_neighbor(*args),
                                REPS[name]),
            "index_sum": int(i.long().sum()),
            "distance_sum": float(d.double().sum()),
        }
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        print(json.dumps(turn(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve()
    if not (other / "deftet_tpu_torch").is_dir():
        raise RuntimeError(f"{other} holds no deftet_tpu_torch package")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    runs = []
    for checkout in (other, ROOT, ROOT, other):
        res = subprocess.run(
            [sys.executable, str(ROOT / "chip_compare.py"), "--turn",
             str(checkout)],
            capture_output=True, text=True, timeout=900, cwd=checkout)
        if res.returncode != 0:
            raise RuntimeError(f"turn in {checkout} failed:\n"
                               f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for shape in REPS:
        sums = {(r[shape]["index_sum"], r[shape]["distance_sum"])
                for r in runs}
        if len(sums) != 1:
            raise AssertionError(f"{shape}: the checkouts disagree: {sums}")
        summary[shape] = {
            "other_ms": [runs[0][shape]["ms"], runs[3][shape]["ms"]],
            "this_ms": [runs[1][shape]["ms"], runs[2][shape]["ms"]],
        }
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
