"""A copy of the benchmark's files with a tiny configuration and tiny
cells, for the CPU tests: the harness run end to end on the CPU, with
the port's plain kernel versions."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

TINY = {"res": 4, "batch_size": 2, "n_point": 128, "num_sample_points": 128,
        "occ_sample": 64, "per_face_samples": 4,
        "encoder_blocks": "8,1,8;16,1,4", "gcn_hidden": "16,8",
        "pos_mlp_hidden": "8,0.2,8", "occ_mlp_hidden": "16,0.2,8",
        "precision": "bf16"}

CELLS = {
    "tiny.train": {"config": "tiny", "traffic": "train", "chips": 1,
                   "why": "tiny training cell for the CPU tests",
                   "params": {"n_shapes": 6, "level": 1, "n_surface": 128,
                              "occ_res": 16, "proof_steps": 3,
                              "trace_steps": 2}},
    "tiny.eval": {"config": "tiny", "traffic": "eval", "chips": 1,
                  "why": "tiny evaluation cell for the CPU tests",
                  "params": {"n_shapes": 2, "held_out": True, "level": 1,
                             "n_surface": 128, "n_sdf": 256, "occ_res": 16,
                             "eval_points": 256, "occupied_share": 0.25,
                             "trace_steps": 1}},
}


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """``tmp/benchmark``: the harness's files with the tiny config and
    cells added, and ``tmp/BENCHMARK.json`` naming them."""
    root = tmp / "benchmark"
    for sub in ("configs", "workloads", "drivers", "metrics"):
        shutil.copytree(harness.ROOT / sub, root / sub)
    base = json.loads((harness.ROOT / "configs" /
                       "deftet_res50.json").read_text())
    (root / "configs" / "tiny.json").write_text(json.dumps(
        {**base, **TINY, "reduced": [], "source": "the CPU tests"}))
    for name, cell in CELLS.items():
        cell = {**cell, "limits": (limits or {}).get(name, {})}
        (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    spec = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = "train" if any(w.endswith("train")
                                  for w in m["workloads"]) else "eval"
            m["workloads"] = m["workloads"] + [f"tiny.{kind}"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def context(root: Path, name: str, seed: int = 3, seconds: float = 0.5,
            trace: bool = False) -> harness.Context:
    cell, config, _ = harness.load_cell(name, root)
    return harness.Context(name=name, cell=cell, config=config, seed=seed,
                           seconds=seconds, trace=trace, device="cpu",
                           root=root, t_start=0.0)


def spec_of(root: Path) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())
