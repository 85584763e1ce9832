"""The benchmark's core: it finds a cell's files by name, runs the cell's
driver, reads the metrics that ``BENCHMARK.json`` gives the cell through
their readers, and builds the result line.

Everything that belongs to one configuration, one cell or one metric is
a file of its own, found by its name:

* ``configs/<config>.json``: the ``TrainConfig`` fields as run, with
  ``source``, ``reduced`` and ``assumed``;
* ``workloads/<cell>.json``: the configuration, the traffic kind, its
  parameters, ``chips``, ``why`` and the limits of the comparison;
* ``drivers/<kind>.py``: one driver per traffic kind, ``run(ctx)``;
* ``metrics/<metric>.py``: one reader per metric, ``read(run, ctx)``,
  which returns None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
META_KEYS = ("source", "reduced", "assumed")
FORBIDDEN = ("jax", "jaxlib", "flax", "deftet_tpu")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def listing(root: Path = ROOT) -> dict:
    """The configurations, cells, drivers and metrics found by name."""
    def names(sub, suffix):
        return sorted(p.name[:-len(suffix)] for p in (root / sub).glob(
            "*" + suffix) if not p.name.startswith("_"))

    return {"configs": names("configs", ".json"),
            "workloads": names("workloads", ".json"),
            "drivers": names("drivers", ".py"),
            "metrics": names("metrics", ".py")}


def load_cell(name: str, root: Path = ROOT):
    """(workload, config fields, config meta) of cell ``name``."""
    cell = _json(root / "workloads" / f"{name}.json")
    raw = _json(root / "configs" / f"{cell['config']}.json")
    fields = {k: v for k, v in raw.items() if k not in META_KEYS}
    return cell, fields, {k: raw[k] for k in META_KEYS if k in raw}


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, root: Path = ROOT):
    return _module(root / "drivers" / f"{kind}.py")


def reader(metric: str, root: Path = ROOT):
    return _module(root / "metrics" / f"{metric}.py")


def cell_metrics(spec: dict, cell: str, traced: bool) -> list:
    """The entries of ``BENCHMARK.json`` that cell ``cell`` reports: its
    end-to-end metrics untraced, its per-layer metrics traced."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``deftet_tpu_torch`` is not one)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Context:
    """What a driver and a reader get: the cell, its configuration, the
    run's arguments and the directory of the benchmark's files."""

    name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    root: Path
    t_start: float

    @property
    def params(self) -> dict:
        return self.cell["params"]


def checks_of(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of each number compared, in order."""
    return {k: {"value": v, "limit": limits.get(k)} for k, v in
            numbers.items()}


def passed(checks: dict) -> bool:
    return all(c["limit"] is not None and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks.values())


def execute(ctx: Context, spec: dict) -> dict:
    """Run cell ``ctx.name`` once; the result line as a dict."""
    run = driver(ctx.cell["traffic"], ctx.root).run(ctx)
    metrics = {}
    for entry in cell_metrics(spec, ctx.name, ctx.trace):
        value = reader(entry["name"], ctx.root).read(run, ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    checks = checks_of(run["numbers"], ctx.cell.get("limits", {}))
    out = {"correct": bool(passed(checks) and run["failed"] == 0),
           "attempted": run["attempted"], "failed": run["failed"],
           "metrics": metrics, "device": run["device"]}
    if run.get("trace") is not None:
        tr = run["trace"]
        out["device"] = {**out["device"], "busy_s": tr.busy_s,
                         "window_s": tr.window_s}
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    if run.get("unsteady"):
        out["unsteady"] = run["unsteady"]  # readings not compared
    out["checks"] = checks
    return out
