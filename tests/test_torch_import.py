"""Importing the port pulls in neither JAX nor the JAX package, builds no
kernel and does not initialise CUDA.  Run in a fresh interpreter: the
test session itself has JAX loaded by conftest."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import deftet_tpu_torch
names = ["deftet_tpu_torch"]
for info in pkgutil.walk_packages(deftet_tpu_torch.__path__,
                                  "deftet_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
import torch
from deftet_tpu_torch.ops import _cuda
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib", "flax",
                                                 "optax"))),
    "deftet_tpu": sorted(m for m in sys.modules
                         if m == "deftet_tpu" or m.startswith("deftet_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
    "libraries_loaded": len(_cuda._libs),
}))
"""


def test_port_imports_without_jax_or_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {"deftet_tpu_torch." + p for p in (
        "config", "convert", "data", "evals", "losses", "nn", "ops",
        "tetgrid", "train", "ops.stencil", "ops.nearest",
        "ops.tri_distance", "train.engine", "train.step", "nn.disn",
        "nn.disn_port", "data.image_render", "data.watertight")}
    assert expected <= set(report["modules"])
    assert report["jax"] == []
    assert report["deftet_tpu"] == []
    assert report["cuda_initialized"] is False
    assert report["libraries_loaded"] == 0


NEW_MODULES = ("cli", "remat", "utils", "utils.objio", "utils.timing",
               "data.pipeline", "evals.harness", "evals.metrics",
               "ops.check_sign", "ops.point_tet", "train.checkpoint")
RENDER_MODULES = ("render", "render.camera", "render.raster",
                  "render.composite", "render.frame", "render.scene",
                  "render.optimize", "tetgrid.subdivide")

PROBE_NEW = r"""
import importlib, json, sys
names = sys.argv[1:]
for name in names:
    importlib.import_module("deftet_tpu_torch." + name)
import torch
from deftet_tpu_torch.ops import _cuda
print(json.dumps({
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib", "flax",
                                                 "optax", "orbax"))),
    "deftet_tpu": sorted(m for m in sys.modules
                         if m == "deftet_tpu" or m.startswith("deftet_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
    "libraries_loaded": len(_cuda._libs),
    "process_group": torch.distributed.is_initialized(),
}))
"""


def _probe(modules):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE_NEW, *modules],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"jax": [], "deftet_tpu": [], "cuda_initialized": False,
                      "libraries_loaded": 0, "process_group": False}


def test_train_eval_and_cli_modules_import_without_jax():
    _probe(NEW_MODULES)


def test_render_modules_import_without_jax_or_a_build():
    _probe(RENDER_MODULES)


PARALLEL_MODULES = ("parallel", "parallel.mesh", "parallel.spawn", "dryrun",
                    "ops.sampling", "nn.pointnet", "losses.frustum")


def test_parallel_and_dryrun_import_without_jax_or_a_process_group():
    _probe(PARALLEL_MODULES)
