"""The port does all that the JAX package does: every public name of
every ``deftet_tpu`` module, and every name of each subpackage's
``__all__``, has a counterpart in ``deftet_tpu_torch`` or an entry with
its reason in a table below.

Both packages are read with ``ast``; neither is imported.  A counterpart
is a public top-level ``def``, ``class`` or constant of the port's module
of the same path (or a name that module imports), unless ``MODULES``
maps the module or ``RENAMED`` the name.  ``NOT_PORTED`` holds what the
port does not take, each entry recorded in ROADMAP.md's "Not to port"
list, which the test reads.  A new public JAX name with neither a
counterpart nor an entry fails it, and so does an entry that no longer
names a JAX name.
"""

import ast
import re
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "deftet_tpu"
PORT = ROOT / "deftet_tpu_torch"

# JAX module -> the port's module, where the path differs: the three
# Pallas kernels' wrappers live beside their CUDA launchers
MODULES = {
    "ops/stencil_pallas.py": "ops/stencil.py",
    "ops/nearest_pallas.py": "ops/nearest.py",
    "ops/tri_distance_pallas.py": "ops/tri_distance.py",
}

# each Pallas kernel -> the hand-written CUDA source that replaces it
KERNELS = {
    "ops/stencil_pallas.py": "csrc/stencil.cu",
    "ops/nearest_pallas.py": "csrc/nearest.cu",
    "ops/tri_distance_pallas.py": "csrc/tri_argmin.cu",
}

# (JAX module, name) -> port name in the mapped module: a counterpart
# under another name
RENAMED = {
    ("ops/nearest_pallas.py", "nn_pallas_single"): "nearest_neighbor",
    ("ops/nearest_pallas.py", "nearest_neighbor_pallas"): "nearest_neighbor",
    ("ops/tri_distance_pallas.py", "tri_argmin_pallas_single"): "tri_argmin",
    ("ops/tri_distance_pallas.py", "tri_argmin_pallas"): "tri_argmin",
    ("nn/disn_port.py", "vgg16_flax_params"): "vgg16_state_dict",
    ("train/step.py", "make_train_step"): "train_step",
    ("train/step.py", "make_eval_step"): "eval_step",
}

_TRAIN_STATE = ("the flax/optax train state: the port's parameters live in "
                "the modules, Adam's moments in ClippedAdam, both inside "
                "Engine")
_SHARDING = ("jax.sharding placement on a device mesh: the port's data "
             "parallelism is torch.distributed ranks, each holding its "
             "rows (parallel.World, shard_rows, replicate)")
_FRAME = ("the TPU frame path's host/device overlap (dispatch every view, "
          "then resolve): the port renders one view at a time over exact "
          "per-tile lists (render_frame)")
_EVAL_BIN = ("the TPU eval frame's face-count path switch and its bin "
             "calibration: every port frame takes the exact per-tile lists")

# a JAX module, or (module, name), the port does not take -> reason; each
# key is named in ROADMAP.md's "Not to port" list
NOT_PORTED = {
    "ops/tiling.py": "the XLA scans' memory tiling: the port chunks its "
                     "loops where it runs them",
    "utils/jaxsetup.py": "JAX platform set-up",
    ("ops/stencil_pallas.py", "stencil_fits_vmem"): "the Pallas stencil's "
                                                    "TPU VMEM gate",
    ("train/step.py", "TrainState"): _TRAIN_STATE,
    ("train/step.py", "create_train_state"): _TRAIN_STATE,
    ("parallel/mesh.py", "DATA_AXIS"): _SHARDING,
    ("parallel/mesh.py", "make_mesh"): _SHARDING,
    ("parallel/mesh.py", "batch_sharding"): _SHARDING,
    ("parallel/mesh.py", "replicated_sharding"): _SHARDING,
    ("parallel/mesh.py", "shard_batch"): _SHARDING,
    ("render/frame.py", "PendingFrame"): _FRAME,
    ("render/frame.py", "dispatch_frame_binned"): _FRAME,
    ("render/frame.py", "render_frame_binned"): _FRAME,
    ("render/optimize.py", "dispatch_full_image"): _FRAME,
    ("render/optimize.py", "calibrate_eval_bin_cand"): _EVAL_BIN,
}

# a JAX script of scripts/ the port does not take -> reason; each is named
# in ROADMAP.md's "Not to port" list.  Every other one is a campaign
# driver, whose port is scripts/torch_<name>.
SCRIPTS_NOT_PORTED = {
    "tpu_smoke.py": "its port is chip_smoke.py",
    "hlo_stats.py": "XLA graph sizes",
    "preingest_r4.py": "TPU contention",
    "roofline.py": "XLA cost analysis: the port has chip_profile.py and "
                   "chip_smoke.py's bounds",
    "step_breakdown.py": "XLA cost analysis: the port has chip_profile.py "
                         "and chip_smoke.py's bounds",
}
JAX_SCRIPTS = sorted(p.name for p in (ROOT / "scripts").glob("*.py")
                     if not p.name.startswith("torch_"))

SCRIPTS = {"deftet-torch-train": "train_main", "deftet-torch-eval":
           "eval_main", "deftet-torch-render": "render_main",
           "deftet-torch-preprocess": "preprocess_main"}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def defined(path: Path) -> set:
    """Public top-level defs, classes and assigned names."""
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def reachable(path: Path) -> set:
    """``defined`` plus the names the module imports."""
    out = defined(path)
    for node in _tree(path).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return out


def all_of(path: Path) -> list:
    for node in _tree(path).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))
SUBPACKAGES = sorted(str(p.parent.relative_to(JAX))
                     for p in JAX.glob("*/__init__.py"))


def roadmap_not_to_port() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    m = re.search(r"\*\*Not to port\.\*\*(.*?)(?=\n\*\*|\n#)", text, re.S)
    assert m, "ROADMAP.md has no 'Not to port' list"
    return m.group(1)


def counterpart(module: str, name: str):
    """The port's (module, name) for a JAX name, or None."""
    port_module = MODULES.get(module, module)
    port_name = RENAMED.get((module, name), name)
    path = PORT / port_module
    if path.exists() and port_name in reachable(path):
        return port_module, port_name
    return None


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    if module in NOT_PORTED:
        return
    missing = sorted(n for n in defined(JAX / module)
                     if (module, n) not in NOT_PORTED
                     and counterpart(module, n) is None)
    assert not missing, (
        f"deftet_tpu/{module}: no counterpart in deftet_tpu_torch/"
        f"{MODULES.get(module, module)} and no NOT_PORTED entry: {missing}")


@pytest.mark.parametrize("package", SUBPACKAGES)
def test_every_subpackage_all_is_covered(package):
    """Each name of a JAX subpackage's ``__all__`` is in the port's
    ``__all__`` (renamed where RENAMED says so), or not ported."""
    port_init = PORT / package / "__init__.py"
    assert port_init.exists(), f"deftet_tpu_torch/{package} is missing"
    port_all = set(all_of(port_init))
    modules = [m for m in JAX_MODULES if m.startswith(package + "/")]
    missing = []
    for name in all_of(JAX / package / "__init__.py"):
        homes = [m for m in modules if name in defined(JAX / m)]
        if any(m in NOT_PORTED or (m, name) in NOT_PORTED for m in homes):
            continue
        wanted = {RENAMED.get((m, name), name) for m in homes} or {name}
        if not wanted & port_all:
            missing.append(name)
    assert not missing, f"{package}: __all__ lacks {missing}"


def test_tables_name_real_jax_names():
    """No stale entry: each names a public JAX name (or module) and each
    renamed counterpart exists; the not-ported ones are in ROADMAP.md."""
    for module, name in RENAMED:
        assert name in defined(JAX / module), (module, name)
        assert counterpart(module, name) is not None, (module, name)
    roadmap = roadmap_not_to_port()
    for key in NOT_PORTED:
        module, name = key if isinstance(key, tuple) else (key, None)
        assert (JAX / module).exists(), module
        assert f"`{module}`" in roadmap, module
        if name is not None:
            assert name in defined(JAX / module), key
            assert f"`{name}`" in roadmap, key
            assert counterpart(module, name) is None, (
                f"{key} is ported now: remove its NOT_PORTED entry")


def test_pallas_kernels_have_cuda_sources():
    """Each Pallas kernel's module maps to a port module whose launcher
    builds a CUDA source of ``csrc/``."""
    cuda = (PORT / "ops" / "_cuda.py").read_text()
    for module, source in KERNELS.items():
        assert "pallas_call" in (JAX / module).read_text(), module
        assert (PORT / source).exists(), source
        assert f'"{Path(source).name}"' in cuda, source
        assert "_cuda" in (PORT / MODULES[module]).read_text(), module
    pallas = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                    if "pallas_call(" in p.read_text())
    assert pallas == sorted(KERNELS)


def test_console_scripts_name_port_functions():
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port_cli = defined(PORT / "cli.py")
    for script, fn in SCRIPTS.items():
        assert scripts[script] == f"deftet_tpu_torch.cli:{fn}", script
        assert fn in port_cli, fn
        assert scripts[script.replace("-torch", "")] == \
            f"deftet_tpu.cli:{fn}", script


@pytest.mark.parametrize("script", JAX_SCRIPTS)
def test_every_script_is_ported_or_named(script):
    """Each campaign driver of scripts/ has its port beside it; each other
    JAX script is in SCRIPTS_NOT_PORTED and ROADMAP.md's "Not to port"."""
    ported = ROOT / "scripts" / f"torch_{script}"
    if script.endswith("_campaign.py"):
        assert ported.exists(), f"scripts/{script} has no port"
        assert script not in SCRIPTS_NOT_PORTED, script
    else:
        assert script in SCRIPTS_NOT_PORTED, (
            f"scripts/{script}: no port and no SCRIPTS_NOT_PORTED entry")
        assert f"`scripts/{script}`" in roadmap_not_to_port(), script
        assert not ported.exists(), f"{script} is ported now"
