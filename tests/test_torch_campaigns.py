"""The port's campaign drivers (``scripts/torch_*_campaign.py``): they
import nothing of JAX or of the JAX package, the hard-geometry driver
writes the JAX script's augmented meshes byte for byte, and each driver
runs end to end on the CPU at a tiny size and writes finite metrics,
which ``scripts/torch_campaign_report.py`` summarizes."""

import ast
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
PORTED = sorted(SCRIPTS.glob("torch_*.py"))

# the tiny network of tests/test_torch_engine.py's CLI test, passed through
# each driver's --extra
TINY = ("--n_point 128 --num_sample_points 256 --occ_sample 128 "
        "--per_face_samples 4 --encoder_blocks 8,1,8;16,1,4 --gcn_hidden 16,8 "
        "--pos_mlp_hidden 8 --occ_mlp_hidden 16,8")
METRICS = ("occ_iou", "val_iou_max", "f_score", "f_score_extend", "chamfer",
           "chamfer_l1", "hausdorff", "hausdorff_max")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(script: str, *args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # one thread a process: the drivers start the CLI and its dataset
    # workers, which beside other test workers would oversubscribe the CPU
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, str(SCRIPTS / script), *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("path", PORTED, ids=lambda p: p.name)
def test_scripts_import_no_jax(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "optax", "deftet_tpu"}, roots


def test_augmented_meshes_match_the_jax_script(tmp_path):
    jax_script = _load(SCRIPTS / "hard_geom_campaign.py", "jax_hard_geom")
    port_script = _load(SCRIPTS / "torch_hard_geom_campaign.py",
                        "torch_hard_geom")
    assert jax_script.make_augmented_meshes(str(tmp_path / "jax"), 1, 0) == \
        port_script.make_augmented_meshes(str(tmp_path / "port"), 1, 0) == 3
    jax_files = sorted(p.relative_to(tmp_path / "jax")
                       for p in (tmp_path / "jax").rglob("*.obj"))
    assert [str(p) for p in jax_files] == [
        f"{m}/{m}_00.obj" for m in ("gear", "trefoil", "twistbox")]
    for rel in jax_files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel


def _finite_report(outdir: Path) -> dict:
    (exp,) = (outdir / "exp").iterdir()
    metrics = json.loads((exp / "result_update.json").read_text())["metrics"]
    assert all(math.isfinite(metrics[k]) for k in METRICS), metrics
    assert (outdir / "eval_stdout.txt").exists()
    return exp


def test_drivers_write_inside_the_checkout():
    """By default each driver writes under the checkout's git-ignored
    build/campaigns/<name>, DISN's dataset cache under its --outdir, so
    two checkouts (or a JAX and a port run) never share a dataset or an
    experiment directory."""
    build = ROOT / "build" / "campaigns"
    disn = _load(SCRIPTS / "torch_disn_campaign.py", "torch_disn_campaign")
    args = disn.parse_args([])
    assert Path(args.outdir) == build / "disn"
    assert Path(args.data_root) == build / "disn" / "data"
    assert Path(disn.parse_args(["--outdir", "x"]).data_root) == \
        Path("x") / "data"
    hard = _load(SCRIPTS / "torch_hard_geom_campaign.py",
                 "torch_hard_geom_campaign")
    assert Path(hard.parse_args([]).outdir) == build / "hard_geom"
    render = _load(SCRIPTS / "torch_render_campaign.py",
                   "torch_render_campaign")
    assert Path(render.build_parser().parse_args([]).outdir) == \
        build / "render"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("driver", ["disn", "hard_geom"])
def test_training_driver_on_cpu(driver, tmp_path):
    """One epoch of the tiny network through the driver's train and eval
    calls, then the report of its experiment."""
    out = tmp_path / driver
    common = ["--device", "cpu", "--outdir", str(out), "--res", "4",
              "--batch_size", "2", "--epochs", "1", "--eval_points", "256"]
    if driver == "disn":
        args = [*common, "--n_shapes", "4",
                "--disn_width", "0.05", "--disn_encoding_dim", "64",
                "--extra", TINY + " --disn_image_size 32"
                " --disn_local_feature_size 16"]
    else:
        args = [*common, "--n_aug", "1",
                "--extra", TINY + " --watertight_res 32"]
    proc = _run(f"torch_{driver}_campaign.py", *args, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    exp = _finite_report(out)
    config = json.loads((exp / "config.json").read_text())
    # the dataset cache lies under --outdir for both drivers
    assert Path(config["dataset_root"]) == out / "data"
    assert config["use_disn"] == (driver == "disn")
    assert bool(config["mesh_dir"]) == (driver == "hard_geom")

    report = _load(SCRIPTS / "torch_campaign_report.py",
                   "torch_campaign_report").summarize(str(exp))
    assert report["epochs"] == report["validations"] == 1
    assert report["steps"] >= 1
    assert report["best_epoch"] == 1
    assert report["fit_s"] >= report["train_s"] > 0
    assert 0 < report["inference_share_of_validation"] < 1
    assert report["peak_bytes"] is None  # no card
    assert report["eval"]["chamfer"] == json.loads(
        (exp / "result_update.json").read_text())["metrics"]["chamfer"]


def test_render_driver_on_cpu(tmp_path):
    """Both sublevels of 2 + 2 steps on a res-3 lattice, 4 views of 16^2:
    a record per stage and a finite final PSNR; then a resume from the
    first sublevel's state reproduces the second sublevel's PSNRs.  (The
    budget only caps the run: stages start until budget - reserve - 60 s,
    which a loaded CPU must not reach.)"""
    out = tmp_path / "render"
    args = ["--device", "cpu", "--outdir", str(out), "--tetres", "3",
            "--n_views", "4", "--image_size", "16", "--sublevels", "1",
            "--steps_mov", "2", "--steps_fix", "2", "--budget_s", "400",
            "--reserve_s", "10", "--min_stage_s", "5"]
    proc = _run("torch_render_campaign.py", *args, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    records = json.loads((out / "records.json").read_text())
    stages = {s["stage"]: s for s in records["stages"]}
    assert list(stages) == ["sub0-mov", "sub0-fix", "sub1-mov", "sub1-fix"]
    assert all(math.isfinite(s["psnr"]) and s["steps_done"] == 2
               for s in stages.values())
    assert math.isfinite(records["final_psnr"])
    assert records["final_tets"] == stages["sub1-fix"]["n_tets"] > \
        stages["sub0-fix"]["n_tets"]
    assert (out / "surface.obj").exists()

    proc = _run("torch_render_campaign.py", *args, "--resume",
                str(out / "state_sub0-fix.npz"), "--start_sublevel", "1",
                "--subdivide_first", cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    resumed = json.loads((out / "records.json").read_text())
    assert [s["stage"] for s in resumed["stages"]] == [
        *stages, "sub1-mov", "sub1-fix"]
    assert [s["psnr"] for s in resumed["stages"][4:]] == [
        stages["sub1-mov"]["psnr"], stages["sub1-fix"]["psnr"]]


def test_render_driver_fits_the_nerf_scene_in_the_grid(tmp_path):
    """The NeRF-protocol scene is fitted inside the grid's world box, coef
    times its centered half-extent: 0.5 for the Kuhn lattice, as for a
    quartet grid (the JAX script takes 1.0 for the lattice)."""
    out = tmp_path / "nerf"
    proc = _run("torch_render_campaign.py", "--device", "cpu", "--outdir",
                str(out), "--scene", "nerf", "--tetres", "3", "--n_views",
                "2", "--image_size", "16", "--sublevels", "0",
                "--steps_mov", "1", "--steps_fix", "1", "--budget_s", "400",
                "--reserve_s", "10", "--min_stage_s", "5", cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "scene half-extent 1.188 (grid half 0.500 x coef 2.5)" in \
        proc.stdout
    records = json.loads((out / "records.json").read_text())
    assert [s["stage"] for s in records["stages"]] == ["sub0-mov", "sub0-fix"]
    assert math.isfinite(records["final_psnr"])
