"""Deadline-budgeted 2D-supervision quality campaign on the PyTorch port
(the port of scripts/render_campaign.py).

Runs the staged {mov, fix} x sublevel schedule of the reference's
optim_with_mask_subdiv_from_gridmov.py:486-521 on a procedural scene (or
a NeRF-synthetic one, ``--blender_dir``), on a Kuhn lattice of
``--tetres`` (default 40) or a quartet-format ``--tet_file``.  The
procedural NeRF-protocol scene is fitted inside the grid's world box.

Unlike ``cli render``, this driver is wall-clock-budgeted: every stage
gets a deadline pro-rated over the plan, the scene state is saved after
each stage, and ``records.json`` is rewritten after each stage, so a
timeout degrades to a shorter schedule instead of a lost run.  A run can
continue from a saved state (``--resume``, ``--start_sublevel``,
``--start_phase``, ``--subdivide_first``).  Everything runs on
``--device`` (default ``cuda``).  The run writes under ``--outdir``, by
default ``build/campaigns/render`` inside this checkout (git-ignored).

Usage:
  python scripts/torch_render_campaign.py \\
      --scene nerf --n_views 100 --image_size 400 --tetres 40 --budget_s 2400
  python scripts/torch_render_campaign.py --device cpu --tetres 3 \\
      --n_views 4 --image_size 16 --sublevels 0 --steps_mov 2 \\
      --steps_fix 2 --min_stage_s 5   # a CPU smoke
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--outdir",
                   default=os.path.join(REPO, "build", "campaigns", "render"),
                   help="where the run writes (default: build/campaigns/"
                   "render in this checkout)")
    p.add_argument("--budget_s", type=float, default=2000.0,
                   help="total wall budget incl. final eval/export")
    p.add_argument("--reserve_s", type=float, default=180.0,
                   help="wall reserved for the final eval + export")
    p.add_argument("--n_views", type=int, default=100)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--scene", choices=("orbit", "nerf"), default="orbit",
                   help="orbit: single-elevation orbit; nerf: the "
                        "NeRF-synthetic capture protocol (elevation-spread "
                        "poses, 200-pose test pool consumed per --testskip)")
    p.add_argument("--testskip", type=int, default=8)
    p.add_argument("--blender_dir", default=None,
                   help="load a real NeRF-synthetic scene from this dir "
                        "instead of the procedural GT")
    p.add_argument("--tet_file", default=None,
                   help="quartet-format .tet grid; default: a Kuhn lattice "
                        "of --tetres (40 when 0)")
    p.add_argument("--tetres", type=int, default=0,
                   help="use a Kuhn lattice of this res instead of "
                        "--tet_file")
    p.add_argument("--tetcoef", type=float, default=2.5)
    p.add_argument("--sublevels", type=int, default=2)
    p.add_argument("--steps_mov", type=int, default=2000)
    p.add_argument("--steps_fix", type=int, default=3000)
    p.add_argument("--pixel_sampling", type=float, default=0.2)
    p.add_argument("--tile_sampling", type=int, default=16,
                   help="train on whole WxW screen tiles (0 = iid "
                        "pixels, the reference's semantics)")
    p.add_argument("--peel_k", type=int, default=120)
    p.add_argument("--tet_budget", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="state_*.npz from a prior run; continues from "
                        "that topology+params")
    p.add_argument("--start_sublevel", type=int, default=0,
                   help="first sublevel to run (lr decay uses the true "
                        "sublevel index)")
    p.add_argument("--subdivide_first", action="store_true",
                   help="with --resume: carve+subdivide before the first "
                        "stage (resume was taken at the end of a sublevel)")
    p.add_argument("--start_phase", choices=("mov", "fix"), default="mov",
                   help="with --resume: skip the mov stage of the first "
                        "sublevel (resume was taken at the end of its mov)")
    p.add_argument("--stage_videos", action="store_true",
                   help="write a per-stage convergence mp4 (first train "
                        "view, one frame / 200 steps) to the outdir")
    p.add_argument("--eval_views", type=int, default=0,
                   help="cap the per-stage test-PSNR eval to this many "
                        "held-out views (0 = all); the FINAL eval always "
                        "uses the full test split")
    p.add_argument("--min_stage_s", type=float, default=240.0,
                   help="floor for a pro-rated stage deadline")
    p.add_argument("--scene_cache", default="auto",
                   help="npz path for the generated GT scene; 'auto' = "
                        "<outdir>/scene_cache.npz, 'none' disables; the "
                        "cache makes a resume skip the scene's renders")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain "
                        "versions)")
    return p


def main() -> int:
    p = build_parser()
    args = p.parse_args()

    from deftet_tpu_torch.cli import _device
    from deftet_tpu_torch.render.optimize import (
        RenderOptConfig,
        carve_and_subdivide,
        evaluate_psnr,
        export_turntable,
        load_blender,
        make_nerf_protocol_scene,
        make_synthetic_scene,
        optimize_stage,
        write_video,
    )
    from deftet_tpu_torch.render.scene import TetScene
    from deftet_tpu_torch.tetgrid import build_tet_grid, read_tet_file

    device = _device(p, args.device)
    t0 = time.monotonic()
    hard_deadline = t0 + args.budget_s
    stage_deadline_cap = hard_deadline - args.reserve_s
    cal_margin = 1.5  # doubled whenever a stage ends with bin overflow

    os.makedirs(args.outdir, exist_ok=True)

    def log(msg):
        print(f"[{time.monotonic() - t0:7.1f}s] {msg}", flush=True)

    log(f"scene: {args.scene} {args.n_views} views @ {args.image_size}^2")
    tet_file = args.tet_file if not args.tetres else None
    grid = (read_tet_file(tet_file) if tet_file
            else build_tet_grid(args.tetres or 40))
    cache = (os.path.join(args.outdir, "scene_cache.npz")
             if args.scene_cache == "auto" else args.scene_cache)
    if args.blender_dir:
        images, poses, hwf, i_split = load_blender(args.blender_dir)
    elif cache != "none" and os.path.exists(cache):
        z = np.load(cache)
        images, poses = z["images"], z["poses"]
        hwf = (int(z["hwf"][0]), int(z["hwf"][1]), float(z["hwf"][2]))
        i_split = [z["i_train"], z["i_val"], z["i_test"]]
        log(f"scene loaded from cache {cache}")
    else:
        if args.scene == "nerf":
            # Fit the GT scene inside the grid's world box, coef times its
            # centered extent: [-0.5, 0.5] for a quartet .tet grid and for
            # the Kuhn lattice alike.  (The JAX script takes [-1, 1] for
            # the lattice, which leaves the scene twice the grid's box.)
            grid_half = float(np.abs(grid.centered_vertices()).max())
            half_extent = 0.95 * args.tetcoef * grid_half
            log(f"scene half-extent {half_extent:.3f} "
                f"(grid half {grid_half:.3f} x coef {args.tetcoef})")
            images, poses, hwf, i_split = make_nerf_protocol_scene(
                n_train=args.n_views, testskip=args.testskip,
                height=args.image_size, width=args.image_size,
                seed=args.seed, coef=args.tetcoef,
                half_extent=half_extent, device=device,
            )
        else:
            images, poses, hwf, i_split = make_synthetic_scene(
                n_views=args.n_views, height=args.image_size,
                width=args.image_size, seed=args.seed, coef=args.tetcoef,
                device=device,
            )
        if cache != "none":
            np.savez_compressed(
                cache, images=images, poses=poses,
                hwf=np.asarray(hwf, np.float64), i_train=i_split[0],
                i_val=i_split[1], i_test=i_split[2],
            )
            log(f"scene cached to {cache}")
    i_train, i_val, i_test = i_split
    log(f"split: {len(i_train)} train / {len(i_val)} val / "
        f"{len(i_test)} test")

    cfg = RenderOptConfig(
        tet_file=tet_file, tet_res=args.tetres or 40, coef=args.tetcoef,
        sublevels=args.sublevels, steps_fix=args.steps_fix,
        steps_mov=args.steps_mov, pixel_sampling=args.pixel_sampling,
        tile_sampling=args.tile_sampling,
        k=args.peel_k, tet_budget=args.tet_budget, seed=args.seed,
    )
    if args.resume:
        scene, params = TetScene.load_state(args.resume, device=device)
        log(f"resumed {args.resume}: {scene.n_points} verts / "
            f"{scene.n_tets} tets")
    else:
        scene = TetScene.from_grid(grid, coef=cfg.coef, device=device)
        params = scene.init_params()
        log(f"grid: {scene.n_points} verts / {scene.n_tets} tets "
            f"({cfg.tet_file or f'Kuhn lattice res {cfg.tet_res}'})")

    records = []
    if args.resume:
        # the prior run's records, so that a resume does not drop the
        # stages it continues from
        prior = os.path.join(args.outdir, "records.json")
        if os.path.exists(prior):
            try:
                with open(prior) as f:
                    records = list(json.load(f).get("stages", []))
                log(f"seeded {len(records)} prior stage records")
            except (json.JSONDecodeError, OSError) as e:
                log(f"could not seed prior records: {e}")
    if args.resume and args.subdivide_first:
        params = carve_and_subdivide(
            scene, params, images, poses, hwf, i_val[:4], cfg, log=log
        )
        log(f"subdivided -> {scene.n_tets} tets")

    def flush_records(final=None):
        payload = {"stages": records, "config": vars(args)}
        if final is not None:
            payload.update(final)
        with open(os.path.join(args.outdir, "records.json"), "w") as f:
            json.dump(payload, f, indent=2)

    # The stage plan, built up front so that the wall budget is pro-rated
    # over it: a single global deadline would let a slow sub0 eat the
    # budget of the later sublevels.  Each stage gets a share of what
    # remains in proportion to its steps, with a floor.
    plan = []  # ("stage", sub, gridmov, steps) | ("subdiv", sub, None, 0)
    for sub in range(args.start_sublevel, cfg.sublevels + 1):
        for gridmov, steps in ((True, cfg.steps_mov), (False, cfg.steps_fix)):
            if steps <= 0:
                continue
            if (gridmov and sub == args.start_sublevel
                    and args.start_phase == "fix"):
                continue
            plan.append(("stage", sub, gridmov, steps))
        if sub < cfg.sublevels:
            plan.append(("subdiv", sub, None, 0))

    i_eval = i_test[: args.eval_views] if args.eval_views else i_test
    eval_est = [90.0]     # rolling estimate of one stage's eval+save cost
    subdiv_est = 180.0    # carve + escalation PSNR guards

    for pi, (kind, sub, gridmov, steps) in enumerate(plan):
        now = time.monotonic()
        if now > stage_deadline_cap - 60:
            log("out of stage budget; skipping remaining stages")
            break
        if kind == "subdiv":
            params = carve_and_subdivide(
                scene, params, images, poses, hwf, i_val[:4], cfg, log=log,
            )
            log(f"subdivided -> {scene.n_tets} tets")
            continue
        rest = plan[pi:]
        rem_steps = sum(s for k, _, _, s in rest if k == "stage")
        n_rem_stages = sum(1 for k, *_ in rest if k == "stage")
        n_rem_subdiv = sum(1 for k, *_ in rest if k == "subdiv")
        avail = (stage_deadline_cap - now
                 - eval_est[0] * n_rem_stages - subdiv_est * n_rem_subdiv)
        share = max(args.min_stage_s, avail * steps / max(rem_steps, 1))
        stage_deadline = min(now + share, stage_deadline_cap)
        name = f"sub{sub}-{'mov' if gridmov else 'fix'}"
        log(f"=== stage {name}: {steps} steps, "
            f"{stage_deadline - now:.0f}s share ===")
        params, history, stage_info = optimize_stage(
            scene, params, images, poses, hwf, i_train, cfg,
            gridmov=gridmov, steps=steps, log=log,
            lr_div=float(sub + 1), deadline=stage_deadline,
            video_path=(os.path.join(args.outdir, f"video_{name}.mp4")
                        if args.stage_videos else None),
            cal_margin=cal_margin,
        )
        if (stage_info["bin_overflow_final"]
                or stage_info["peel_overflow_final"]):
            cal_margin *= 2.0  # more headroom for later calibrations
        t_eval = time.monotonic()
        mse, psnr = evaluate_psnr(
            scene, params, images, poses, hwf, i_eval, cfg
        )
        tr_mse, tr_psnr = evaluate_psnr(
            scene, params, images, poses, hwf, i_train[:8], cfg
        )
        # steps done against planned: a deadline trades steps for stages,
        # and each stage's quality must be attributable to its steps
        records.append(
            {"stage": name, "mse": mse, "psnr": psnr,
             "train_psnr": tr_psnr, "n_tets": scene.n_tets,
             "steps_done": len(history), "steps_planned": steps,
             "wall_s": round(time.monotonic() - t0, 1),
             **stage_info}
        )
        log(f"[{name}] test psnr={psnr:.2f} train psnr={tr_psnr:.2f} "
            f"tets={scene.n_tets}")
        scene.save_state(
            os.path.join(args.outdir, f"state_{name}.npz"), params
        )
        flush_records()
        eval_est[0] = max(30.0, time.monotonic() - t_eval)

    mse, psnr = evaluate_psnr(scene, params, images, poses, hwf, i_test, cfg)
    log(f"FINAL test mse={mse:.5f} psnr={psnr:.3f} tets={scene.n_tets}")
    flush_records({"final_mse": mse, "final_psnr": psnr,
                   "final_tets": scene.n_tets,
                   "wall_s": round(time.monotonic() - t0, 1)})
    scene.save_state(os.path.join(args.outdir, "state_final.npz"), params)
    try:
        scene.save_surface_obj(
            params, os.path.join(args.outdir, "surface.obj")
        )
        frames = export_turntable(
            scene, params, hwf, cfg,
            os.path.join(args.outdir,
                         f"rgb-mse{mse:.4f}-psnr{psnr:.2f}.mp4"),
        )
        write_video(frames, os.path.join(
            args.outdir, f"rgb-mse{mse:.4f}-psnr{psnr:.2f}.gif"))
    except Exception as e:  # the export is best-effort under the deadline
        log(f"export failed: {e!r}")
    print(json.dumps({"final_psnr": psnr, "final_mse": mse,
                      "stages": records}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
