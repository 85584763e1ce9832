"""Summarize a training run of the PyTorch port from its experiment
directory: steps and epochs, host seconds split into training, validation
and the validation's full-inference part, peak device memory, the best
epoch, and the metrics of ``result_update.json`` (after ``eval``).

The seconds come from the ``"epoch"`` lines that ``Engine.fit`` writes to
``metrics.jsonl``; each part ends by reading its means back from the
device, so the device's work is inside it.

Usage:
  python scripts/torch_campaign_report.py EXPERIMENT_DIR [--out FILE]
"""

import argparse
import json
import os
import sys


def summarize(exp: str) -> dict:
    with open(os.path.join(exp, "config.json")) as f:
        config = json.load(f)
    records = []
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        for line in f:
            if line.strip():
                records.append(json.loads(line))
    epochs = [r for r in records if r["kind"] == "epoch"]
    inference = {r["step"]: r for r in records
                 if r["kind"] == "val_inference"}
    seconds = {k: sum(r.get(k, 0.0) for r in epochs)
               for k in ("train_s", "val_s", "val_inference_s", "save_s")}
    validation = seconds["val_s"] + seconds["val_inference_s"]
    wall = sum(seconds.values())
    best_epoch, best_iou = None, float("-inf")
    for r in epochs:
        inf = inference.get(r["step"])
        # Engine.fit keeps the first of equal maxima (a strict >)
        if inf is not None and inf["val_iou_max"] > best_iou:
            best_epoch, best_iou = r["epoch"], inf["val_iou_max"]
    peaks = [r["peak_bytes"] for r in epochs if "peak_bytes" in r]
    out = {
        "experiment": os.path.abspath(exp),
        "epochs": len(epochs),
        "steps": epochs[-1]["step"] if epochs else 0,
        "validations": sum(1 for r in epochs if "val_s" in r),
        "val_every": config.get("val_every"),
        **{k: round(v, 3) for k, v in seconds.items()},
        "fit_s": round(wall, 3),
        "validation_share": validation / wall if wall else None,
        "inference_share_of_validation": (
            seconds["val_inference_s"] / validation if validation else None),
        "peak_bytes": max(peaks) if peaks else None,
        "best_epoch": best_epoch,
        "best_val_iou_max": best_iou if best_epoch is not None else None,
    }
    report = os.path.join(exp, "result_update.json")
    if os.path.exists(report):
        with open(report) as f:
            out["eval"] = json.load(f)["metrics"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("experiment")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    summary = summarize(args.experiment)
    text = json.dumps(summary, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
