"""The numbers that decide ``correct``: the program's readings against
the plain reference's.  Each is a gap, 0 where the two agree; the cell's
workload file holds the limit of each."""

from __future__ import annotations

import math
import statistics

# a leaf whose first gradient in the reference is under this share of the
# median leaf's moves under Adam by round-off alone and is not compared
NEGLIGIBLE_GRADIENT = 1e-3


def _rel(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(abs(want), floor)


def _kept(ref: dict) -> list:
    med = statistics.median(ref["grad"])
    return [i for i, g in enumerate(ref["grad"])
            if g >= NEGLIGIBLE_GRADIENT * med]


# the loss terms of the first update that sound runs reproduce to 1e-3 or
# better: smooth in the network's outputs (the surface terms are not: a
# boundary face that flips with the last bit of a deformed position
# changes them; see PERF.md)
STEADY_TERMS = ("occ", "lap", "delta", "total")
# the surface terms that a flipped face moves by its own share alone: K2's
# chamfer (a mean over the working set's samples) and the normals (a mean
# over its edges).  K3's analytic term is not compared by itself: past the
# face budget every target point whose nearest faces were cut off measures
# to the last faces kept, so one face flipped ahead of the cut moves the
# mean by up to 1.6e-2 on a sound run (the reference against itself: 5.5e-3);
# it stays in ``total`` and in the updates
SURFACE_TERMS = ("surf_chamfer", "normal")


def train_numbers(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the worst of the first update's steady loss terms
    (``STEADY_TERMS``: the occupancy MLP and encoders, the GCN and K1
    through the Laplacian and delta terms, the total), each relative to
    the reference's; ``surface_gap``: the worst of the first update's
    surface terms (``SURFACE_TERMS``: K2's chamfer, the normals), held
    looser; ``update_gap``: the median over the kept leaves of the gap of
    the norm of a leaf's change over the compared updates, relative to
    the reference's."""
    keep = _kept(ref)
    gaps = term_gaps(prog["terms"], ref["terms"])
    return {"loss_gap": max(gaps[k] for k in STEADY_TERMS),
            "surface_gap": max(gaps[k] for k in SURFACE_TERMS),
            "update_gap": statistics.median(
                _rel(prog["change"][i], ref["change"][i], 1e-30)
                for i in keep)}


def train_unsteady(prog: dict, ref: dict) -> dict:
    """Readings the comparison leaves out, for the record: the worst kept
    leaf's gap of the first gradient's norm as the optimizer takes it
    (after the global-norm clip), of the change over the updates
    (relative to the larger of the leaf's and the median leaf's norm),
    the later updates' largest loss gap, and every term's gap."""
    keep = _kept(ref)
    med_g = statistics.median(ref["grad"])
    med_c = statistics.median(ref["change"][i] for i in keep)
    return {"grad_gap": max(_rel(prog["grad"][i], ref["grad"][i], med_g)
                            for i in keep),
            "worst_update_gap": max(_rel(prog["change"][i],
                                         ref["change"][i], med_c)
                                    for i in keep),
            "later_loss_gap": max((_rel(a, b, 1e-12) for a, b in
                                   zip(prog["loss"][1:], ref["loss"][1:])),
                                  default=0.0),
            "term_gaps": term_gaps(prog["terms"], ref["terms"])}


def term_gaps(prog: dict, ref: dict) -> dict:
    """Each loss term's gap in the first update, relative to the larger
    of the reference's term and a millionth of its total."""
    floor = 1e-6 * abs(ref["total"])
    return {k: _rel(prog[k], ref[k], floor) for k in ref}


RATES = ("occ_iou", "val_iou_max", "f_score", "f_score_extend")
DISTANCES = ("chamfer", "chamfer_l1", "hausdorff", "hausdorff_max")


def eval_numbers(answers: list, ref: dict) -> dict:
    """Over every answer: ``occupancy_gap``, the largest absolute gap of
    the occupancy IoU and of the swept IoU's maximum (the forward, the
    predicted occupancy and the point-in-tet indices);
    ``surface_gap``, the relative gap of the mean boundary-face count
    (the compacted surface); ``metric_gap``, the largest gap of the
    F-scores (absolute) and of Chamfer, Chamfer-L1 and Hausdorff
    (relative)."""
    occ = surf = met = 0.0
    for a in answers:
        occ = max(occ, *(abs(a[k] - ref[k]) for k in RATES[:2]))
        surf = max(surf, _rel(a["n_boundary"], ref["n_boundary"], 1.0))
        met = max(met, *(abs(a[k] - ref[k]) for k in RATES[2:]),
                  *(_rel(a[k], ref[k], 1e-12) for k in DISTANCES))
    return {"occupancy_gap": occ, "surface_gap": surf, "metric_gap": met}


def finite(values) -> bool:
    return all(math.isfinite(v) for v in values)
