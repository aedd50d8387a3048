"""How ``correct`` is decided.

Every window that a run's solves answered is judged, once the window has
closed, by the plain reference (``portbench/reference``) on the run's device
in float64, from the answer and the run's own inputs:

* ``structure``: the answer's keys, shapes and labels as the solve's
  contract gives them (``MultiSequenceSolver.solve_prepared``), every value
  finite, betas and labels the same in every frame, each label a body part,
  the hypothesis one of those tried, the part fit's body and a final pick
  for every marker.  Counted per window; the limit is 0.
* ``score_gap``: the chamfer score the program gave the marker stage's
  answer, which picked the window's hypothesis (its LBS and nearest-vertex
  kernels), against the reference's score of the same parameters, as
  |program - reference| / reference.
* ``residual_mm``: the answer's fit, the root mean square distance from
  each marker to the nearest vertex of the answer's body (the square root
  of the same chamfer score, of the final answer).  The markers sit 9.5 mm
  off the surface, so a converged fit reads about that.
* ``label_gap_mm``: the answer's ``markers_labels``, each marker's body
  part.  The solve labels a marker with the part of its nearest vertex,
  by distance summed over the frames, on the part fit's body: the prior's
  pose posed with the part fit's betas, root and translation.  The
  reference poses that body, finds each marker's nearest vertex of all and
  the nearest of its labelled part, and reads how far the second lies
  beyond the first, in mm of mean distance (``check.label_gap_mm``).
* ``pick_gap_mm``: the final marker pass's attachment, each marker's
  nearest vertex by distance averaged over the frames on the marker
  stage's body; the same reading for the vertex the solve picked
  (``check.pick_gap_mm``).

The body-joint error against the ground truth that made the markers
(``mpjpe_mm``) and the prior's are logged beside them, not compared: after a
capped solve the joints move by millimetres under float reordering.

A window fails when any number passes its limit
(``portbench/limits/<workload>.json``); a run is correct when none fails.
The control is the reference in the program's place in TF32
(``body.matmul``): its score, labels and picks are the reference's own,
posed in TF32, and it is judged as a run is.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import body, check

NUMBERS = ("structure", "score_gap", "residual_mm", "label_gap_mm", "pick_gap_mm")


def _structure_faults(row: Dict[str, Any], F: int, M: int, hypotheses: int, parts: int,
                      vertices: int) -> List[str]:
    shapes = {"trans": (F, 3), "root_orient": (F, 1, 3, 3), "pose_body": (F, 23, 3, 3),
              "betas": (F, 10), "markers_labels": (F, M)}
    faults = [f"{k} shape {np.shape(row.get(k))} != {s}" for k, s in shapes.items()
              if np.shape(row.get(k)) != s]
    if faults:
        return faults
    for k in ("trans", "root_orient", "pose_body", "betas"):
        if not np.isfinite(row[k]).all():
            faults.append(f"{k} not finite")
    if not (row["betas"] == row["betas"][:1]).all():
        faults.append("betas vary by frame")
    labels = np.asarray(row["markers_labels"])
    if not (labels == labels[:1]).all():
        faults.append("marker labels vary by frame")
    if not ((labels >= 0) & (labels < parts)).all():
        faults.append(f"marker label not in [0, {parts})")
    if not 0 <= int(row["best_hypothesis"]) < hypotheses:
        faults.append(f"best_hypothesis {row['best_hypothesis']} not in [0, {hypotheses})")
    ms = row["marker_stage"]
    if not all(np.isfinite(np.asarray(ms[k])).all() for k in ("trans", "root_orient",
                                                             "pose_body", "betas")):
        faults.append("marker stage not finite")
    if not np.isfinite(row["score"]):
        faults.append("score not finite")
    pf = row["part_fit"]
    if np.shape(pf["trans"]) != (F, 3) or np.shape(pf["root_orient"]) != (F, 1, 3, 3):
        faults.append("part fit body of the wrong shape")
    elif not all(np.isfinite(np.asarray(pf[k])).all() for k in ("trans", "root_orient", "betas")):
        faults.append("part fit body not finite")
    ids = row["attach_ids"]
    if np.shape(ids)[0] < M or not ((ids >= 0) & (ids < vertices)).all():
        faults.append("no final attachment of every marker")
    return faults


def readings(solved: List[Tuple[Any, List[Dict[str, Any]]]], arrays: Dict[str, np.ndarray],
             device: str, hypotheses: int, control: bool = False) -> List[Dict[str, Any]]:
    """One reading per window: {"batch", "window", "structure" (faults),
    the numbers compared, "mpjpe_mm", "prior_residual_mm",
    "prior_mpjpe_mm"}.  ``solved``: (pool batch, ``system.answers`` of its
    solve).  With ``control`` the score, the labels and the picks compared
    are the reference's own in TF32, not the program's."""
    model = body.model_tensors(arrays, torch.float64, device)
    model32 = body.model_tensors(arrays, torch.float32, device) if control else None
    labels_v = check.vertex_labels(model)
    parts, vertices = model["lbs_weights"].shape[1], model["lbs_weights"].shape[0]
    out = []
    for batch, rows in solved:
        if len(rows) != len(batch.markers):
            out.append({"batch": batch.index, "window": -1, "structure": [
                f"{len(rows)} answers for {len(batch.markers)} windows"]})
        for q, (row, gt, prior, markers) in enumerate(zip(rows, batch.gts, batch.priors,
                                                         batch.markers)):
            rec = {"batch": batch.index, "window": q,
                   "structure": _structure_faults(row, markers.shape[0], batch.markers_real,
                                                  hypotheses, parts, vertices)}
            if not rec["structure"]:
                ref = check.chamfer_score(model, markers, row["marker_stage"])
                prog = (check.chamfer_score(model32, markers, row["marker_stage"], tf32=True)
                        if control else row["score"])
                rec["score_gap"] = abs(prog - ref) / ref
                rec["residual_mm"] = check.chamfer_score(model, markers, row) ** 0.5 * 1e3
                # the part fit's body: the prior's pose, the fit's betas, root and translation
                part = dict(row["part_fit"], pose_body=prior["pose_body"])
                d_part = check.mean_distances(model, markers, part)
                d_mark = check.mean_distances(model, markers, row["marker_stage"])
                if control:
                    labels = labels_v[check.mean_distances(model32, markers, part,
                                                           tf32=True).argmin(-1)]
                    ids = check.mean_distances(model32, markers, row["marker_stage"],
                                               tf32=True).argmin(-1)
                else:
                    labels = row["markers_labels"][0]
                    ids = row["attach_ids"][:markers.shape[1]]
                rec["label_gap_mm"] = check.label_gap_mm(d_part, labels_v, labels)
                rec["pick_gap_mm"] = check.pick_gap_mm(d_mark, ids)
                rec["mpjpe_mm"] = check.mpjpe_mm(model, row, gt)
                rec["prior_residual_mm"] = check.chamfer_score(model, markers, prior) ** 0.5 * 1e3
                rec["prior_mpjpe_mm"] = check.mpjpe_mm(model, prior, gt)
            out.append(rec)
    return out


def judge(reads: List[Dict[str, Any]], limits: Dict[str, Any]
          ) -> Tuple[bool, int, Dict[str, Dict[str, float]]]:
    """-> (correct, windows failed, {number: {"value": worst reading,
    "limit": limit}})."""
    failed = 0
    worst = {n: 0.0 for n in NUMBERS}
    for r in reads:
        worst["structure"] = max(worst["structure"], float(len(r["structure"])))
        bad = bool(r["structure"])
        for n in NUMBERS[1:]:
            if n in r:
                worst[n] = max(worst[n], r[n])
                bad |= r[n] > float(limits[n]["limit"])
        failed += bad
    checks = {n: {"value": worst[n], "limit": float(limits[n]["limit"])} for n in NUMBERS}
    return failed == 0 and bool(reads), failed, checks
