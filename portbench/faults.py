"""Faults of the timed path, each a stand-in for ``system.solve`` that the
harness can run in its place: the check must call every run that has one
not correct.  The cells run on one chip, so a left-out exchange between
chips is not among them."""
from __future__ import annotations

import copy

import numpy as np

from portbench import system
from portbench.reference import body

ALTERED_TRANS_M = 0.05  # the answer altered: one window's body moved 5 cm
ALTERED_SCORE = 1.01  # the program's hypothesis score altered by 1 %


def unchanged(solver, preps):
    """Every stage's L-BFGS returns its state unchanged (0 iterations)."""
    solvers = system.stage_solvers(solver)
    for s in solvers:
        s.warmup_iter_cap = 0
    try:
        return system.solve(solver, preps)
    finally:
        for s in solvers:
            s.warmup_iter_cap = None


def half_batch(solver, preps):
    """Half of the windows solved; their answers stand in for the rest."""
    h = (len(preps) + 1) // 2
    out = system.solve(solver, preps[:h])
    fill = [copy.deepcopy(out["results"][q % h]) for q in range(h, len(preps))]
    rest = [q % h for q in range(h, len(preps))]
    out["results"] = out["results"] + fill
    out["scores"] = np.concatenate([out["scores"], out["scores"][rest]])
    out["part_fits"] = out["part_fits"] + [out["part_fits"][q] for q in rest]
    out["final_attach"] = np.concatenate([out["final_attach"], out["final_attach"][rest]])
    return out


def alter_answer(out):
    """One window's answer altered where it is produced: its body moved."""
    out = dict(out, results=[dict(r) for r in out["results"]])
    out["results"][0]["trans"] = out["results"][0]["trans"] + np.float32(ALTERED_TRANS_M)
    return out


def alter_score(out):
    """One window's hypothesis score altered where it is produced."""
    out = dict(out, scores=np.array(out["scores"], np.float64))
    out["scores"][0] *= ALTERED_SCORE
    return out


def alter_labels(out):
    """One window's marker labels altered where they are produced: each
    marker given the next part."""
    out = dict(out, results=[dict(r) for r in out["results"]])
    out["results"][0]["markers_labels"] = (out["results"][0]["markers_labels"] + 1) % body.NUM_JOINTS
    return out


def altered_picks(solver, preps):
    """The nearest-vertex picks of the marker stages altered where they are
    produced: the first window's markers each attached to the next vertex."""
    stages = solver.stages
    pick = stages.nearest_points_lanes_nolabel

    def shifted(*args, **kw):
        att = pick(*args, **kw)
        ids = att.vertex_ids.clone()
        ids[0] = (ids[0] + 1) % body.NUM_VERTICES
        return type(att)(ids, att.weights)

    stages.nearest_points_lanes_nolabel = shifted
    try:
        return system.solve(solver, preps)
    finally:
        del stages.nearest_points_lanes_nolabel


def altered_answer(solver, preps):
    return alter_answer(system.solve(solver, preps))


def altered_score(solver, preps):
    return alter_score(system.solve(solver, preps))


def altered_labels(solver, preps):
    return alter_labels(system.solve(solver, preps))


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_answer": altered_answer,
          "altered_score": altered_score, "altered_labels": altered_labels,
          "altered_picks": altered_picks}
# the faults that change a sound solve's output after the fact
OUTPUT_FAULTS = {"altered_answer": alter_answer, "altered_score": alter_score,
                 "altered_labels": alter_labels}
