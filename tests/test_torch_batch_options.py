"""The batch solve's options: the port's ``MultiSequenceSolver`` against the
JAX package's on the CPU, one case per option of the main path that the
shipped config leaves off.  This file holds the shared harness and the
ranking case (``optimizer.rank_hier`` with ``hypothesis_prune.rank_phase1``);
``test_torch_batch_options_learned.py`` (network-mode segmentation with SDF
markers), ``_reprojection.py`` (both reprojection stages) and
``_ablations.py`` (``configs/{hmr_full,hmr_part,mht_rotation}.yaml``) hold
the others, in files of their own so that the test workers run them side
by side.

Size: ``tests/test_torch_batch_solver.py``'s batch, Q = 2 sequences of F = 16
frames and M = 20 markers (V = 6890), made with the JAX package's
generators from numpy seeds and handed to both packages as numpy; the body
model is carried over by ``convert.py``.  Every stage is capped at 5
iterations, with ``frame_bucket=None``, ``frame_stride`` 1 and the bench's
parallel settings scaled to that cap (lane width 16, padded widths, the
hypothesis cascade keep 2,1 at 2 and 4 iterations, the part tournament
keep 2 at 2 iterations; ``tests/test_torch_learned_modes.py``'s).

Tolerances, ``tests/test_torch_batch_solver.py``'s protocol: the same output
keys and shapes, the same winning hypothesis, chain, subtree survivors (the
final part-fit descent's lanes carry the same subtree masks, in order) and
marker labels per sequence, and the same saved stages; in the output and in
every saved stage snapshot, trans and betas within 1e-2 (m), and
rotation-matrix entries within 1e-2 or within twice what the reference
itself moves when its markers are scaled by 1 + 1e-6, whichever is larger
(that extra reference solve runs only when a rotation differs by more than
1e-2).  With network segmentation the part fit's marker weights (the
largest chain's fit mask) are equal too.

The free solve is the port's own, from the inputs, as a user's is; it is
held to the whole protocol, but for the two cases in FREE_SOLVE_PARTS.
There the 5-iteration descents amplify float32 noise beyond the protocol,
in the reference as in the port:
  * learned: the first SDF marker stage.  From the reference's own inputs
    the port's stage is within 2.9e-6 of the reference's after 3
    iterations (virtual points included) and 3.3e-2 m from it after its 5;
    the reference's own stage, on its markers scaled by 1 + k 1e-7 for
    k = -10..10, lands 6.3e-4 to 3.3e-2 m from its unscaled result, and at
    k = -10, -9 and -5 where the port does.
  * reprojection: the chamfer stage's tournament descents.  From the same
    inputs the port's chamfer and marker descents are within 2.2e-5 of the
    reference's; the reference's own chamfer snapshot moves up to 3.2e-2 m
    in trans under the scalings of SPREAD.
The figures are ``tools/batch_options_spread.py``'s.
Their free solve is held to the same keys, shapes, winners, chains and fit
mask, to every parameter (trans and betas too) within 1e-2 or twice the
reference's own spread, whichever is larger, and to the reference's marker
labels and subtree survivors wherever every scaled solve of the reference
keeps them.  The spread is the largest move of the reference's solve on its
markers scaled by each of SPREAD (1 +- 3e-7, 1 +- 1e-6, 1 +- 2e-6).  The
1 + 1e-6 move alone is one draw of it: in the two snapshots farthest from
the reference (learned sequence 1's output, reprojection sequence 0's
chamfer stage) it moves trans by 0.0177 and 0.0013 m, the six by up to
0.0368 and 0.0317 m, and the port is 0.0375 and 0.0337 m from the
reference.
For those two the lockstep solve holds the rest: the port's solve runs its
own code throughout, but each L-BFGS descent (``BatchedLbfgs.run``) and
each reprojection stage (``_reprojection_lanes``) hands on the reference's
result for the same call once its own has been compared with it, so that
every call starts from the reference's inputs up to float32 rounding.
Every call is held within 1e-2 of the reference's (the learned case's first
SDF marker descent from the reference's own inputs instead), and the
lockstep output, labels and survivors under the whole protocol.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import contextlib
import copy
import functools

import numpy as np
import pytest
import torch

import uuo_mocap_tpu.solver.lbfgs as jax_lbfgs
import uuo_mocap_tpu_torch.solver.lbfgs as port_lbfgs
from test_torch_batch_solver import PARAM_ATOL, make_batch, models  # noqa: F401  (models: a fixture)
from test_torch_reprojection import CAMERA
from uuo_mocap_tpu.data.config import load_config as jax_load_config
from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
from uuo_mocap_tpu.parallel.batch_solver import MultiSequenceSolver as JaxMultiSequenceSolver
from uuo_mocap_tpu.pipeline.multimodal import prepare_sequence as jax_prepare_sequence
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
ITERS = 5
PARAMS = ("trans", "pose_body", "root_orient", "betas")
ROTATIONS = ("pose_body", "root_orient")
SCALE = 1 + 1e-6
# the marker scalings whose largest move is the reference's own spread
SPREAD = (1 + 3e-7, 1 - 3e-7, SCALE, 1 - 1e-6, 1 + 2e-6, 1 - 2e-6)
# the cases whose free solves part from the reference beyond the protocol
# (module docstring); their lockstep solves are held to all of it
FREE_SOLVE_PARTS = ("learned", "reprojection")


def case_config(name):
    """The config of case ``name``: a shipped config with every running
    stage capped at ITERS iterations and the scaled parallel settings, and
    the case's option turned on."""
    base = name if name in ("hmr_full", "hmr_part", "mht_rotation") else "video_mocap"
    cfg = jax_load_config(os.path.join(REPO, "configs", f"{base}.yaml"))
    for stage in ("part", "chamfer", "marker"):
        if cfg["stages"][stage]["num_iters"] > 0:
            cfg["stages"][stage]["num_iters"] = ITERS
    cfg["parallel"] = {
        "lane_width": 16, "part_lane_width": 16, "pad_width": True,
        "hypothesis_prune": {"enabled": True, "at_iters": [2, 4], "keep": [2, 1],
                             "frame_stride": 1},
        "part_prune": {"enabled": True, "at_iters": 2, "keep": 2},
    }
    if name == "learned":
        cfg["checkpoints_dir"] = CKPT
        cfg["stages"]["part"]["mode"] = "network"
        cfg["stages"]["marker"]["use_sdf"] = True
    elif name == "reprojection":
        for key in ("reprojection_part", "reprojection_full"):
            cfg["stages"][key].update(num_iters=ITERS, num_angles=4)
    elif name == "ranking":
        cfg["optimizer"]["rank_hier"] = True
        cfg["parallel"]["hypothesis_prune"]["rank_phase1"] = True
    return cfg


def _with_camera(img, frames):
    for field, value in CAMERA.items():
        setattr(img, field, np.tile(np.array(value, np.float32), (frames, 1)))
    return img


def case_preps(batch, port, camera, scale=1.0):
    """Both packages' prepared sequences of ``batch`` (the markers scaled by
    ``scale``), the priors carrying CAMERA's streams when ``camera``."""
    img_cls, mk_cls, prepare = ((ImgSmpl, ArrayMarkers, prepare_sequence) if port else
                                (JaxImgSmpl, JaxArrayMarkers, jax_prepare_sequence))
    preps = []
    for _, mk, prior in batch:
        img = img_cls.from_params(prior)
        if camera:
            img = _with_camera(img, mk.shape[0])
        preps.append(prepare(img, mk_cls(mk * np.float32(scale)), frame_bucket=None))
    return preps


def record_part_fit(solver):
    """Record on ``solver`` the part fit's marker weights (``seen["weights"]``),
    its results as numpy (``seen["fit"]``: per sequence root, trans, betas)
    and the vertex masks of every subtree-lane descent (``seen["masks"]``: a
    survivor's mask names its subtree)."""
    fitter, seen = solver.part_fitter, {"masks": []}
    fit_batch, lbfgs = fitter.fit_batch, fitter._solver

    def fit_batch_recorded(markers_b, weights_b, *args, **kw):
        seen["weights"] = np.array(weights_b)
        out = fit_batch(markers_b, weights_b, *args, **kw)
        seen["fit"] = [tuple(np.array(getattr(r.params, k)) for k in ("root_orient", "trans", "betas"))
                       for r in out]
        return out

    def run_recorded(params0, lane, shared):
        seen["masks"].append(np.array(lane["vertex_mask"]))
        return type(lbfgs).run(lbfgs, params0, lane, shared)  # the class's: see lockstep

    fitter.fit_batch = fit_batch_recorded
    lbfgs.run = run_recorded
    return seen


@contextlib.contextmanager
def recording(solver, calls):
    """While active, append to ``calls`` the result of every L-BFGS descent
    of the reference (its parameter dict as numpy) and of every call of
    ``solver._reprojection_lanes`` ((betas, root, trans) as numpy); the
    arguments of its first SDF marker stage go to ``solver.sdf_inputs``."""
    run, reproj = jax_lbfgs.BatchedLbfgs.run, solver._reprojection_lanes
    sdf_lanes = solver.stages.marker_stage_sdf_lanes

    def sdf_recorded(*args):
        if not hasattr(solver, "sdf_inputs"):
            solver.sdf_inputs = [type(a)(*map(np.array, a)) if hasattr(a, "_fields")
                                 else np.array(a) for a in args]
        return sdf_lanes(*args)

    def run_recorded(self, *args):
        p_opt, res = run(self, *args)
        calls.append(("descent", {k: np.array(v) for k, v in p_opt.items()}))
        return p_opt, res

    def reproj_recorded(*args):
        out = reproj(*args)
        calls.append(("reprojection", {k: np.array(v) for k, v in zip(("betas", "root", "trans"),
                                                                     out)}))
        return out

    jax_lbfgs.BatchedLbfgs.run = run_recorded
    solver._reprojection_lanes = reproj_recorded
    solver.stages.marker_stage_sdf_lanes = sdf_recorded
    try:
        yield calls
    finally:
        jax_lbfgs.BatchedLbfgs.run = run
        del solver._reprojection_lanes, solver.stages.marker_stage_sdf_lanes


@contextlib.contextmanager
def lockstep(solver, ref_calls, diffs):
    """While active, each L-BFGS descent of the port and each call of
    ``solver._reprojection_lanes`` appends to ``diffs`` (kind, {key: max
    |port - reference|}) against the reference's call of the same place in
    ``ref_calls``, then hands on the reference's result."""
    run, reproj, seen = port_lbfgs.BatchedLbfgs.run, solver._reprojection_lanes, []

    def take(kind, ours):
        i = len(seen)
        seen.append(kind)
        assert i < len(ref_calls) and ref_calls[i][0] == kind, (i, kind, ref_calls[i:i + 1])
        ref = ref_calls[i][1]
        assert set(ours) == set(ref), (i, kind, set(ours), set(ref))
        diffs.append((kind, {k: float(np.abs(ours[k].detach().cpu().numpy() - ref[k]).max())
                             for k in ref}))
        return {k: torch.as_tensor(ref[k], dtype=ours[k].dtype, device=ours[k].device)
                .reshape(ours[k].shape) for k in ref}

    def run_lockstep(self, *args):
        p_opt, res = run(self, *args)
        return take("descent", p_opt), res

    def reproj_lockstep(*args):
        out = take("reprojection", dict(zip(("betas", "root", "trans"), reproj(*args))))
        return out["betas"], out["root"], out["trans"]

    port_lbfgs.BatchedLbfgs.run = run_lockstep
    solver._reprojection_lanes = reproj_lockstep
    try:
        yield diffs
    finally:
        port_lbfgs.BatchedLbfgs.run = run
        del solver._reprojection_lanes
    assert len(seen) == len(ref_calls), (len(seen), len(ref_calls))


class Case:
    """One option's solves: the reference's (recording its descents), and on
    first use the port's free solve, the port's lockstep solve and the
    reference's on scaled markers (its own solver again: the same
    programs)."""

    def __init__(self, name, models, batch):
        self.name, self.batch = name, batch
        self.camera = name == "reprojection"
        self._port_model = models[1]
        self._ref_solver = JaxMultiSequenceSolver(models[0], case_config(name))
        self.ref_seen = record_part_fit(self._ref_solver)
        with recording(self._ref_solver, []) as self.ref_calls:
            self.ref = self._ref_solver.solve_prepared(
                case_preps(batch, False, self.camera), save_stages=True)
        self._scaled = {}

    def _port_solve(self, wrap=contextlib.nullcontext):
        """The port's solve (under ``wrap(solver)``) and its part-fit record."""
        solver = MultiSequenceSolver(self._port_model, copy.deepcopy(case_config(self.name)),
                                     device="cpu")
        seen = record_part_fit(solver)
        with wrap(solver):
            out = solver.solve_prepared(case_preps(self.batch, True, self.camera),
                                        save_stages=True)
        return out, seen

    @functools.cached_property
    def _free(self):
        return self._port_solve()

    @functools.cached_property
    def _lockstep(self):
        diffs = []
        return self._port_solve(lambda solver: lockstep(solver, self.ref_calls, diffs)) + (diffs,)

    free = property(lambda self: self._free[0])
    free_seen = property(lambda self: self._free[1])
    lockstep = property(lambda self: self._lockstep[0])
    lockstep_seen = property(lambda self: self._lockstep[1])
    lockstep_diffs = property(lambda self: self._lockstep[2])

    def scaled(self, scale):
        """The reference's solve on the markers scaled by ``scale`` and its
        part-fit record."""
        if scale not in self._scaled:
            kept = copy.deepcopy(self.ref_seen)  # the scaled solve records over it
            self.ref_seen.clear()
            self.ref_seen["masks"] = []
            out = self._ref_solver.solve_prepared(
                case_preps(self.batch, False, self.camera, scale), save_stages=True)
            self._scaled[scale] = out, copy.deepcopy(self.ref_seen)
            self.ref_seen.clear()
            self.ref_seen.update(kept)
        return self._scaled[scale]

    def ref_snapshot(self, q, what, scale=None):
        """The reference's parameters that the port's ``what`` ("output" or
        a stage) of sequence ``q`` is held to (with ``scale``, the same
        snapshot of the solve on scaled markers).  The reference's batch
        solve files under ``part`` the seeds after ``reprojection_full``
        (ROADMAP C, "Stage names in the batch solve"); the port files the
        part fit's own result there, as both packages' single-sequence
        solves do, so with the reprojection stages on, its ``part`` is held
        to the reference's part-fit result."""
        out, seen = (self.ref, self.ref_seen) if scale is None else self.scaled(scale)
        r = out["results"][q]
        if what == "output":
            return r
        if what == "part" and self.camera:
            root, trans, betas = seen["fit"][q]
            return {"trans": trans, "root_orient": root, "betas": betas.reshape(-1),
                    "pose_body": r["stages"]["part"]["pose_body"]}
        return r["stages"][what]


@pytest.fixture(scope="module")
def batch(models):
    return make_batch(models[0])


def check_keys_and_shapes(case):
    ref, ours = case.ref, case.free
    assert set(ours) == set(ref)
    assert ours["scores"].shape == ref["scores"].shape
    assert set(ours["eval_stats"]) == set(ref["eval_stats"])
    for stage, st in ref["eval_stats"].items():
        assert ours["eval_stats"][stage]["lanes"] == st["lanes"], stage
        assert ours["eval_stats"][stage]["width"] == st["width"], stage
    for r, o in zip(ref["results"], ours["results"]):
        assert set(o) == set(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                assert o[k].shape == v.shape, k
        assert set(o["stages"]) == set(r["stages"])


def check_winners_and_chains(ours, case):
    ref = case.ref
    np.testing.assert_array_equal(ours["best_hypothesis"], ref["best_hypothesis"])
    for r, o in zip(ref["results"], ours["results"]):
        assert o["best_hypothesis"] == r["best_hypothesis"]
        np.testing.assert_array_equal(o["chain"], r["chain"])


def check_labels_and_survivors(ours, seen, case, scales=()):
    """The marker labels and the final part-fit descent's subtree masks
    equal the reference's; with ``scales``, if any differ, only the labels
    and the masks (per lane) that the reference's solve keeps under every
    one of those marker scalings."""
    ref_masks, our_masks = case.ref_seen["masks"], seen["masks"]
    assert len(our_masks) == len(ref_masks) > 0
    pairs = [(o["markers_labels"], r["markers_labels"], q)
             for q, (r, o) in enumerate(zip(case.ref["results"], ours["results"]))]
    pairs.append((our_masks[-1], ref_masks[-1], "survivors"))
    for o, r, what in pairs:
        if scales and not np.array_equal(o, r):
            kept = np.ones(r.shape[:1] if what == "survivors" else r.shape, bool)
            for scale in scales:
                out, s_seen = case.scaled(scale)
                if what == "survivors":
                    kept &= (s_seen["masks"][-1] == r).all(axis=tuple(range(1, r.ndim)))
                else:
                    kept &= out["results"][what]["markers_labels"] == r
            print(f"{case.name} free solve {what}: {int((~kept).sum())} of {kept.size} moved "
                  f"by the scaled reference, {int((o != r).sum())} entries by the port")
            o, r = o[kept], r[kept]
        np.testing.assert_array_equal(o, r, err_msg=f"{case.name} {what}")


def param_sets(out, q):
    """(what, parameters) of sequence ``q``: the output and every saved
    stage snapshot."""
    r = out["results"][q]
    return [("output", r)] + [(s, r["stages"][s]) for s in sorted(r["stages"])]


def check_params(ours, case, moving=ROTATIONS, scales=(SCALE,)):
    """Every parameter within PARAM_ATOL, those in ``moving`` (by default
    the rotations) within PARAM_ATOL or twice the reference's own move under
    ``scales`` (its largest), whichever is larger, in the output and every
    snapshot."""
    for q in range(len(case.batch)):
        for what, o in param_sets(ours, q):
            r = case.ref_snapshot(q, what)
            for k in PARAMS:
                assert o[k].shape == np.shape(r[k]) and np.isfinite(o[k]).all(), (q, what, k)
                tol = PARAM_ATOL
                if k in moving and np.abs(o[k] - r[k]).max() > PARAM_ATOL:
                    move = max(float(np.abs(case.ref_snapshot(q, what, s)[k] - r[k]).max())
                               for s in scales)
                    tol = max(tol, 2.0 * move)
                    print(f"{case.name} sequence {q} {what} {k}: max |port - reference| "
                          f"{np.abs(o[k] - r[k]).max():.3g}, tolerance {tol:.3g}")
                np.testing.assert_allclose(o[k], r[k], atol=tol, rtol=0,
                                           err_msg=f"{case.name} sequence {q} {what} {k}")


def check_free_solve(case):
    """The free solve's keys, shapes, winners, chains and part-fit marker
    weights."""
    check_keys_and_shapes(case)
    check_winners_and_chains(case.free, case)
    np.testing.assert_array_equal(case.free_seen["weights"], case.ref_seen["weights"])


def check_free_solve_values(case):
    """The free solve's labels, survivors and parameters: under the whole
    protocol, or for FREE_SOLVE_PARTS within the reference's own spread
    (module docstring)."""
    if case.name in FREE_SOLVE_PARTS:
        check_labels_and_survivors(case.free, case.free_seen, case, scales=SPREAD)
        check_params(case.free, case, moving=PARAMS, scales=SPREAD)
    else:
        check_labels_and_survivors(case.free, case.free_seen, case)
        check_params(case.free, case)


def check_lockstep(case, held_elsewhere=()):
    """The lockstep solve: every call within PARAM_ATOL of the reference's on
    the same inputs (but the calls ``held_elsewhere``, by index), then the
    whole protocol on its output, labels and survivors."""
    assert case.lockstep_diffs
    for i, (kind, diff) in enumerate(case.lockstep_diffs):
        print(f"{case.name} lockstep call {i} ({kind}): {diff}")
        if i not in held_elsewhere:
            assert max(diff.values()) <= PARAM_ATOL, (case.name, i, kind, diff)
    check_winners_and_chains(case.lockstep, case)
    check_labels_and_survivors(case.lockstep, case.lockstep_seen, case)
    check_params(case.lockstep, case)


@pytest.fixture(scope="module")
def ranking(models, batch):
    return Case("ranking", models, batch)


def test_ranking_free_solve_matches_jax(ranking):
    check_free_solve(ranking)
    assert "chamfer" in ranking.free["eval_stats"]


def test_ranking_labels_survivors_and_parameters_match_jax(ranking):
    check_free_solve_values(ranking)
