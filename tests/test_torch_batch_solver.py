"""The port's multi-sequence batch solve against the JAX ``MultiSequenceSolver``
on the CPU, at a small size: Q = 2 sequences of F = 16 frames and M = 20
markers (V = 6890), the shipped config with every stage capped at 20
iterations, and the bench's parallel settings (lane width 16, padded widths,
the hypothesis cascade keep 2,1 and the part tournament keep 2) with the
prune rounds scaled to the cap (hypotheses at 5 and 10 iterations, subtrees
at 5).  This file runs ``frame_stride`` 1; ``test_torch_batch_cascade.py``
runs the shipped 2,1 and streaming, with the helpers defined here.

Inputs are made with the JAX package's generators from numpy seeds and
handed to both packages as numpy; the body model is carried over by
``convert.py``.  Tolerances at ``frame_stride`` 1: the same winners, chains,
subtree survivors and marker labels, the same output keys and shapes; trans
and betas within 1e-2 (m), the whole-slice test's tolerance;
rotation-matrix entries within 1e-2 or within twice what the reference
itself moves when its markers are scaled by 1 + 1e-6, whichever is larger.
The 20-iteration stages stop mid-descent, where the line search's cubic fit
amplifies float32 noise: on these sequences the reference moves its
rotations by 2-4e-2 under that perturbation, the port lands 1-1.5e-2 from
it, and trans stays within 1e-2 for both.
"""
import os

# Set before torch loads OpenMP (every port test file does the same): an idle
# OpenMP thread then sleeps at once instead of spinning.  The test run puts
# several processes on one host, each with a thread per core, and spinning
# threads take the cores that the other processes need.  The policy decides
# how a thread waits, not how the work is split, so the results are the same
# bit for bit.
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

import copy

import numpy as np
import pytest
import torch

from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.data.config import load_config as jax_load_config
from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params, random_pose_sequence
from uuo_mocap_tpu.parallel.batch_solver import MultiSequenceSolver as JaxMultiSequenceSolver
from uuo_mocap_tpu.pipeline.multimodal import prepare_sequence as jax_prepare_sequence
from uuo_mocap_tpu_torch.body.model import lbs_forward
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "video_mocap.yaml")
Q, F, M, ITERS = 2, 16, 20, 20
PARAM_ATOL = 1e-2


def config(jax_side: bool, frame_stride=1):
    cfg = jax_load_config(CONFIG)
    for stage in ("part", "chamfer", "marker"):
        cfg["stages"][stage]["num_iters"] = ITERS
    cfg["parallel"] = {
        "lane_width": 16, "part_lane_width": 16, "pad_width": True,
        "hypothesis_prune": {"enabled": True, "at_iters": [5, 10], "keep": [2, 1],
                             "frame_stride": frame_stride},
        "part_prune": {"enabled": True, "at_iters": 5, "keep": 2},
    }
    return cfg if jax_side else copy.deepcopy(cfg)


@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


def make_batch(jm):
    """Q sequences as numpy: ground truth, markers and perturbed prior."""
    seqs = []
    for q in range(Q):
        gt = random_pose_sequence(F, seed=3 + 10 * q, yaw=0.9, travel=0.3)
        mk = generate_markers(jm, gt, num_markers=M, seed=4 + 10 * q, occlusion_rate=0.05)
        prior = perturb_params(gt, seed=5 + 10 * q, pose_noise=0.05, trans_noise=0.08,
                               betas_noise=0.2)
        seqs.append((type(gt)(*(np.asarray(a) for a in gt)), np.array(mk.points),
                     type(prior)(*(np.asarray(a) for a in prior))))
    return seqs


@pytest.fixture(scope="module")
def batch(models):
    return make_batch(models[0])


def _capture(fitter):
    """Record on the instance the results of ``fitter.fit_batch`` and the
    vertex masks of every subtree-lane descent it runs (a survivor's mask
    names its subtree)."""
    inner, run = fitter.fit_batch, fitter._solver.run
    fitter.captured, fitter.masks = [], []

    def fit_batch(*args, **kw):
        out = inner(*args, **kw)
        fitter.captured.append(out)
        return out

    def solver_run(params0, lane, shared):
        fitter.masks.append(np.asarray(lane["vertex_mask"]))
        return run(params0, lane, shared)

    fitter.fit_batch = fit_batch
    fitter._solver.run = solver_run


def jax_preps(batch, scale=1.0):
    return [jax_prepare_sequence(JaxImgSmpl.from_params(prior),
                                 JaxArrayMarkers(mk * np.float32(scale)), frame_bucket=None)
            for _, mk, prior in batch]


@pytest.fixture(scope="module")
def reference(models, batch):
    """The solve, its part fit, and the solve with the markers scaled by
    1 + 1e-6 (one solver: the second solve reuses its programs)."""
    solver = JaxMultiSequenceSolver(models[0], config(True))
    _capture(solver.part_fitter)
    out = solver.solve_prepared(jax_preps(batch))
    fit = solver.part_fitter.captured[0], solver.part_fitter.masks[-1]
    return out, fit, solver.solve_prepared(jax_preps(batch, 1 + 1e-6))


def port_preps(batch):
    return [prepare_sequence(ImgSmpl.from_params(prior), ArrayMarkers(mk.copy()),
                             frame_bucket=None) for _, mk, prior in batch]


@pytest.fixture(scope="module")
def port(models, batch):
    solver = MultiSequenceSolver(models[1], config(False), device="cpu")
    _capture(solver.part_fitter)
    out = solver.solve_prepared(port_preps(batch))
    return out, (solver.part_fitter.captured[0], solver.part_fitter.masks[-1])


def mpjpe_mm(model, out, gt) -> float:
    def joints(p):
        with torch.no_grad():
            return lbs_forward(model, *(torch.as_tensor(np.asarray(a, np.float32)) for a in p)
                               )["joints"][:, :22]

    j = joints((out["pose_body"], out["betas"], out["root_orient"], out["trans"]))
    j_gt = joints((gt.pose_body, np.broadcast_to(gt.betas, (F, 10)), gt.root_orient, gt.trans))
    return float(torch.linalg.norm(j - j_gt, dim=-1).mean()) * 1e3


def test_batch_solve_keys_shapes_and_eval_stats_match_jax(reference, port):
    ref, ours = reference[0], port[0]
    assert set(ours) == set(ref)
    assert ours["scores"].shape == ref["scores"].shape == (Q, 1)
    assert set(ours["stage_times_s"]) == set(ref["stage_times_s"])
    assert set(ours["eval_stats"]) == set(ref["eval_stats"])
    # the port's own counters (``BatchedLbfgs.last_run_stats``) beside the reference's keys
    port_only = {"iterations", "ls_evals", "lane_iters", "ls_exhausted", "host_syncs",
                 "dense_lbs_rows", "dense_lbs_kernel_rows"}
    for stage, st in ref["eval_stats"].items():
        assert set(ours["eval_stats"][stage]) == set(st) - {"segments"} | port_only, stage
        assert ours["eval_stats"][stage]["lanes"] == st["lanes"], stage
        assert ours["eval_stats"][stage]["width"] == st["width"], stage
    for r, o in zip(ref["results"], ours["results"]):
        assert set(o) == set(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                assert o[k].shape == v.shape, k


def test_batch_solve_winners_chains_and_labels_match_jax(reference, port):
    ref, ours = reference[0], port[0]
    np.testing.assert_array_equal(ours["best_hypothesis"], ref["best_hypothesis"])
    for r, o in zip(ref["results"], ours["results"]):
        assert o["best_hypothesis"] == r["best_hypothesis"]
        np.testing.assert_array_equal(o["chain"], r["chain"])
        np.testing.assert_array_equal(o["markers_labels"], r["markers_labels"])


def test_batch_solve_matches_jax_at_frame_stride_1(models, batch, reference, port):
    ref, ours, moved = reference[0], port[0], reference[2]
    for r, o, m in zip(ref["results"], ours["results"], moved["results"]):
        for k in ("trans", "pose_body", "root_orient", "betas"):
            assert np.isfinite(o[k]).all(), k
            tol = PARAM_ATOL
            if k in ("pose_body", "root_orient"):
                tol = max(tol, 2.0 * float(np.abs(m[k] - r[k]).max()))
            np.testing.assert_allclose(o[k], r[k], atol=tol, rtol=0, err_msg=k)
    errs = [(mpjpe_mm(models[1], o, gt), mpjpe_mm(models[1], r, gt))
            for (gt, _, _), o, r in zip(batch, ours["results"], ref["results"])]
    print(f"frame_stride 1: MPJPE (port, reference) per sequence: {errs} mm")


def test_fit_batch_part_prune_matches_jax(reference, port):
    """The subtree tournament: the same survivors (the final descent's lanes
    carry the same subtree masks, in order), chains and labels per
    sequence, and the same set of subtrees scored."""
    (ref, ref_masks), (ours, our_masks) = reference[1], port[1]
    assert len(ours) == len(ref) == Q
    assert our_masks.shape == ref_masks.shape == (Q * 2, 6890)
    np.testing.assert_array_equal(our_masks, ref_masks)
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(o.chain, r.chain)
        np.testing.assert_array_equal(o.marker_labels.numpy(), np.asarray(r.marker_labels))
        rs, os_ = np.asarray(r.subtree_losses), o.subtree_losses.numpy()
        np.testing.assert_array_equal(np.isfinite(os_), np.isfinite(rs))
        assert o.lbfgs_evals > 0
