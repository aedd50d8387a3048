"""The staged multimodal solver, single-sequence path (counterpart of
``uuo_mocap_tpu/pipeline/multimodal.py``).

Segmentation (rigid clustering on the host, or in network mode the
learned segmenter on the solve's device) -> AABB heuristic -> camera
alignment (``reprojection_part``, with the prior's camera streams) -> part
fit -> camera alignment of the full body (``reprojection_full``) -> root
stage -> chamfer stage over A yaw hypotheses -> nearest points -> marker IK
(or its ``use_sdf`` form) -> ``stage_repeats`` x (nearest points + marker
IK) -> output dict with the reference's keys and shapes (numpy).  An
``IterationJournal`` records at the reference's points.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel
from uuo_mocap_tpu_torch.device import resolve_device
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.ops.geometry import get_aabb, get_aabb_volume, get_marker_mask, median
from uuo_mocap_tpu_torch.pipeline.part_fit import PartFitter
from uuo_mocap_tpu_torch.pipeline.reprojection import ReprojectionStage
from uuo_mocap_tpu_torch.pipeline.segmentation import (
    chains_from_labels, filter_rigid, merge_symmetric_labels, segment_markers_network,
    segment_rigid)
from uuo_mocap_tpu_torch.pipeline.stages import SmplParams, SolveStages, _forward
from uuo_mocap_tpu_torch.utils.tracing import spanned, stage, sync


def resample_smpl_stream(trans: np.ndarray, root_orient: np.ndarray, pose_body: np.ndarray,
                         foot_contacts: np.ndarray, src_freq: float, dst_freq: float):
    """Resample the prior stream video rate -> mocap rate: lerp vectors,
    slerp rotations."""
    if src_freq == dst_freq:
        return trans, root_orient, pose_body, foot_contacts
    F = trans.shape[0]
    new_F = round(F * (dst_freq / src_freq))
    pos = np.arange(new_F) * (src_freq / dst_freq)
    i0 = np.minimum(pos.astype(np.int64), F - 1)
    i1 = np.minimum(i0 + 1, F - 1)
    alpha = (pos - i0).astype(np.float32)
    a1 = alpha[:, None]
    trans_r = trans[i0] * (1 - a1) + trans[i1] * a1
    fc_r = foot_contacts[i0] * (1 - a1) + foot_contacts[i1] * a1
    a_rot = torch.as_tensor(alpha[:, None, None])

    def slerp(R):
        return rot.matrix_slerp(torch.as_tensor(R[i0]), torch.as_tensor(R[i1]), a_rot).numpy()

    return trans_r, slerp(root_orient), slerp(pose_body), fc_r


def pad_stream(x: np.ndarray, offset: int) -> np.ndarray:
    """Temporal-offset padding: a positive offset prepends copies of the
    first frame, a negative one appends the last."""
    if offset == 0:
        return x
    if offset > 0:
        return np.concatenate([np.repeat(x[:1], offset, axis=0), x], axis=0)
    return np.concatenate([x, np.repeat(x[-1:], -offset, axis=0)], axis=0)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return sync(t.detach().cpu).numpy()


def _params_to_stage_dict(params: SmplParams) -> Dict[str, np.ndarray]:
    return {
        "trans": _numpy(params.trans),
        "root_orient": _numpy(rot.normalize_rotation(params.root_orient)),
        "betas": _numpy(params.betas)[0],
        "pose_body": _numpy(rot.normalize_rotation(params.pose_body)),
    }


class PreparedSequence:
    """Host-preprocessed inputs of one sequence (numpy): resampled prior
    streams, offset-padded + frame-bucketed markers, validity masks.  ``F``
    includes bucket padding, ``F_real`` is the true frame count.  The camera
    streams, which only the reprojection stages read, are None when the
    prior has no camera (every bbox entry zero, as in a synthetic prior)."""

    __slots__ = (
        "markers", "img_mask", "frame_valid", "F", "F_real", "M_real",
        "o_trans", "o_root_orient", "o_pose_body", "o_foot_contacts", "o_betas",
        "mocap_freq", "has_camera",
        "hmr_betas", "hmr_root_orient", "camera_bbox", "cam_center", "cam_size", "cam_scale",
    )


def prepare_sequence(img_smpl, mocap_markers, offset: Optional[int] = None,
                     frame_bucket: Optional[int] = 64, pad_to_frames: Optional[int] = None,
                     pad_to_markers: Optional[int] = None) -> PreparedSequence:
    """Resample the prior to the mocap rate, apply the temporal offset and
    pad to shape buckets (padding frames carry zeroed markers and repeat the
    prior; padding marker columns are zero, i.e. occluded)."""
    mocap_freq = float(mocap_markers.get_frequency())
    o_trans, o_root_orient, o_pose_body, o_foot_contacts = resample_smpl_stream(
        np.asarray(img_smpl.trans, np.float32), np.asarray(img_smpl.root_orient, np.float32),
        np.asarray(img_smpl.pose_body, np.float32), np.asarray(img_smpl.foot_contacts, np.float32),
        img_smpl.freq, mocap_freq)
    o_betas = np.sum(np.asarray(img_smpl.betas, np.float32), axis=0, keepdims=True)
    o_betas = o_betas / max(float(np.sum(img_smpl.img_mask)), 1.0)
    markers_np = np.nan_to_num(np.asarray(mocap_markers.get_points(), np.float32), nan=0.0)

    offset = int(offset or 0)
    o_pose_body = pad_stream(o_pose_body, offset)
    o_root_orient = pad_stream(o_root_orient, offset)
    o_trans = pad_stream(o_trans, offset)
    o_foot_contacts = pad_stream(o_foot_contacts, offset)
    markers_np = pad_stream(markers_np, -offset)

    F = min(markers_np.shape[0], o_trans.shape[0])
    markers_np = markers_np[:F]
    o_trans, o_root_orient, o_pose_body, o_foot_contacts = (
        o_trans[:F], o_root_orient[:F], o_pose_body[:F], o_foot_contacts[:F])
    img_mask_np = pad_stream(np.asarray(img_smpl.img_mask, np.float32), offset)[:F]

    F_real = F
    if pad_to_frames is not None:
        F_pad = int(pad_to_frames)
    elif frame_bucket and F % frame_bucket != 0:
        F_pad = ((F + frame_bucket - 1) // frame_bucket) * frame_bucket
    else:
        F_pad = F
    if F_pad < F:
        raise ValueError(f"pad_to_frames {F_pad} < sequence length {F}")
    if F_pad != F:
        extra = F_pad - F

        def pad_tail_repeat(a):
            return np.concatenate([a, np.repeat(a[-1:], extra, axis=0)], axis=0)

        o_trans = pad_tail_repeat(o_trans)
        o_root_orient = pad_tail_repeat(o_root_orient)
        o_pose_body = pad_tail_repeat(o_pose_body)
        o_foot_contacts = np.concatenate([o_foot_contacts, np.zeros((extra, 2), np.float32)])
        markers_np = np.concatenate(
            [markers_np, np.zeros((extra,) + markers_np.shape[1:], np.float32)])
        img_mask_np = np.concatenate([img_mask_np, np.zeros(extra, np.float32)])
        F = F_pad

    M_real = markers_np.shape[1]
    if pad_to_markers is not None and pad_to_markers != M_real:
        if pad_to_markers < M_real:
            raise ValueError(f"pad_to_markers {pad_to_markers} < marker count {M_real}")
        markers_np = np.concatenate(
            [markers_np, np.zeros((F, pad_to_markers - M_real, 3), np.float32)], axis=1)

    prep = PreparedSequence()
    prep.markers = markers_np
    prep.img_mask = img_mask_np
    prep.frame_valid = np.zeros(F, np.float32)
    prep.frame_valid[:F_real] = 1.0
    prep.F, prep.F_real, prep.M_real = F, F_real, M_real
    prep.o_trans, prep.o_root_orient, prep.o_pose_body = o_trans, o_root_orient, o_pose_body
    prep.o_foot_contacts, prep.o_betas = o_foot_contacts, o_betas
    prep.mocap_freq = mocap_freq
    bbox = getattr(img_smpl, "camera_bbox", None)
    prep.has_camera = bbox is not None and bool(np.any(np.abs(np.asarray(bbox)) > 0))

    def cam_stream(name):
        """A camera stream at frame index, cut or padded to F by repeating
        its last frame (``multimodal.py:203-230``)."""
        a = getattr(img_smpl, name, None)
        if not prep.has_camera or a is None:
            return None
        a = np.asarray(a, np.float32)
        if a.shape[0] < F:
            a = np.concatenate([a, np.repeat(a[-1:], F - a.shape[0], axis=0)])
        return a[:F]

    prep.hmr_betas, prep.hmr_root_orient = cam_stream("betas"), cam_stream("hmr_root_orient")
    prep.camera_bbox, prep.cam_center = cam_stream("camera_bbox"), cam_stream("center")
    prep.cam_size, prep.cam_scale = cam_stream("size"), cam_stream("scale")
    return prep


def _chamfer_segment_convert(root0_batch: torch.Tensor):
    """The chamfer stage's optimizer parameters -> render-ready arrays per
    lane, for the journal's segments (``multimodal.py:233-254``)."""

    def conv(params, lanes):
        z = torch.as_tensor(params["z"])
        if z.shape[-1] == 6:
            root = rot.rotation_6d_to_matrix(z)
        else:
            root = rot.rot_z(z) @ root0_batch.detach().cpu()[torch.as_tensor(lanes)]
        return {"trans": params["trans"], "betas": params["betas"],
                "pose_body": rot.rotation_6d_to_matrix(torch.as_tensor(params["pose6d"])).numpy(),
                "root_orient": root.numpy()}

    return conv


def _marker_segment_convert(params, lanes):
    """The marker stage's optimizer parameters -> render-ready arrays."""
    return {"trans": params["trans"], "betas": params["betas"],
            "pose_body": rot.rotation_6d_to_matrix(torch.as_tensor(params["pose6d"])).numpy(),
            "root_orient": rot.rotation_6d_to_matrix(torch.as_tensor(params["root6d"])).numpy()}


@contextlib.contextmanager
def _observed(solver, journal, stage, convert):
    """``journal``'s segment hook on ``solver`` while the block runs."""
    if journal is None:
        yield
        return
    solver.snapshot = journal.segment_hook(stage, convert)
    try:
        yield
    finally:
        solver.snapshot = None


def _mode_per_column(labels: np.ndarray) -> np.ndarray:
    return np.apply_along_axis(lambda c: np.bincount(c).argmax(), 0, labels)


def network_segmentation(model: BodyModel, prep: PreparedSequence, checkpoint_root: str):
    """Network-mode segmentation of one sequence (``multimodal.py:333-366``)
    on its real frames: the segmenter's per-frame labels on the model's
    device, with the prior's 22 joints as its video stream; their
    per-marker mode with the right side merged into the left; the chains of
    the merged labels.  The reference feeds the frame-bucket padding (frames
    of zero markers) to the segmenter too, which changes the labels
    (ROADMAP C.9); here the padded frames take each marker's mode, so an
    unpadded sequence gives the reference's labels.
    -> (labels [F, M], merged [M], chains, largest first)."""
    Fr, dev = prep.F_real, model.device

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    prior = SmplParams(on_dev(prep.o_pose_body[:Fr]), on_dev(prep.o_betas),
                       on_dev(prep.o_root_orient[:Fr]), on_dev(prep.o_trans[:Fr]))
    with torch.no_grad():
        joints = _forward(model, prior)["joints"][:, :22]
    real = segment_markers_network(prep.markers[:Fr], prep.mocap_freq,
                                   checkpoint_root=checkpoint_root, joints=joints, device=dev)
    mode = _mode_per_column(real)
    labels = np.concatenate([real, np.broadcast_to(mode, (prep.F - Fr, mode.shape[0]))])
    merged = merge_symmetric_labels(mode)
    return labels, merged, chains_from_labels(merged, model.parents)


@spanned("solve")
def multimodal_video_mocap(img_smpl, mocap_markers, config: Dict[str, Any], model: BodyModel,
                           offset: Optional[int] = None, print_options: List[str] = (),
                           save_stages: bool = False, iter_journal=None,
                           frame_bucket: Optional[int] = 64, device=None) -> Dict[str, Any]:
    """Solve SMPL parameters from unlabeled markers and a video prior
    (``multimodal.py:264-643``).  ``model`` must live on ``device`` (default:
    the card).  ``iter_journal``: an ``IterationJournal`` that records each
    stage's result and the L-BFGS segments of the chamfer and marker
    stages.  Returns the reference's output dict with numpy arrays."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, the solve runs on {dev}")
    t_start = time.time()
    progress = "progress" in print_options

    def log(msg):
        if progress:
            print(msg)

    stages = SolveStages(model, config)
    part_fitter = PartFitter(model, config)
    stage_times: Dict[str, float] = {}

    def timed(name):
        return stage(name, stage_times, dev)

    prep = prepare_sequence(img_smpl, mocap_markers, offset=offset, frame_bucket=frame_bucket)
    mocap_freq = prep.mocap_freq
    markers_np = prep.markers
    F, F_real = prep.F, prep.F_real

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    frame_valid = on_dev(prep.frame_valid)
    markers = on_dev(markers_np)
    weights = get_marker_mask(markers)
    img_mask = on_dev(prep.img_mask)
    o_pose_body, o_root_orient = on_dev(prep.o_pose_body), on_dev(prep.o_root_orient)
    o_trans, o_betas = on_dev(prep.o_trans), on_dev(prep.o_betas)
    o_foot_contacts = on_dev(prep.o_foot_contacts)

    output: Dict[str, Any] = {"stages": {}} if save_stages else {}
    total_evals = 0

    # ---- segmentation: rigid clustering on the host (real frames only), or
    #      the learned segmenter, whose largest chain restricts the part fit
    log("Stage: computing marker segmentation...")
    fit_marker_mask = None
    if config["stages"]["part"].get("mode", "cluster") == "network":
        with timed("segment_network"):
            marker_labels, merged, chains = network_segmentation(
                model, prep, config.get("checkpoints_dir", "./checkpoints"))
        log(f"  network chains: {[len(c) for c in chains]}; fitting chain {chains[0]}")
        num_fit_groups = len(chains[0])
        fit_marker_mask = on_dev(np.isin(merged, chains[0]))  # [M]
    else:
        with timed("segment_rigid"):
            groups = segment_rigid(markers_np[:F_real])
        marker_labels = np.zeros(markers_np.shape[:2], np.int64)
        for gi, group in enumerate(groups):
            marker_labels[:, group] = gi
        num_fit_groups = len(groups)

    # ---- AABB part-vs-full heuristic
    with torch.no_grad():
        mean_out = _forward(model, SmplParams(o_pose_body, o_betas * 0, o_root_orient, o_trans * 0))
        aabb_ratio = sync(float, median(
            get_aabb_volume(get_aabb(markers[:F_real]))
            / get_aabb_volume(get_aabb(mean_out["vertices"][:F_real])), dim=0))

    chain = None
    trans = median(markers, dim=1)
    root_orient = o_root_orient
    betas = o_betas

    def reprojection(key, num_angles):
        """The camera alignment over ``num_angles`` yaw seeds; both stages
        read iterations and losses from ``reprojection_part``, as the
        reference does (ROADMAP C.10)."""
        angles = torch.as_tensor(np.arange(num_angles) * 2 * np.pi / max(num_angles, 1),
                                 dtype=torch.float32, device=dev)
        with timed(key):
            return ReprojectionStage(model, config, "reprojection_part")(
                angles, markers, weights, o_pose_body, betas, on_dev(prep.hmr_betas),
                on_dev(prep.hmr_root_orient), trans, on_dev(prep.camera_bbox),
                on_dev(prep.cam_center), on_dev(prep.cam_size), on_dev(prep.cam_scale), img_mask)

    # ---- camera-aware alignment: the best yaw seed's betas, root and trans
    #      replace the prior's (no shipped config turns it on)
    if (config["find_best_part_fits"] and config["stages"]["reprojection_part"]["num_iters"] > 0
            and prep.has_camera):
        log("Stage [reprojection]: multi-angle camera alignment (batched)...")
        reproj = reprojection("reprojection_part",
                              int(config["stages"]["reprojection_part"]["num_angles"]))
        criterion = config["stages"]["reprojection_part"].get("criterion", "reprojection")
        metrics = {k: _numpy(v) for k, v in reproj["metrics"].items()}
        best_a = int(np.argmin(metrics["reproject" if criterion == "reprojection" else "chamfer"]))
        betas = o_betas = reproj["betas"][best_a].mean(dim=0, keepdim=True)
        root_orient = o_root_orient = reproj["root_orient"][best_a]
        trans = reproj["trans"][best_a]
        if iter_journal is not None:
            iter_journal.record("reprojection", metrics=metrics, best=best_a)

    # ---- part fitting
    if config["find_best_part_fits"]:
        log("Stage [part]: fitting kinematic subtrees...")
        fit_weights = torch.ones_like(weights) * frame_valid[:, None]
        if fit_marker_mask is not None:  # network mode: only the chain's markers
            fit_weights = fit_weights * fit_marker_mask[None, :]
        with timed("part_fit"):
            part_result = part_fitter(markers=markers, marker_weights=fit_weights,
                                      o_pose_body=o_pose_body, o_betas=o_betas,
                                      root_orient0=o_root_orient, num_rigid_groups=num_fit_groups,
                                      foot_contacts=o_foot_contacts, frame_valid=frame_valid)
        marker_labels = _numpy(part_result.marker_labels)
        total_evals += part_result.lbfgs_evals
        root_orient = part_result.params.root_orient
        trans = part_result.params.trans
        betas = part_result.params.betas
        chain = part_result.chain
        if save_stages:
            output["stages"]["part"] = _params_to_stage_dict(
                SmplParams(o_pose_body, betas, root_orient, trans))
        if iter_journal is not None:
            iter_journal.record("part", params=SmplParams(o_pose_body, betas, root_orient, trans))

    # ---- full-body fallback
    if (not config["find_best_part_fits"]) or aabb_ratio > 0.4:
        trans = median(markers, dim=1)
        root_orient = o_root_orient
        betas = o_betas

    # ---- camera-aware alignment of the full body (its num_angles, the rest
    #      of reprojection_part's settings)
    if config["stages"]["reprojection_full"]["num_iters"] > 0 and prep.has_camera:
        log("Stage [reprojection_full]: multi-angle camera alignment (batched)...")
        reproj = reprojection("reprojection_full",
                              int(config["stages"]["reprojection_full"]["num_angles"]))
        best_a = int(np.argmin(_numpy(reproj["metrics"]["reproject"])))
        betas = reproj["betas"][best_a].mean(dim=0, keepdim=True)
        root_orient, trans = reproj["root_orient"][best_a], reproj["trans"][best_a]

    marker_labels_mode = torch.as_tensor(
        _mode_per_column(marker_labels) if marker_labels.size
        else np.zeros(markers_np.shape[1], np.int64), device=dev)

    # ---- root stage: {trans, yaw, betas} on the dense forward, pose fixed
    if config["stages"]["root"]["num_iters"] > 0:
        log("Stage [root]: optimizing root...")
        with timed("root"):
            params_root, res_r = stages.root_stage(
                markers, weights, o_pose_body, betas, root_orient, trans, marker_labels_mode,
                o_betas, frame_valid=frame_valid)
        total_evals += sync(int, res_r.num_evals.sum())
        root_orient, trans, betas = params_root.root_orient, params_root.trans, params_root.betas
        if save_stages:
            output["stages"]["root"] = _params_to_stage_dict(params_root)
        if iter_journal is not None:
            iter_journal.record("root", params=params_root)

    # ---- chamfer + marker stages over A yaw hypotheses (lanes)
    A = int(config["num_root_orient_angles"])
    angles = torch.as_tensor(np.arange(A) * 2 * np.pi / A, dtype=torch.float32, device=dev)
    do_chamfer = config["stages"]["chamfer"]["num_iters"] > 0
    do_marker = config["stages"]["marker"]["num_iters"] > 0
    log(f"Stages [chamfer+marker]: solving {A} yaw hypotheses (batched)...")
    root0_batch = rot.normalize_rotation(
        rot.rot_z(angles[:, None, None, None].expand(A, F, 1, 1)) @ root_orient)  # [A, F, 1, 3, 3]

    def tile(x):
        return x[None].expand((A,) + x.shape)

    # the marker stage's solver (the SDF form under use_sdf), for the journal
    marker_solver = (stages._marker_solver_sdf if config["stages"]["marker"].get("use_sdf")
                     else stages._marker_solver) if iter_journal is not None and do_marker else None
    if do_chamfer:
        with timed("chamfer"), _observed(stages._chamfer_solver, iter_journal, "chamfer",
                                         _chamfer_segment_convert(root0_batch)):
            chamfer_all, res_c = stages.chamfer_stage_batched(
                markers, weights, o_pose_body, o_betas, o_pose_body, betas, root0_batch, trans,
                marker_labels_mode, frame_valid=frame_valid)
        total_evals += sync(int, res_c.num_evals.sum())
    else:
        chamfer_all = SmplParams(tile(o_pose_body), tile(betas), root0_batch, tile(trans))

    nearest_labels = (marker_labels_mode
                      if config["stages"]["segment"]["granularity"] == "part" else None)
    if do_marker:
        with timed("nearest"):
            attach_all = stages.nearest_points_batched(markers, chamfer_all, img_mask,
                                                       nearest_labels)
        with timed("marker"), _observed(marker_solver, iter_journal, "marker",
                                        _marker_segment_convert):
            marker_all, res_m = stages.marker_stage_batched(
                markers, weights, o_pose_body, o_betas, chamfer_all, attach_all,
                frame_valid=frame_valid)
        total_evals += sync(int, res_m.num_evals.sum())
    else:
        marker_all = chamfer_all

    scores = _numpy(stages.score_chamfer_batched(markers, weights, marker_all))
    best = int(np.argmin(scores))
    log(f"  hypothesis scores: {scores} -> best angle index {best}")
    params = SmplParams(*(t[best] for t in marker_all))
    if save_stages and do_chamfer:
        output["stages"]["chamfer"] = _params_to_stage_dict(SmplParams(*(t[best] for t in chamfer_all)))
    if save_stages and do_marker:
        output["stages"]["marker"] = _params_to_stage_dict(params)
    if iter_journal is not None:
        iter_journal.record("chamfer", params=SmplParams(*(t[best] for t in chamfer_all)),
                            scores=scores)
        iter_journal.record("marker", params=params)

    # ---- final refinement repeats
    if do_marker:
        for rep in range(int(config["stage_repeats"])):
            log(f"Stage [marker_final]: refinement {rep + 1}/{config['stage_repeats']}...")
            with timed("nearest_final"):
                attachment = stages.nearest_points(markers, params, img_mask, nearest_labels)
            if config.get("recompute_marker_labels"):
                marker_labels = _numpy(stages.marker_labels_from_attachment(attachment, F))
                if config["stages"]["segment"]["rigid_filter"]:
                    marker_labels = filter_rigid(markers_np, marker_labels)
            with timed("marker_final"), _observed(marker_solver, iter_journal,
                                                  f"marker_final_{rep}", _marker_segment_convert):
                params_b, res_f = stages.marker_stage_batched(
                    markers, weights, params.pose_body, o_betas,
                    SmplParams(*(t[None] for t in params)),
                    type(attachment)(*(t[None] for t in attachment)), frame_valid=frame_valid)
            params = SmplParams(*(t[0] for t in params_b))
            total_evals += sync(int, res_f.num_evals.sum())
            if iter_journal is not None:
                iter_journal.record(f"marker_final_{rep}", params=params)
        if save_stages:
            output["stages"]["marker_final"] = _params_to_stage_dict(params)

    # ---- output assembly: slice the bucket padding back off
    def unpad(a):
        return a[:F_real] if frame_bucket else a

    if save_stages:
        for stage_dict in output["stages"].values():
            for key in ("trans", "root_orient", "pose_body"):
                stage_dict[key] = unpad(stage_dict[key])

    output["trans"] = unpad(_numpy(params.trans))
    output["root_orient"] = unpad(_numpy(rot.normalize_rotation(params.root_orient)))
    output["pose_body"] = unpad(_numpy(rot.normalize_rotation(params.pose_body)))
    output["betas"] = np.broadcast_to(_numpy(params.betas), (F_real, 10)).copy()
    output["mocap_frame_rate"] = mocap_freq
    mocap_markers.set_points(markers_np[:F_real])
    output["mocap_markers"] = mocap_markers
    output["markers_labels"] = np.asarray(marker_labels)[:F_real]
    if chain is not None:
        output["chain"] = chain
    output["solve_time_s"] = time.time() - t_start
    output["lbfgs_evals"] = total_evals
    output["stage_times_s"] = {k: round(v, 2) for k, v in stage_times.items()}
    log(f"  stage times: {output['stage_times_s']}")
    return output
