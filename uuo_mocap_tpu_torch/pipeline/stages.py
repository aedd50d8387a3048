"""The L-BFGS solve stages and the marker-correspondence step, main-path
parts (counterpart of ``uuo_mocap_tpu/pipeline/stages.py``).

Every closure is written for a lane batch: parameters carry a leading lane
axis (yaw hypotheses here), per-sequence data is shared across lanes, and a
closure returns one loss per lane.  Each chamfer closure ranks the nearest
vertex of every (frame, marker) on a no-grad dense forward — the Hopper rank
kernel on CUDA — and takes the loss and its gradient from the gathered
forward at the ranked vertices (``stages.py:191-221``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import torch

from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward, lbs_forward_at
from uuo_mocap_tpu_torch.ops import chamfer_kernels
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.ops.chamfer import masked_chamfer, mean_nearest_vertex_over_frames
from uuo_mocap_tpu_torch.solver import losses as L
from uuo_mocap_tpu_torch.solver.lbfgs import BatchedLbfgs, LbfgsOptions


class SmplParams(NamedTuple):
    """Per-sequence SMPL state passed between stages (optionally with a
    leading lane axis on every field)."""

    pose_body: torch.Tensor  # [F, 23, 3, 3]
    betas: torch.Tensor  # [1, 10]
    root_orient: torch.Tensor  # [F, 1, 3, 3]
    trans: torch.Tensor  # [F, 3]


class MarkerAttachment(NamedTuple):
    """Marker m sits at sum_k weights[m, k] * vertices[vertex_ids[m, k]]."""

    vertex_ids: torch.Tensor  # [M, 3] int64
    weights: torch.Tensor  # [M, 3]


def _stage_opts(config: Dict[str, Any], stage: str, lr_default: float = 1.0,
                lr_override: float | None = None) -> LbfgsOptions:
    scfg = config["stages"][stage]
    return LbfgsOptions(
        max_iter=int(scfg["num_iters"]),
        lr=lr_override if lr_override is not None else float(scfg.get("lr", lr_default)),
        tolerance_grad=float(config["optimizer"]["tolerance_grad"]),
        tolerance_change=float(config["optimizer"]["tolerance_change"]),
        history_size=int(config["optimizer"].get("history_size", 10)),
    )


def _data(lane, shared):
    """Merged lane/shared view of the data; lane tensors win."""
    d = dict(shared)
    d.update(lane)
    return d


def _forward(model: BodyModel, params: SmplParams):
    return lbs_forward(model, params.pose_body, params.betas, params.root_orient, params.trans)


def _detach(params: SmplParams) -> SmplParams:
    return SmplParams(*(t.detach() for t in params))


def _ranked_nearest(markers: torch.Tensor, verts_ng: torch.Tensor,
                    y_bias: torch.Tensor | None = None) -> torch.Tensor:
    """No-grad nearest vertex per (lane, frame, marker): markers [(L,) F, M, 3],
    verts [L, F, V, 3], y_bias [L, V] or None -> [L, F, M].  On CUDA this is
    the rank kernel (``chamfer_kernels.rank_nearest_cuda``)."""
    markers = markers.expand(verts_ng.shape[:-2] + markers.shape[-2:])
    return chamfer_kernels.rank_nearest(markers, verts_ng, y_bias)


def _per_lane_weighted_mean(d2: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    w = weights.to(d2.dtype).expand(d2.shape)
    return (d2 * w).flatten(1).sum(-1) / torch.clamp_min(w.flatten(1).sum(-1), 1e-12)


def _sparse_chamfer(model: BodyModel, sp: SmplParams, markers, weights) -> torch.Tensor:
    """Single-directional weighted chamfer per lane with an O(M) backward:
    rank on a no-grad dense forward, differentiate the gathered forward."""
    with torch.no_grad():
        verts_ng = _forward(model, _detach(sp))["vertices"]
        idx = _ranked_nearest(markers, verts_ng)
    return _sparse_chamfer_at(model, sp, markers, weights, idx)


def _sparse_chamfer_at(model: BodyModel, sp: SmplParams, markers, weights, idx) -> torch.Tensor:
    """The gathered-forward chamfer value per lane at fixed vertex ids."""
    pts = lbs_forward_at(model, sp.pose_body, sp.betas, sp.root_orient, sp.trans, idx)["points"]
    return _per_lane_weighted_mean(((markers - pts) ** 2).sum(-1), weights)


# loss keys whose gradients need no dense vertex tensor
_SPARSE_SAFE_LOSSES = {
    "full_chamfer", "reg_pose_body", "reg_betas", "trans_vel",
    "root_orient_vel", "temporal",
}
_CHAMFER_LOSSES = {"full_chamfer", "reg_pose_body", "reg_betas", "trans_vel", "root_orient_vel"}
_MARKER_LOSSES = {"marker", "reg_pose_body", "reg_betas", "temporal"}


def _require(losses, supported, stage):
    extra = set(losses) - supported
    if extra:
        raise NotImplementedError(
            f"{stage}-stage losses {sorted(extra)} are not ported yet (a later slice of the port)")


class SolveStages:
    """Builds the solve-stage solvers for a (model, config) pair."""

    def __init__(self, model: BodyModel, config: Dict[str, Any]):
        self.model = model
        self.config = config
        self.vertex_labels = model.vertex_part_labels()  # [V]
        opt = config["optimizer"]
        if opt.get("rank_per_iteration") or opt.get("rank_hier"):
            raise NotImplementedError(
                "optimizer.rank_per_iteration / rank_hier are not ported yet (a later slice)")

    # --------------------------------------------------------------- chamfer
    @functools.cached_property
    def _chamfer_solver(self) -> BatchedLbfgs:
        cfg = self.config
        scfg = cfg["stages"]["chamfer"]
        losses = scfg["losses"]
        _require(losses, _CHAMFER_LOSSES, "chamfer")
        model = self.model
        single_dir = bool(scfg["single_directional"])
        # sparse-gradient path: exact when every active loss avoids dense
        # vertex tensors (the shipped config: full_chamfer + regs)
        sparse = single_dir and set(losses) <= _SPARSE_SAFE_LOSSES

        def fun(p, lane, shared):
            d = _data(lane, shared)
            root_orient0 = d["root_orient0"]
            z_root = self._chamfer_apply(p["z"], root_orient0)
            pose = rot.rotation_6d_to_matrix(p["pose6d"])
            sp = SmplParams(pose, p["betas"], z_root, p["trans"])
            total = torch.zeros(p["trans"].shape[0], dtype=p["trans"].dtype, device=p["trans"].device)
            if "full_chamfer" in losses:
                if sparse:
                    cham = _sparse_chamfer(model, sp, d["markers"], d["weights"])
                else:  # dense: the min_sqdist Function (and its backward kernel)
                    cham = masked_chamfer(d["markers"], _forward(model, sp)["vertices"],
                                          d["weights"], single_dir, batch_dims=1)
                total = total + losses["full_chamfer"] * cham
            if "root_orient_vel" in losses:
                total = total + losses["root_orient_vel"] * L.root_orient_vel_loss(
                    z_root, root_orient0, d["frame_valid"])
            if "reg_pose_body" in losses:
                total = total + losses["reg_pose_body"] * L.mse(pose, d["o_pose_body"])
            if "trans_vel" in losses:
                total = total + losses["trans_vel"] * L.trans_vel_loss(
                    p["trans"], d["markers"], d["frame_valid"])
            if "reg_betas" in losses:
                total = total + losses["reg_betas"] * L.mse(p["betas"], d["o_betas"])
            return total

        # the reference hard-codes lr=0.1 for this stage (optimization.py:181)
        return BatchedLbfgs(fun, _stage_opts(cfg, "chamfer", lr_override=0.1))

    def _chamfer_apply(self, z, root_orient0):
        if self.config["stages"]["chamfer"].get("yaw_lock", True):
            return rot.rot_z(z) @ root_orient0
        return rot.rotation_6d_to_matrix(z)

    def chamfer_stage_batched(self, markers, weights, o_pose_body, o_betas, pose0, betas0,
                              root0_batch, trans0, marker_labels_mode, frame_valid=None):
        """All A yaw hypotheses at once: optimize {trans, yaw, betas, pose}
        per lane.  root0_batch [A, F, 1, 3, 3]; pose0/betas0/trans0 shared
        seeds.  Returns (SmplParams with a leading A axis, LbfgsResult)."""
        A, F = root0_batch.shape[0], root0_batch.shape[1]
        dev, dt = markers.device, markers.dtype
        if self.config["stages"]["chamfer"].get("yaw_lock", True):
            z0 = torch.zeros((F, 1, 1), dtype=dt, device=dev)
        else:
            z0 = rot.matrix_to_rotation_6d(torch.eye(3, dtype=dt, device=dev).expand(F, 1, 3, 3))

        def tile(x):
            return x[None].expand((A,) + x.shape).contiguous()

        params0 = {"trans": tile(trans0), "z": tile(z0), "betas": tile(betas0),
                   "pose6d": tile(rot.matrix_to_rotation_6d(pose0))}
        lane = {"root_orient0": root0_batch}
        shared = {"markers": markers, "weights": weights, "o_pose_body": o_pose_body,
                  "o_betas": o_betas, "marker_labels_mode": marker_labels_mode,
                  "frame_valid": torch.ones(F, dtype=dt, device=dev) if frame_valid is None
                  else frame_valid}
        p_opt, res = self._chamfer_solver.run(params0, lane, shared)
        return SmplParams(rot.rotation_6d_to_matrix(p_opt["pose6d"]), p_opt["betas"],
                          self._chamfer_apply(p_opt["z"], root0_batch), p_opt["trans"]), res

    # -------------------------------------------------------- nearest points
    def nearest_points_batched(self, markers, params: SmplParams, img_mask,
                               marker_labels_mode=None) -> MarkerAttachment:
        """Marker -> surface correspondence for every lane of ``params``
        (``stages.py:514-535``, the shipped ``use_mean`` path): the argmin
        vertex of the frame-averaged [M, V] distance over img_mask frames."""
        loc = self.config["stages"]["compute_locations"]
        if not loc["use_mean"] or loc["use_barycentric"]:
            raise NotImplementedError(
                "compute_locations without use_mean (the per-frame and barycentric paths) "
                "is not ported yet (a later slice)")
        with torch.no_grad():
            betas = params.betas.expand(params.trans.shape[:-1] + (10,)).mean(-2, keepdim=True)
            vertices = _forward(self.model, SmplParams(
                params.pose_body, betas, params.root_orient, params.trans))["vertices"]
            vid = mean_nearest_vertex_over_frames(markers, vertices, img_mask)  # [A, M]
        ids = torch.stack([vid, vid, vid], dim=-1)
        w = torch.tensor([1.0, 0.0, 0.0], dtype=markers.dtype, device=markers.device)
        return MarkerAttachment(ids, w.expand(ids.shape).contiguous())

    def nearest_points(self, markers, params: SmplParams, img_mask,
                       marker_labels_mode=None) -> MarkerAttachment:
        att = self.nearest_points_batched(
            markers, SmplParams(*(t[None] for t in params)), img_mask, marker_labels_mode)
        return MarkerAttachment(att.vertex_ids[0], att.weights[0])

    # ---------------------------------------------------------------- marker
    @functools.cached_property
    def _marker_solver(self) -> BatchedLbfgs:
        cfg = self.config
        losses = cfg["stages"]["marker"]["losses"]
        _require(losses, _MARKER_LOSSES, "marker")
        model = self.model

        def fun(p, lane, shared):
            d = _data(lane, shared)
            pose = rot.rotation_6d_to_matrix(p["pose6d"])
            root = rot.rotation_6d_to_matrix(p["root6d"])
            Ln, F = p["trans"].shape[:2]
            M = d["att_ids"].shape[-2]
            # the gathered forward touches only the 3M attachment vertices
            pts = lbs_forward_at(model, pose, p["betas"], root, p["trans"],
                                 d["att_ids"].reshape(Ln, 1, M * 3))["points"]
            virtual = (pts.reshape(Ln, F, M, 3, 3) * d["att_w"][:, None, :, :, None]).sum(-2)
            total = torch.zeros(Ln, dtype=pts.dtype, device=pts.device)
            if "marker" in losses:
                total = total + losses["marker"] * L.marker_loss(d["markers"], virtual, d["weights"])
            if "reg_pose_body" in losses:
                total = total + losses["reg_pose_body"] * L.mse(pose, d["o_pose_body"])
            if "reg_betas" in losses:
                total = total + losses["reg_betas"] * L.mse(p["betas"], d["o_betas"])
            if "temporal" in losses:
                total = total + losses["temporal"] * L.temporal_loss(pose, d["frame_valid"])
            return total

        return BatchedLbfgs(fun, _stage_opts(cfg, "marker"))

    def marker_stage_batched(self, markers, weights, o_pose_body, o_betas,
                             params_batch: SmplParams, attachments: MarkerAttachment,
                             frame_valid=None):
        """Marker IK for all A hypotheses: optimize {pose, betas, root, trans}
        against per-lane virtual markers.  params_batch and attachments carry
        a leading A axis."""
        if self.config["stages"]["marker"].get("use_sdf"):
            raise NotImplementedError("marker.use_sdf is not ported yet (a later slice)")
        params0 = {"pose6d": rot.matrix_to_rotation_6d(params_batch.pose_body),
                   "betas": params_batch.betas,
                   "root6d": rot.matrix_to_rotation_6d(params_batch.root_orient),
                   "trans": params_batch.trans}
        lane = {"att_ids": attachments.vertex_ids, "att_w": attachments.weights}
        F = markers.shape[0]
        shared = {"markers": markers, "weights": weights, "o_pose_body": o_pose_body,
                  "o_betas": o_betas,
                  "frame_valid": torch.ones(F, dtype=markers.dtype, device=markers.device)
                  if frame_valid is None else frame_valid}
        p_opt, res = self._marker_solver.run(params0, lane, shared)
        return SmplParams(rot.rotation_6d_to_matrix(p_opt["pose6d"]), p_opt["betas"],
                          rot.rotation_6d_to_matrix(p_opt["root6d"]), p_opt["trans"]), res

    # ------------------------------------------------------------- selection
    def score_chamfer_batched(self, markers, marker_weights, params: SmplParams) -> torch.Tensor:
        """Single-directional weighted chamfer per lane, which picks the best
        yaw hypothesis (the forward kernel on CUDA) -> [A]."""
        with torch.no_grad():
            out = _forward(self.model, params)
            return masked_chamfer(markers, out["vertices"], marker_weights,
                                  single_directional=True, batch_dims=1)

    def marker_labels_from_attachment(self, attachment: MarkerAttachment,
                                      num_frames: int) -> torch.Tensor:
        """Part label per marker from its attachment vertex -> [F, M]."""
        labels = self.vertex_labels[attachment.vertex_ids[:, 0]]
        return labels[None].expand(num_frames, labels.shape[0])
