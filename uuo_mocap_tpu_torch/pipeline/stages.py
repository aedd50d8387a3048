"""The L-BFGS solve stages (root, chamfer, marker) and the
marker-correspondence step (counterpart of ``uuo_mocap_tpu/pipeline/stages.py``).

Every closure is written for a lane batch: parameters carry a leading lane
axis, and a closure returns one loss per lane.  Per-sequence data is shared
across the lanes (the single-sequence solve: lanes are yaw hypotheses) or
carries the lane axis itself (the ``*_lanes`` entry points of the
multi-sequence solve: lanes are sequence x hypothesis); the closures read it
through the merged view ``_data``, so both forms run the same code.  Each
chamfer closure ranks the nearest vertex of every (frame, marker) on a
no-grad dense forward — the Hopper rank kernel on CUDA — and takes the loss
and its gradient from the gathered forward at the ranked vertices
(``stages.py:191-221``).  A chamfer stage with a dense term
(``part_chamfer``, ``ground``, or bidirectional) and the root stage run the
dense forward with gradients instead, through ``min_sqdist`` (the forward
kernel both ways and the backward kernel on CUDA).  With ``marker.use_sdf``
the marker stage co-optimizes virtual marker positions on the template,
which the learned SDF nets (``models/sdf.py``) turn into soft vertex
assignments on every evaluation of a dense forward.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import torch

from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward, lbs_forward_at
from uuo_mocap_tpu_torch.ops import chamfer_kernels
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.ops.chamfer import (
    BIG, masked_chamfer, mean_nearest_vertex_over_frames, nearest_vertex_frames, part_vertex_index)
from uuo_mocap_tpu_torch.ops.point_mesh import point_mesh_distance
from uuo_mocap_tpu_torch.ops import sharded
from uuo_mocap_tpu_torch.ops.rank_hier import RankTable, hierarchical_nearest, rank_table_for
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

    def to_one_hot(self, num_vertices: int) -> torch.Tensor:
        """Dense [..., M, V] barycentric one-hot.  The three weights of a
        marker are added one at a time, in a fixed order: a marker's
        corners may repeat (a vertex attachment is (v, v, v)), and an
        accumulating scatter over all of them at once adds in no fixed
        order on CUDA."""
        ids, w = self.vertex_ids.long(), self.weights
        oh = torch.zeros(w.shape[:-1] + (num_vertices,), dtype=w.dtype, device=w.device)
        for k in range(ids.shape[-1]):
            oh.scatter_add_(-1, ids[..., k:k + 1], w[..., k:k + 1])
        return oh


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
    the rank kernel (``chamfer_kernels.rank_nearest_cuda``); on a vertex-split
    cloud, once per block (``ops.sharded.rank_nearest``)."""
    if isinstance(verts_ng, sharded.VertexShards):
        return sharded.rank_nearest(markers, verts_ng, y_bias)
    markers = markers.expand(verts_ng.shape[:-2] + markers.shape[-2:])
    return chamfer_kernels.rank_nearest(markers, verts_ng, y_bias)


def _per_lane_weighted_mean(d2: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    w = weights.to(d2.dtype).expand(d2.shape)
    return (d2 * w).flatten(1).sum(-1) / torch.clamp_min(w.flatten(1).sum(-1), 1e-12)


def _sparse_chamfer(model: BodyModel, sp: SmplParams, markers, weights,
                    table: RankTable | None = None) -> torch.Tensor:
    """Single-directional weighted chamfer per lane with an O(M) backward:
    rank on a no-grad dense forward (coarse to fine with ``table``),
    differentiate the gathered forward."""
    with torch.no_grad():
        verts_ng = _forward(model, _detach(sp))["vertices"]
        if table is None:
            idx = _ranked_nearest(markers, verts_ng)
        else:
            idx = hierarchical_nearest(markers.expand(verts_ng.shape[:-2] + markers.shape[-2:]),
                                       sharded.dense(verts_ng), table)
    return _sparse_chamfer_at(model, sp, markers, weights, idx)


def _sparse_chamfer_at(model: BodyModel, sp: SmplParams, markers, weights, idx) -> torch.Tensor:
    """The gathered-forward chamfer value per lane at fixed vertex ids."""
    pts = lbs_forward_at(model, sp.pose_body, sp.betas, sp.root_orient, sp.trans, idx)["points"]
    return _per_lane_weighted_mean(((markers - pts) ** 2).sum(-1), weights)


# loss keys whose gradients need no dense vertex tensor.  A stage reads the
# keys it knows and ignores any other, as the reference does (a loss is on
# when its key is present); an unknown key still sends the chamfer stage
# down the dense branch, as there.
_SPARSE_SAFE_LOSSES = {
    "full_chamfer", "reg_pose_body", "reg_betas", "trans_vel",
    "root_orient_vel", "temporal",
}


def _vertex_attachment(vid: torch.Tensor, dtype) -> MarkerAttachment:
    """Each marker on one vertex: ids [..., M] -> ([..., M, 3], weights (1, 0, 0))."""
    ids = torch.stack([vid, vid, vid], dim=-1)
    w = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=vid.device)
    return MarkerAttachment(ids, w.expand(ids.shape).contiguous())


class SolveStages:
    """Builds the solve-stage solvers for a (model, config) pair."""

    def __init__(self, model: BodyModel, config: Dict[str, Any]):
        self.model = model
        self.config = config
        self.vertex_labels = model.vertex_part_labels()  # [V]
        self.part_ids = torch.arange(model.lbs_weights.shape[1], device=model.device)  # [P]

    @functools.cached_property
    def _part_index(self):
        """Each body part's vertex ids, gathered by ``part_chamfer``."""
        return part_vertex_index(self.vertex_labels, self.part_ids)

    def _part_chamfer(self, d, vertices, single_dir):
        return L.part_chamfer_loss(d["markers"], vertices, d["marker_labels_mode"],
                                   self.vertex_labels, self.part_ids, single_dir,
                                   part_index=self._part_index)

    # ------------------------------------------------------------------ root
    @functools.cached_property
    def _root_solver(self) -> BatchedLbfgs:
        """{trans, yaw, betas} per lane with the pose held at the prior's
        (``stages.py:266-318``): every closure runs the dense forward."""
        cfg = self.config
        scfg = cfg["stages"]["root"]
        losses = scfg["losses"]
        model = self.model
        single_dir = bool(scfg["single_directional"])

        def fun(p, lane, shared):
            d = _data(lane, shared)
            root_orient0 = d["root_orient0"]
            z_root = self._root_apply(p["z"], root_orient0)
            out = _forward(model, SmplParams(d["o_pose_body"], p["betas"], z_root, p["trans"]))
            total = torch.zeros(p["trans"].shape[0], dtype=p["trans"].dtype, device=p["trans"].device)
            if "part_chamfer" in losses:
                total = total + losses["part_chamfer"] * self._part_chamfer(
                    d, out["vertices"], single_dir)
            if "full_chamfer" in losses:
                total = total + losses["full_chamfer"] * L.full_chamfer_loss(
                    d["markers"], out["vertices"], d["weights"], single_dir)
            if "root_orient_vel" in losses:
                total = total + losses["root_orient_vel"] * L.root_orient_vel_loss(
                    z_root, root_orient0, d["frame_valid"])
            if "trans_vel" in losses:
                total = total + losses["trans_vel"] * L.trans_vel_loss(
                    p["trans"], d["markers"], d["frame_valid"])
            if "reg_betas" in losses:
                total = total + losses["reg_betas"] * L.mse(p["betas"], d["o_betas"])
            if "ground" in losses:
                total = total + losses["ground"] * L.ground_loss_joints(
                    out["joints"], d["frame_valid"])
            return total

        return BatchedLbfgs(fun, _stage_opts(cfg, "root"))

    def _root_apply(self, z, root_orient0):
        """The root stage's rotation of the prior root [(L,) F, 1, 3, 3]: one
        yaw per lane shared by the frames, z [L, 1, 1, 1]
        (``constrained_rotation``); a yaw per frame, z [L, F, 1, 1]
        (``yaw_lock``); or a free rotation per frame, z [L, F, 1, 6]."""
        scfg = self.config["stages"]["root"]
        if scfg.get("constrained_rotation", False):
            return rot.rot_z(z.expand(z.shape[0], root_orient0.shape[-4], 1, 1)) @ root_orient0
        if scfg.get("yaw_lock", True):
            return rot.rot_z(z) @ root_orient0
        return rot.rotation_6d_to_matrix(z)

    def _root_z0(self, Ln, F, dt, dev):
        """The root stage's initial rotation parameters for Ln lanes."""
        scfg = self.config["stages"]["root"]
        if scfg.get("constrained_rotation", False):
            return torch.zeros((Ln, 1, 1, 1), dtype=dt, device=dev)
        if scfg.get("yaw_lock", True):
            return torch.zeros((Ln, F, 1, 1), dtype=dt, device=dev)
        eye = torch.eye(3, dtype=dt, device=dev).expand(Ln, F, 1, 3, 3)
        return rot.matrix_to_rotation_6d(eye)

    def root_stage(self, markers, weights, o_pose_body, betas0, root_orient0, trans0,
                   marker_labels_mode, o_betas, frame_valid=None):
        """Optimize {trans, yaw, betas} of one sequence, pose fixed
        (``stages.py:320-343``).  -> (SmplParams, LbfgsResult)."""
        F = trans0.shape[0]
        dev, dt = markers.device, markers.dtype
        params0 = {"trans": trans0[None], "z": self._root_z0(1, F, dt, dev), "betas": betas0[None]}
        lane = {"root_orient0": root_orient0[None]}
        shared = {"markers": markers, "weights": weights, "o_pose_body": o_pose_body,
                  "o_betas": o_betas, "marker_labels_mode": marker_labels_mode,
                  "frame_valid": torch.ones(F, dtype=dt, device=dev) if frame_valid is None
                  else frame_valid}
        p_opt, res = self._root_solver.run(params0, lane, shared)
        params = self._post_root(p_opt, root_orient0[None], o_pose_body[None])
        return SmplParams(*(t[0] for t in params)), res

    # --------------------------------------------------------------- chamfer
    @functools.cached_property
    def _chamfer_solver(self) -> BatchedLbfgs:
        return self._make_chamfer_solver(
            bool(self.config["optimizer"].get("rank_per_iteration", False)))

    @functools.cached_property
    def _chamfer_solver_frozen(self) -> BatchedLbfgs:
        """The rank-per-iteration chamfer solver whatever
        ``optimizer.rank_per_iteration`` says: the phase-1 descent of the
        hypothesis tournament under ``hypothesis_prune.rank_phase1``, where
        the objective only has to rank lanes (``stages.py:350-359``)."""
        return self._make_chamfer_solver(True)

    def _make_chamfer_solver(self, rank_per_iteration: bool) -> BatchedLbfgs:
        """The chamfer stage's solver (``stages.py:361-461``).  On the
        sparse path (the shipped losses) ``optimizer.rank_hier`` ranks coarse
        to fine (``ops/rank_hier.py``), and ``rank_per_iteration`` freezes
        the ranking for each iteration: the rank kernel runs once, in the
        L-BFGS ``prepare`` hook, and every evaluation of the iteration's
        line search reuses its picks.  Only the config keys select them."""
        cfg = self.config
        scfg = cfg["stages"]["chamfer"]
        losses = scfg["losses"]
        model = self.model
        single_dir = bool(scfg["single_directional"])
        # sparse-gradient path: exact when every active loss avoids dense
        # vertex tensors (the shipped config: full_chamfer + regs)
        sparse = single_dir and set(losses) <= _SPARSE_SAFE_LOSSES
        table = (rank_table_for(getattr(model, "base", model))
                 if sparse and cfg["optimizer"].get("rank_hier") else None)
        rank_freeze = sparse and rank_per_iteration

        def to_smpl(p, d):
            return SmplParams(rot.rotation_6d_to_matrix(p["pose6d"]), p["betas"],
                              self._chamfer_apply(p["z"], d["root_orient0"]), p["trans"])

        def prepare(p, lane, shared):
            d = _data(lane, shared)
            return _ranked_nearest(d["markers"], _forward(model, to_smpl(p, d))["vertices"])

        def fun(p, lane, shared, idx=None):
            d = _data(lane, shared)
            root_orient0 = d["root_orient0"]
            z_root = self._chamfer_apply(p["z"], root_orient0)
            pose = rot.rotation_6d_to_matrix(p["pose6d"])
            sp = SmplParams(pose, p["betas"], z_root, p["trans"])
            total = torch.zeros(p["trans"].shape[0], dtype=p["trans"].dtype, device=p["trans"].device)
            if sparse:
                if "full_chamfer" in losses and idx is not None:
                    total = total + losses["full_chamfer"] * _sparse_chamfer_at(
                        model, sp, d["markers"], d["weights"], idx)
                elif "full_chamfer" in losses:
                    total = total + losses["full_chamfer"] * _sparse_chamfer(
                        model, sp, d["markers"], d["weights"], table)
            else:  # dense: the min_sqdist Function (and its backward kernel)
                out = _forward(model, sp)
                if "part_chamfer" in losses:
                    total = total + losses["part_chamfer"] * self._part_chamfer(
                        d, out["vertices"], single_dir)
                if "full_chamfer" in losses:
                    total = total + losses["full_chamfer"] * L.full_chamfer_loss(
                        d["markers"], out["vertices"], d["weights"], single_dir)
                if "ground" in losses:
                    total = total + losses["ground"] * L.ground_loss_joints(
                        out["joints"], d["frame_valid"])
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
        return BatchedLbfgs(fun, _stage_opts(cfg, "chamfer", lr_override=0.1),
                            prepare=prepare if rank_freeze else None)

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
        z0 = self._z0((), F, dt, dev)

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
        return self._post_chamfer(p_opt, root0_batch), res

    def _z0(self, batch, F, dt, dev):
        """The chamfer stage's initial root offset: zero yaw [*batch, F, 1, 1]
        (``yaw_lock``) or the identity's 6d form [*batch, F, 1, 6]."""
        if self.config["stages"]["chamfer"].get("yaw_lock", True):
            return torch.zeros(batch + (F, 1, 1), dtype=dt, device=dev)
        eye = torch.eye(3, dtype=dt, device=dev).expand(batch + (F, 1, 3, 3))
        return rot.matrix_to_rotation_6d(eye)

    # -------------------------------------------------------- nearest points
    def nearest_points_batched(self, markers, params: SmplParams, img_mask,
                               marker_labels_mode=None) -> MarkerAttachment:
        """Marker -> surface correspondence for every lane of ``params``
        (``stages.py:494-585``).  markers [F, M, 3] and img_mask [F] are shared
        by the lanes, or carry the lane axis ([Ln, F, M, 3], [Ln, F]);
        marker_labels_mode is [M] or [Ln, M].

        ``use_mean`` (which wins over ``use_barycentric``): the argmin vertex
        of the frame-averaged [M, V] distance over img_mask frames.
        Otherwise each frame's nearest vertex (the rank kernel on CUDA) or
        nearest surface point (``point_mesh_distance``), read at one frame
        per marker chosen by ``segment.granularity``: ``full``, the frame of
        least mean distance; ``marker``, each marker's nearest frame;
        ``part`` (with labels; else ``full``), per part the frame of least
        median distance over the part's markers."""
        loc = self.config["stages"]["compute_locations"]
        granularity = self.config["stages"]["segment"]["granularity"]
        with torch.no_grad():
            betas = params.betas.expand(params.trans.shape[:-1] + (10,)).mean(-2, keepdim=True)
            vertices = _forward(self.model, SmplParams(
                params.pose_body, betas, params.root_orient, params.trans))["vertices"]
            if loc["use_mean"]:
                vid = mean_nearest_vertex_over_frames(markers, vertices, img_mask)  # [A, M]
                return _vertex_attachment(vid, markers.dtype)
            A, F = vertices.shape[:2]
            M = markers.shape[-2]
            mk = markers.expand(A, F, M, 3)
            if loc["use_barycentric"]:
                dist, face_idx, bary = self._point_mesh_frames(mk, vertices)
            else:
                d2, vid = nearest_vertex_frames(mk, vertices)
                dist = torch.sqrt(d2 + 1e-18)
            dist = torch.where(img_mask[..., None] > 0, dist, torch.full_like(dist, BIG))
            if granularity == "marker":
                best_f = dist.argmin(dim=1)  # [A, M]
            elif granularity == "part" and marker_labels_mode is not None:
                best_f = self._part_best_frames(dist, marker_labels_mode.expand(A, M))
            else:  # "full"
                best_f = dist.mean(-1).argmin(dim=1)[:, None].expand(A, M)
            sel = best_f[:, None, :]  # [A, 1, M]
            if not loc["use_barycentric"]:
                return _vertex_attachment(vid.gather(1, sel)[:, 0], markers.dtype)
            faces = torch.as_tensor(self.model.faces, dtype=torch.long, device=markers.device)
            ids = faces[face_idx.gather(1, sel)[:, 0]]  # [A, M, 3]
            w = bary.gather(1, sel[..., None].expand(A, 1, M, 3))[:, 0]
            return MarkerAttachment(ids, w.contiguous())

    def _point_mesh_frames(self, markers, vertices, chunk: int = 32):
        """Per-frame closest surface point: markers [A, F, M, 3], vertices
        [A, F, V, 3] -> (distance [A, F, M], face ids [A, F, M], barycentric
        [A, F, M, 3]), ``chunk`` frames at a time (the [chunk, M, T] working
        set of ``point_mesh_distance``)."""
        A, F, M, _ = markers.shape
        mk, vs = markers.reshape(A * F, M, 3), sharded.dense(vertices).reshape(A * F, -1, 3)
        outs = [point_mesh_distance(mk[f0:f0 + chunk], vs[f0:f0 + chunk], self.model.faces)
                for f0 in range(0, A * F, chunk)]
        return (torch.cat([o["distance"] for o in outs]).reshape(A, F, M),
                torch.cat([o["face_index"] for o in outs]).reshape(A, F, M),
                torch.cat([o["barycentric"] for o in outs]).reshape(A, F, M, 3))

    def _part_best_frames(self, dist, labels):
        """Per lane and part, the frame whose median distance over the
        part's markers is least (frame 0 for a part without markers); each
        marker takes its part's frame (``stages.py:504-571``).  dist
        [A, F, M] (masked frames at 1e10), labels [A, M] -> [A, M]."""
        A, F, M = dist.shape
        P = int(self.part_ids.shape[0])
        pids = torch.arange(P, device=labels.device)
        pmask = labels[:, None, :] == pids[None, :, None]  # [A, P, M]
        vals = torch.where(pmask[:, :, None, :], dist[:, None], torch.full_like(dist[:, None], BIG))
        srt = vals.sort(dim=-1).values  # [A, P, F, M]
        n1 = pmask.sum(-1) - 1  # [A, P]
        half = torch.div(n1, 2, rounding_mode="floor")
        lo = torch.clamp_min(half, 0)
        hi = torch.clamp_min(half + torch.remainder(n1, 2), 0)

        def at(i):
            return srt.gather(-1, i[:, :, None, None].expand(A, P, F, 1))[..., 0]

        med = 0.5 * (at(lo) + at(hi))  # [A, P, F]
        part_best = torch.where(n1 >= 0, med.argmin(dim=-1), torch.zeros_like(n1))  # [A, P]
        return part_best.gather(1, labels.clamp(0, P - 1))

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

    @functools.cached_property
    def _sdf(self):
        """The SDF nets, loaded from the config's ``checkpoints_dir``."""
        from uuo_mocap_tpu_torch.models.sdf import SDF

        return SDF(getattr(self.model, "base", self.model),
                   checkpoint_root=self.config.get("checkpoints_dir", "./checkpoints"))

    @functools.cached_property
    def _marker_solver_sdf(self) -> BatchedLbfgs:
        """The ``use_sdf`` marker IK (``stages.py:634-662``): the virtual
        marker positions on the template are parameters too; every
        evaluation maps them through the SDF nets to a soft assignment
        [L, M, V] and reads the virtual markers off the dense forward.  The
        reference's closure has no ``temporal`` term."""
        cfg = self.config
        losses = cfg["stages"]["marker"]["losses"]
        model, sdf = self.model, self._sdf

        def fun(p, lane, shared):
            d = _data(lane, shared)
            pose = rot.rotation_6d_to_matrix(p["pose6d"])
            root = rot.rotation_6d_to_matrix(p["root6d"])
            out = _forward(model, SmplParams(pose, p["betas"], root, p["trans"]))
            bc = sdf.points_to_barycentric_one_hot(p["virtual_points"])  # [L, M, V]
            virtual = torch.einsum("lmv,lfvd->lfmd", bc, sharded.dense(out["vertices"]))
            total = torch.zeros(pose.shape[0], dtype=pose.dtype, device=pose.device)
            if "marker" in losses:
                total = total + losses["marker"] * L.marker_loss(d["markers"], virtual, d["weights"])
            if "reg_pose_body" in losses:
                total = total + losses["reg_pose_body"] * L.mse(pose, d["o_pose_body"])
            if "reg_betas" in losses:
                total = total + losses["reg_betas"] * L.mse(p["betas"], d["o_betas"])
            return total

        return BatchedLbfgs(fun, _stage_opts(cfg, "marker"))

    def _seed_virtual(self, attachments: MarkerAttachment) -> torch.Tensor:
        """Attachments [L, M, 3] -> the virtual points' seeds on the
        template [L, M, 3] (``stages.py:664-675``)."""
        one_hot = attachments.to_one_hot(self.model.num_vertices)
        return self._sdf.barycentric_one_hot_to_points(one_hot)

    def marker_stage_sdf(self, markers, weights, o_pose_body, o_betas,
                         params_batch: SmplParams, attachments: MarkerAttachment,
                         frame_valid=None):
        """SDF-mode marker IK for all A hypotheses (``stages.py:677-695``):
        virtual points seeded from the attachments on the template and
        optimized with the body parameters."""
        params0 = dict(self._to6d(params_batch), virtual_points=self._seed_virtual(attachments))
        shared = {"markers": markers, "weights": weights, "o_pose_body": o_pose_body,
                  "o_betas": o_betas}
        p_opt, res = self._marker_solver_sdf.run(params0, {}, shared)
        return self._post_marker(p_opt), res

    def marker_stage_batched(self, markers, weights, o_pose_body, o_betas,
                             params_batch: SmplParams, attachments: MarkerAttachment,
                             frame_valid=None):
        """Marker IK for all A hypotheses: optimize {pose, betas, root, trans}
        against per-lane virtual markers.  params_batch and attachments carry
        a leading A axis.  Dispatches to ``marker_stage_sdf`` under
        ``marker.use_sdf``."""
        if self.config["stages"]["marker"].get("use_sdf"):
            return self.marker_stage_sdf(markers, weights, o_pose_body, o_betas, params_batch,
                                         attachments, frame_valid=frame_valid)
        params0 = self._to6d(params_batch)
        lane = {"att_ids": attachments.vertex_ids, "att_w": attachments.weights}
        F = markers.shape[0]
        shared = {"markers": markers, "weights": weights, "o_pose_body": o_pose_body,
                  "o_betas": o_betas,
                  "frame_valid": torch.ones(F, dtype=markers.dtype, device=markers.device)
                  if frame_valid is None else frame_valid}
        p_opt, res = self._marker_solver.run(params0, lane, shared)
        return self._post_marker(p_opt), res

    # ------------------------------------------------- multi-sequence lanes
    # The same solvers serve the multi-sequence solve (``stages.py:723-865``):
    # every per-sequence tensor moves from ``shared`` into ``lane``, so
    # sequences x hypotheses become lanes of the same closures.

    def root_stage_lanes(self, markers_l, weights_l, o_pose_l, o_betas_l, betas0_l, root0_l,
                         trans0_l, labels_l, frame_valid_l):
        """Per-lane root stage (``stages.py:731-757``): every argument carries
        a leading lane axis (lane = sequence).  -> (SmplParams, LbfgsResult)."""
        Ln, F = root0_l.shape[0], root0_l.shape[1]
        params0 = {"trans": trans0_l, "z": self._root_z0(Ln, F, trans0_l.dtype, trans0_l.device),
                   "betas": betas0_l}
        lane = {"root_orient0": root0_l, "markers": markers_l, "weights": weights_l,
                "o_pose_body": o_pose_l, "o_betas": o_betas_l, "marker_labels_mode": labels_l,
                "frame_valid": frame_valid_l}
        p_opt, res = self._root_solver.run(params0, lane, {})
        return self._post_root(p_opt, root0_l, o_pose_l), res

    def marker_stage_sdf_lanes(self, markers_l, weights_l, o_pose_l, o_betas_l,
                               params_l: SmplParams, attachments_l: MarkerAttachment,
                               frame_valid_l):
        """Per-lane SDF-mode marker IK (``stages.py:799-817``), signature-
        compatible with ``marker_stage_lanes``."""
        params0 = dict(self._to6d(params_l), virtual_points=self._seed_virtual(attachments_l))
        lane = {"markers": markers_l, "weights": weights_l, "o_pose_body": o_pose_l,
                "o_betas": o_betas_l}
        p_opt, res = self._marker_solver_sdf.run(params0, lane, {})
        return self._post_marker(p_opt), res

    def chamfer_stage_lanes(self, markers_l, weights_l, o_pose_l, o_betas_l, pose0_l, betas0_l,
                            root0_l, trans0_l, labels_l, frame_valid_l, solver=None):
        """Per-lane chamfer stage: every argument carries a leading lane axis
        (lane = sequence x yaw hypothesis).  ``solver`` overrides the stage
        solver.  Returns (SmplParams [Ln, ...], LbfgsResult)."""
        Ln, F = root0_l.shape[0], root0_l.shape[1]
        solver = self._chamfer_solver if solver is None else solver
        params0 = {"trans": trans0_l, "z": self._z0((Ln,), F, trans0_l.dtype, trans0_l.device),
                   "betas": betas0_l, "pose6d": rot.matrix_to_rotation_6d(pose0_l)}
        lane = {"root_orient0": root0_l, "markers": markers_l, "weights": weights_l,
                "o_pose_body": o_pose_l, "o_betas": o_betas_l, "marker_labels_mode": labels_l,
                "frame_valid": frame_valid_l}
        p_opt, res = solver.run(params0, lane, {})
        return self._post_chamfer(p_opt, root0_l), res

    def marker_stage_lanes(self, markers_l, weights_l, o_pose_l, o_betas_l, params_l: SmplParams,
                           attachments_l: MarkerAttachment, frame_valid_l):
        """Per-lane marker IK (multi-sequence form of ``marker_stage_batched``
        without its ``use_sdf`` dispatch, which the batch solve makes)."""
        lane = {"att_ids": attachments_l.vertex_ids, "att_w": attachments_l.weights,
                "markers": markers_l, "weights": weights_l, "o_pose_body": o_pose_l,
                "o_betas": o_betas_l, "frame_valid": frame_valid_l}
        p_opt, res = self._marker_solver.run(self._to6d(params_l), lane, {})
        return self._post_marker(p_opt), res

    def nearest_points_lanes(self, markers_l, params_l: SmplParams, img_mask_l,
                             labels_l=None) -> MarkerAttachment:
        """Per-lane correspondence: markers [Ln, F, M, 3], img_mask [Ln, F]."""
        return self.nearest_points_batched(markers_l, params_l, img_mask_l, labels_l)

    def nearest_points_lanes_nolabel(self, markers_l, params_l: SmplParams,
                                     img_mask_l) -> MarkerAttachment:
        return self.nearest_points_batched(markers_l, params_l, img_mask_l)

    # --------------------------------------------- parameter conversions
    @staticmethod
    def _to6d(params: SmplParams) -> Dict[str, torch.Tensor]:
        return {"pose6d": rot.matrix_to_rotation_6d(params.pose_body), "betas": params.betas,
                "root6d": rot.matrix_to_rotation_6d(params.root_orient), "trans": params.trans}

    @staticmethod
    def _post_marker(p: Dict[str, torch.Tensor]) -> SmplParams:
        return SmplParams(rot.rotation_6d_to_matrix(p["pose6d"]), p["betas"],
                          rot.rotation_6d_to_matrix(p["root6d"]), p["trans"])

    def _post_root(self, p: Dict[str, torch.Tensor], root0: torch.Tensor,
                   o_pose: torch.Tensor) -> SmplParams:
        return SmplParams(o_pose, p["betas"], self._root_apply(p["z"], root0), p["trans"])

    def _post_chamfer(self, p: Dict[str, torch.Tensor], root0: torch.Tensor) -> SmplParams:
        return SmplParams(rot.rotation_6d_to_matrix(p["pose6d"]), p["betas"],
                          self._chamfer_apply(p["z"], root0), p["trans"])

    # ------------------------------------------------------------- selection
    def score_chamfer_batched(self, markers, marker_weights, params: SmplParams) -> torch.Tensor:
        """Single-directional weighted chamfer per lane, which picks the best
        yaw hypothesis (the forward kernel on CUDA) -> [A].  markers and
        weights are shared ([F, M, 3], [F, M]) or per lane ([Ln, F, M, 3])."""
        with torch.no_grad():
            out = _forward(self.model, params)
            return masked_chamfer(markers, out["vertices"], marker_weights,
                                  single_directional=True, batch_dims=1)

    score_chamfer_lanes = score_chamfer_batched

    def marker_labels_from_attachment(self, attachment: MarkerAttachment,
                                      num_frames: int) -> torch.Tensor:
        """Part label per marker from its attachment vertex -> [F, M]."""
        labels = self.vertex_labels[attachment.vertex_ids[:, 0]]
        return labels[None].expand(num_frames, labels.shape[0])
