"""Part-based fitting: a lane batch of kinematic subtrees (counterpart of
``uuo_mocap_tpu/pipeline/part_fit.py``, single-sequence path).

Flow (cluster mode, the shipped default):
  host:   rigid clusters -> chain length k -> subtrees with k nodes ->
          dedup at 0.9 overlap -> [S, V] vertex masks
  device: one L-BFGS lane per subtree fits {yaw, trans[F, 3], betas[10]}
          with single-directional chamfer onto the subtree's vertices
          (ranked by the Hopper rank kernel with a per-lane exclusion bias)
  device: bidirectional chamfer score per subtree (the forward kernel,
          both directions) -> argmin
  device: relabel markers by the frame-summed nearest vertex of the winner
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.joints import (
    get_sub_hierarchies,
    remove_approximately_redundant_hierarchies,
)
from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward_at
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.ops.chamfer import (
    BIG,
    masked_chamfer_vertex_subset,
    summed_frame_distances,
)
from uuo_mocap_tpu_torch.ops.geometry import get_aabb, get_aabb_volume, median
from uuo_mocap_tpu_torch.pipeline.stages import (
    SmplParams, _data, _detach, _forward, _per_lane_weighted_mean, _ranked_nearest,
    _require, _stage_opts,
)
from uuo_mocap_tpu_torch.solver import losses as L
from uuo_mocap_tpu_torch.solver.lbfgs import BatchedLbfgs


class PartFitResult(NamedTuple):
    params: SmplParams  # winning fit (pose = o_pose_body, yaw-rotated root)
    marker_labels: torch.Tensor  # [F, M] relabeled by nearest vertex
    marker_weights: torch.Tensor  # [F, M] confidence (2nd-best / best ratio)
    chain: np.ndarray  # winning subtree joint ids
    distance: torch.Tensor  # winning bidirectional chamfer
    aabb_volume_ratio: torch.Tensor
    subtree_losses: torch.Tensor  # [S] all subtree scores
    lbfgs_evals: int  # closure evaluations summed over the subtree lanes


LANE_CHUNK = 8  # subtree lanes scored together; S is padded to a multiple


def enumerate_subtree_masks(model: BodyModel, num_bones: int,
                            similarity_threshold: float | None = 0.9,
                            pad_multiple: int = LANE_CHUNK) -> Tuple[np.ndarray, List[List[int]]]:
    """Host: subtrees with ``num_bones`` nodes -> padded [S, V] vertex masks
    (padding lanes repeat subtrees cyclically)."""
    subtrees = get_sub_hierarchies(model.parents, num_bones)
    if similarity_threshold is not None and len(subtrees) > 1:
        subtrees = remove_approximately_redundant_hierarchies(subtrees, similarity_threshold)
    vertex_labels = model.vertex_part_labels().cpu().numpy()
    S = len(subtrees)
    S_pad = max(pad_multiple, ((S + pad_multiple - 1) // pad_multiple) * pad_multiple)
    masks = np.zeros((S_pad, vertex_labels.shape[0]), np.float32)
    for i in range(S_pad):
        for j in subtrees[i % S]:
            masks[i, vertex_labels == j] = 1.0
    return masks, subtrees


_PART_LOSSES = {"chamfer", "reg_betas"}


def _yaw_root(z, root_orient0, F):
    """Per-lane yaw z [L, 1, 1, 1] applied to the prior root [F, 1, 3, 3]."""
    return rot.rot_z(z.expand(z.shape[0], F, 1, 1)) @ root_orient0


class PartFitter:
    def __init__(self, model: BodyModel, config: Dict[str, Any]):
        self.model = model
        self.config = config
        self.vertex_labels = model.vertex_part_labels()

    @functools.cached_property
    def _solver(self) -> BatchedLbfgs:
        cfg = self.config
        losses = cfg["stages"]["part"]["losses"]
        _require(losses, _PART_LOSSES, "part")
        model = self.model

        def fun(p, lane, shared):
            """Every subtree lane (``part_fit.py:103-151``, sparse path)."""
            d = _data(lane, shared)
            markers = d["markers"]
            F = markers.shape[-3]
            sp = SmplParams(d["o_pose_body"], p["betas"],
                            _yaw_root(p["z"], d["root_orient0"], F), p["trans"])
            with torch.no_grad():
                verts_ng = _forward(model, _detach(sp))["vertices"]
                bias = (1.0 - (d["vertex_mask"] > 0).to(markers.dtype)) * BIG
                idx = _ranked_nearest(markers, verts_ng, bias)  # [L, F, M] within the subtree
            pts = lbs_forward_at(model, sp.pose_body, sp.betas, sp.root_orient, sp.trans,
                                 idx)["points"]
            total = losses["chamfer"] * _per_lane_weighted_mean(
                ((markers - pts) ** 2).sum(-1), d["marker_weights"])
            if "reg_betas" in losses:
                total = total + losses["reg_betas"] * L.mse(p["betas"], d["o_betas"])
            return total

        return BatchedLbfgs(fun, _stage_opts(cfg, "part"))

    def _score_batch(self, z_b, betas_b, trans_b, masks, markers, marker_weights,
                     o_pose_body, root_orient0) -> torch.Tensor:
        """Bidirectional masked chamfer per subtree lane, no gradient
        (``part_fit.py:156-185``), LANE_CHUNK lanes at a time."""
        F = markers.shape[0]
        out = []
        with torch.no_grad():
            for s0 in range(0, masks.shape[0], LANE_CHUNK):
                sl = slice(s0, s0 + LANE_CHUNK)
                sp = SmplParams(o_pose_body, betas_b[sl],
                                _yaw_root(z_b[sl], root_orient0, F), trans_b[sl])
                verts = _forward(self.model, sp)["vertices"]  # [C, F, V, 3]
                out.append(masked_chamfer_vertex_subset(
                    markers, verts, marker_weights, masks[sl, None, :],
                    single_directional=False, batch_dims=1))
        return torch.cat(out)

    def _relabel(self, markers, best_z, best_betas, best_trans, o_pose_body, root_orient0):
        """Nearest-vertex part label per marker, summed over frames
        (``part_fit.py:188-210``)."""
        F = markers.shape[0]
        z_root = _yaw_root(best_z[None], root_orient0, F)[0]
        with torch.no_grad():
            verts = _forward(self.model, SmplParams(o_pose_body, best_betas, z_root,
                                                    best_trans))["vertices"]
            nearest = summed_frame_distances(markers, verts).argmin(dim=-1)  # [M]
        return self.vertex_labels[nearest], z_root

    def __call__(self, markers: torch.Tensor, marker_weights: torch.Tensor,
                 o_pose_body: torch.Tensor, o_betas: torch.Tensor, root_orient0: torch.Tensor,
                 num_rigid_groups: int, foot_contacts: torch.Tensor | None = None,
                 frame_valid: torch.Tensor | None = None) -> PartFitResult:
        """Fit every subtree lane, score, pick, relabel (``part_fit.py:557-649``)."""
        scfg = self.config["stages"]["part"]
        F, M, _ = markers.shape
        dev, dt = markers.device, markers.dtype
        if scfg.get("use_full_skeleton"):
            masks_np = np.ones((LANE_CHUNK, self.model.num_vertices), np.float32)
            subtrees = [list(range(len(self.model.parents)))]
        else:
            masks_np, subtrees = enumerate_subtree_masks(
                self.model, num_bones=num_rigid_groups,
                similarity_threshold=scfg.get("similarity_threshold"))
        masks = torch.as_tensor(masks_np, device=dev)
        S = masks.shape[0]
        trans0 = median(markers, dim=1)  # reference seeds at the marker median

        def tile(x):
            return x[None].expand((S,) + x.shape).contiguous()

        params0 = {"z": torch.zeros((S, 1, 1, 1), dtype=dt, device=dev),
                   "trans": tile(trans0), "betas": tile(o_betas)}
        lane = {"vertex_mask": masks}
        shared = {"markers": markers, "marker_weights": marker_weights,
                  "o_pose_body": o_pose_body, "o_betas": o_betas, "root_orient0": root_orient0}
        p_opt, res = self._solver.run(params0, lane, shared)

        scores_s = self._score_batch(p_opt["z"], p_opt["betas"], p_opt["trans"], masks,
                                     markers, marker_weights, o_pose_body, root_orient0)
        scores = scores_s.cpu().numpy()
        best = int(np.argmin(scores))  # padding lanes repeat real subtrees
        labels, best_root = self._relabel(markers, p_opt["z"][best], p_opt["betas"][best],
                                          p_opt["trans"][best], o_pose_body, root_orient0)

        # confidence: 2nd-best / best subtree score (unnormalized); zero when
        # the chain covers a single marker
        uniq = np.unique(np.round(scores, 12))
        ratio = float(uniq[1] / uniq[0]) if len(uniq) > 1 else 0.0
        fitted_cols = (marker_weights.amax(dim=0) > 0).cpu().numpy()
        if int(fitted_cols.sum()) == 1:
            ratio = 0.0
        weights_out = (torch.as_tensor(fitted_cols, dtype=dt, device=dev)[None, :] * ratio
                       ).expand(F, M)

        # AABB volume of the fitted marker subset vs all markers, real frames only
        valid_rows = (frame_valid.cpu().numpy() > 0 if frame_valid is not None
                      else np.ones(F, bool))
        m_np = markers.cpu().numpy()[valid_rows]
        flat = torch.as_tensor(m_np.reshape(-1, 3))
        sub = torch.as_tensor(m_np[:, fitted_cols].reshape(-1, 3))
        aabb_ratio = get_aabb_volume(get_aabb(sub)) / torch.clamp_min(
            get_aabb_volume(get_aabb(flat)), 1e-12)

        return PartFitResult(
            params=SmplParams(o_pose_body, p_opt["betas"][best], best_root, p_opt["trans"][best]),
            marker_labels=labels[None].expand(F, M),
            marker_weights=weights_out,
            chain=np.asarray(subtrees[best % len(subtrees)], np.int32),
            distance=scores_s[best],
            aabb_volume_ratio=aabb_ratio,
            subtree_losses=scores_s,
            lbfgs_evals=int(res.num_evals.sum()),
        )
