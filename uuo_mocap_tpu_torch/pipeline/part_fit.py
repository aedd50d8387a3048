"""Part-based fitting: a lane batch of kinematic subtrees (counterpart of
``uuo_mocap_tpu/pipeline/part_fit.py``): one sequence (``PartFitter.__call__``)
or many (``PartFitter.fit_batch``, lanes = sequence x subtree, with the
``part_prune`` tournament cascade).

Flow (cluster mode, the shipped default):
  host:   rigid clusters -> chain length k -> subtrees with k nodes ->
          dedup at 0.9 overlap -> [S, V] vertex masks
  device: one L-BFGS lane per subtree fits {yaw, trans[F, 3], betas[10]}
          with single-directional chamfer onto the subtree's vertices
          (ranked by the Hopper rank kernel with a per-lane exclusion bias;
          with a ``ground`` loss, the dense forward differentiated through
          ``min_sqdist``), plus the foot-contact and velocity terms
  device: bidirectional chamfer score per subtree (the forward kernel,
          both directions) -> argmin
  device: relabel markers by the frame-summed nearest vertex of the winner
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

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
from uuo_mocap_tpu_torch.ops.geometry import get_aabb, get_aabb_volume, median, upsample_frames
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
# lane tensors with a frame axis (dim 1), strided in a frame-strided round
_LANE_F_KEYS = ("markers", "marker_weights", "o_pose_body", "root_orient0", "foot_contacts",
                "frame_valid")


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


_PART_LOSSES = {"chamfer", "reg_betas", "ground", "foot_contact", "foot_velocity", "velocity"}


def pick_survivors(scores: np.ndarray, orig: np.ndarray, keep: int) -> np.ndarray:
    """The ``keep`` best lanes of one sequence by score (stable order),
    deduplicated by original subtree id ``orig`` (a padding lane repeats a
    real subtree and descends as it does, so two copies must not take both
    places), padded with duplicates when fewer distinct subtrees remain
    (``part_fit.py:393-413``).  -> sorted lane indices [keep]."""
    order = np.argsort(scores, kind="stable")
    chosen, seen = [], set()
    for i in order:
        oid = int(orig[i])
        if oid in seen:
            continue
        seen.add(oid)
        chosen.append(int(i))
        if len(chosen) == keep:
            break
    for i in order:
        if len(chosen) == keep:
            break
        if int(i) not in chosen:
            chosen.append(int(i))
    return np.sort(np.asarray(chosen[:keep]))


def _prune_rounds(prune: Dict[str, Any], default_iters: int, default_keep: int, what: str):
    """A prune cascade's rounds [(at_iters, keep)] and per-round frame
    strides: scalars (one round) or equal-length lists."""
    ai = prune.get("at_iters", default_iters)
    kp = prune.get("keep", default_keep)
    ai = ai if isinstance(ai, (list, tuple)) else [ai]
    kp = kp if isinstance(kp, (list, tuple)) else [kp]
    if len(ai) != len(kp):
        raise ValueError(f"{what} cascade length mismatch: at_iters {list(ai)} vs keep {list(kp)}"
                         " — both lists must pair up round-for-round")
    rounds = [(int(a), max(int(k), 1)) for a, k in zip(ai, kp)]
    fs = prune.get("frame_stride", 1)
    fs = fs if isinstance(fs, (list, tuple)) else [fs] * len(rounds)
    if len(fs) != len(rounds):
        raise ValueError(f"{what} frame_stride {list(fs)} must be a scalar or match the "
                         f"cascade length {len(rounds)}")
    return rounds, [max(int(s), 1) for s in fs]


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
        # the sparse path unless a loss needs the dense vertices with
        # gradients (``ground``); the joints come from whichever forward ran
        sparse = "ground" not in losses

        def fun(p, lane, shared):
            """Every subtree lane (``part_fit.py:103-151``)."""
            d = _data(lane, shared)
            markers = d["markers"]
            F = markers.shape[-3]
            sp = SmplParams(d["o_pose_body"], p["betas"],
                            _yaw_root(p["z"], d["root_orient0"], F), p["trans"])
            if sparse:
                with torch.no_grad():
                    verts_ng = _forward(model, _detach(sp))["vertices"]
                    bias = (1.0 - (d["vertex_mask"] > 0).to(markers.dtype)) * BIG
                    idx = _ranked_nearest(markers, verts_ng, bias)  # [L, F, M] within the subtree
                at = lbs_forward_at(model, sp.pose_body, sp.betas, sp.root_orient, sp.trans, idx)
                total = losses["chamfer"] * _per_lane_weighted_mean(
                    ((markers - at["points"]) ** 2).sum(-1), d["marker_weights"])
                joints = at["joints"]
            else:
                out = _forward(model, sp)
                total = losses["chamfer"] * masked_chamfer_vertex_subset(
                    markers, out["vertices"], d["marker_weights"], d["vertex_mask"][:, None, :],
                    single_directional=True, batch_dims=1)
                joints = out["joints"]
                total = total + losses["ground"] * L.ground_loss_vertices(
                    out["vertices"], d["frame_valid"])
            if "reg_betas" in losses:
                total = total + losses["reg_betas"] * L.mse(p["betas"], d["o_betas"])
            if "foot_contact" in losses:
                total = total + losses["foot_contact"] * L.foot_contact_loss(
                    joints, d["foot_contacts"])
            if "foot_velocity" in losses:
                total = total + losses["foot_velocity"] * L.foot_velocity_loss(
                    joints, d["foot_contacts"])
            if "velocity" in losses:
                total = total + losses["velocity"] * L.velocity_loss(
                    p["trans"], markers.mean(dim=-2), d["frame_valid"])
            return total

        return BatchedLbfgs(fun, _stage_opts(cfg, "part"))

    def _score_lanes_any(self, z_b, betas_b, trans_b, masks, markers, marker_weights,
                         o_pose_body, root_orient0) -> torch.Tensor:
        """Bidirectional masked chamfer per subtree lane, no gradient
        (``part_fit.py:156-262``), LANE_CHUNK lanes at a time (a ragged last
        chunk is scored as it is).  The data arguments carry the lane axis
        (markers [Ln, F, M, 3], weights [Ln, F, M], o_pose_body
        [Ln, F, 23, 3, 3], root_orient0 [Ln, F, 1, 3, 3]) or are one
        sequence's, shared by every lane.  -> [Ln]."""
        F = markers.shape[-3]

        def take(t, single_dims, sl):
            return t[sl] if t.dim() > single_dims else t

        out = []
        with torch.no_grad():
            for s0 in range(0, masks.shape[0], LANE_CHUNK):
                sl = slice(s0, s0 + LANE_CHUNK)
                sp = SmplParams(take(o_pose_body, 4, sl), betas_b[sl],
                                _yaw_root(z_b[sl], take(root_orient0, 4, sl), F), trans_b[sl])
                verts = _forward(self.model, sp)["vertices"]  # [C, F, V, 3]
                out.append(masked_chamfer_vertex_subset(
                    take(markers, 3, sl), verts, take(marker_weights, 2, sl), masks[sl, None, :],
                    single_directional=False, batch_dims=1))
        return torch.cat(out)

    def _relabel_q(self, markers, best_z, best_betas, best_trans, o_pose_body, root_orient0):
        """Nearest-vertex part label per marker, summed over frames, for Q
        sequences at once (``part_fit.py:188-218``): markers [Q, F, M, 3],
        best_z [Q, 1, 1, 1], best_betas [Q, 1, 10], best_trans [Q, F, 3],
        o_pose_body [Q, F, 23, 3, 3], root_orient0 [Q, F, 1, 3, 3]
        -> (labels [Q, M], yaw-rotated roots [Q, F, 1, 3, 3])."""
        F = markers.shape[-3]
        z_root = _yaw_root(best_z, root_orient0, F)
        with torch.no_grad():
            verts = _forward(self.model, SmplParams(o_pose_body, best_betas, z_root,
                                                    best_trans))["vertices"]
            nearest = summed_frame_distances(markers, verts).argmin(dim=-1)  # [Q, M]
        return self.vertex_labels[nearest], z_root

    def _subtree_masks(self, num_rigid_groups: int) -> Tuple[np.ndarray, List[List[int]]]:
        if self.config["stages"]["part"].get("use_full_skeleton"):
            return (np.ones((LANE_CHUNK, self.model.num_vertices), np.float32),
                    [list(range(len(self.model.parents)))])
        return enumerate_subtree_masks(
            self.model, num_bones=num_rigid_groups,
            similarity_threshold=self.config["stages"]["part"].get("similarity_threshold"))

    @staticmethod
    def _confidence(scores: np.ndarray, marker_weights: torch.Tensor) -> Tuple[float, np.ndarray]:
        """2nd-best / best distinct subtree score (unnormalized; 0 when the
        chain covers a single marker) and the fitted marker columns."""
        uniq = np.unique(np.round(scores, 12))
        ratio = float(uniq[1] / uniq[0]) if len(uniq) > 1 else 0.0
        fitted_cols = (marker_weights.amax(dim=0) > 0).cpu().numpy()
        if int(fitted_cols.sum()) == 1:
            ratio = 0.0
        return ratio, fitted_cols

    @staticmethod
    def _aabb_ratio(markers: torch.Tensor, fitted_cols: np.ndarray,
                    frame_valid: Optional[torch.Tensor]) -> torch.Tensor:
        """AABB volume of the fitted marker subset over all markers', real
        frames only."""
        F = markers.shape[0]
        valid_rows = (frame_valid.cpu().numpy() > 0 if frame_valid is not None
                      else np.ones(F, bool))
        m_np = markers.cpu().numpy()[valid_rows]
        flat = torch.as_tensor(m_np.reshape(-1, 3))
        sub = torch.as_tensor(m_np[:, fitted_cols].reshape(-1, 3))
        return get_aabb_volume(get_aabb(sub)) / torch.clamp_min(get_aabb_volume(get_aabb(flat)), 1e-12)

    def fit_batch(self, markers_b: torch.Tensor, marker_weights_b: torch.Tensor,
                  o_pose_body_b: torch.Tensor, o_betas_b: torch.Tensor,
                  root_orient0_b: torch.Tensor, num_rigid_groups: List[int],
                  foot_contacts_b: Optional[torch.Tensor] = None,
                  frame_valid_b: Optional[torch.Tensor] = None) -> List[PartFitResult]:
        """Q sequences' subtree searches as one lane batch, lane = sequence x
        subtree (``part_fit.py:264-555``): markers [Q, F, M, 3], weights
        [Q, F, M], o_pose_body [Q, F, 23, 3, 3], o_betas [Q, 1, 10],
        root_orient0 [Q, F, 1, 3, 3], frame_valid [Q, F].  Each sequence's
        subtree set is padded to the common maximum with repeats of its own
        subtrees.  With ``parallel.part_prune`` enabled, tournament rounds
        descend every lane to ``at_iters`` (on every ``frame_stride``-th
        frame), score them, and keep the best ``keep`` distinct subtrees per
        sequence; the survivors then descend to convergence at full frames.
        Phase wall times (synchronized on CUDA) go to ``last_phase_times``.
        foot_contacts [Q, F, 2] feed the foot losses (zeros when None)."""
        dev = markers_b.device
        self.last_phase_times: Dict[str, float] = {}
        t_last = [time.time()]

        def tick(label):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.time()
            self.last_phase_times[label] = self.last_phase_times.get(label, 0.0) + now - t_last[0]
            t_last[0] = now

        Q, F, M, _ = markers_b.shape
        if foot_contacts_b is None:
            foot_contacts_b = markers_b.new_zeros((Q, F, 2))
        if frame_valid_b is None:
            frame_valid_b = markers_b.new_ones((Q, F))
        per_seq = []
        for q in range(Q):
            masks_np, subtrees = self._subtree_masks(int(num_rigid_groups[q]))
            # lane -> ORIGINAL subtree index (lane i pads with subtrees[i % S])
            per_seq.append((masks_np, subtrees, np.arange(masks_np.shape[0]) % len(subtrees)))
        S_max = max(m.shape[0] for m, _, _ in per_seq)

        def pad_rows(m):
            reps = np.arange(S_max - m.shape[0]) % m.shape[0]
            return np.concatenate([m, m[reps]], axis=0)

        masks = torch.as_tensor(np.stack([pad_rows(m) for m, _, _ in per_seq]), device=dev)
        lane_orig = np.stack([pad_rows(o) for _, _, o in per_seq])  # [Q, S_max]
        Ln = Q * S_max

        def lane_rep(x):  # [Q, ...] -> [Q * S_max, ...], sequence-major
            return x.repeat_interleave(S_max, dim=0)

        params0 = {"z": torch.zeros((Ln, 1, 1, 1), dtype=markers_b.dtype, device=dev),
                   "trans": lane_rep(median(markers_b, dim=2)), "betas": lane_rep(o_betas_b)}
        lane = {"vertex_mask": masks.reshape(Ln, -1), "markers": lane_rep(markers_b),
                "marker_weights": lane_rep(marker_weights_b), "o_pose_body": lane_rep(o_pose_body_b),
                "o_betas": lane_rep(o_betas_b), "root_orient0": lane_rep(root_orient0_b),
                "foot_contacts": lane_rep(foot_contacts_b), "frame_valid": lane_rep(frame_valid_b)}

        prune = dict((self.config.get("parallel") or {}).get("part_prune") or {})
        rounds, fstrides = _prune_rounds(prune, 15, 2, "part_prune")
        do_prune = bool(prune.get("enabled")) and S_max > rounds[-1][1]

        agg_stats: Dict[str, int] = {}  # eval accounting across every phase

        def merge_stats(st):
            for k, v in st.items():
                agg_stats[k] = v if k in ("width", "lanes") else agg_stats.get(k, 0) + v

        def lane_stride(ln, s):
            return ln if s == 1 else {k: (v[:, ::s] if k in _LANE_F_KEYS else v)
                                      for k, v in ln.items()}

        def trans_restride(t, from_s, to_s):
            if from_s == to_s:
                return t
            if from_s > 1:
                t = upsample_frames(t, F, from_s)
            return t[:, ::to_s] if to_s > 1 else t

        sub_ids = np.tile(np.arange(S_max), (Q, 1))  # padded lane index of each live lane
        S_cur = S_max
        evals_per_seq = np.zeros(Q, np.int64)
        scores_rows = np.full((Q, S_max), np.inf)  # best-known score per subtree lane
        tick("setup")
        p_stride = 1
        solver = self._solver
        if do_prune:
            done_iters = 0
            for (at_iters, keep), r_stride in zip(rounds, fstrides):
                if S_cur <= keep:
                    continue
                if p_stride != r_stride:
                    params0 = dict(params0, trans=trans_restride(params0["trans"], p_stride, r_stride))
                    p_stride = r_stride
                lane_r = lane_stride(lane, r_stride)
                solver.iter_cap = max(at_iters - done_iters, 1)
                try:
                    p_opt, res = solver.run(params0, lane_r, {})
                finally:
                    solver.iter_cap = None
                merge_stats(solver.last_run_stats)
                done_iters = at_iters
                evals_per_seq += res.num_evals.cpu().numpy().reshape(Q, S_cur).sum(axis=1)
                tick("descend_prune")
                sc = self._score_lanes_any(
                    p_opt["z"], p_opt["betas"], p_opt["trans"], lane_r["vertex_mask"],
                    lane_r["markers"], lane_r["marker_weights"], lane_r["o_pose_body"],
                    lane_r["root_orient0"]).cpu().numpy().reshape(Q, S_cur)
                tick("score_prune")
                for q in range(Q):
                    scores_rows[q, sub_ids[q]] = sc[q]
                local = np.stack([pick_survivors(sc[q], lane_orig[q, sub_ids[q]], keep)
                                  for q in range(Q)])
                sub_ids = np.take_along_axis(sub_ids, local, axis=1)
                surv = torch.as_tensor((np.arange(Q)[:, None] * S_cur + local).reshape(-1),
                                       device=dev)
                params0 = {k: v[surv] for k, v in p_opt.items()}
                lane = {k: v[surv] for k, v in lane.items()}
                S_cur = keep
                tick("survivor_gather")
        if p_stride > 1:  # the final descent runs at full frames
            params0 = dict(params0, trans=trans_restride(params0["trans"], p_stride, 1))

        p_opt, res = solver.run(params0, lane, {})
        merge_stats(solver.last_run_stats)
        solver.last_run_stats = agg_stats
        evals_per_seq += res.num_evals.cpu().numpy().reshape(Q, S_cur).sum(axis=1)
        tick("descend_final")
        sc_final = self._score_lanes_any(
            p_opt["z"], p_opt["betas"], p_opt["trans"], lane["vertex_mask"], lane["markers"],
            lane["marker_weights"], lane["o_pose_body"], lane["root_orient0"]
        ).cpu().numpy().reshape(Q, S_cur)
        tick("score_final")
        for q in range(Q):
            scores_rows[q, sub_ids[q]] = sc_final[q]
        # survivors carry their final scores, pruned lanes their last
        # tournament score

        best_local = np.argmin(sc_final, axis=1)  # [Q] index into the survivors
        best = sub_ids[np.arange(Q), best_local]  # [Q] padded lane index
        sel = torch.as_tensor(np.arange(Q) * S_cur + best_local, device=dev)
        labels_b, best_root_b = self._relabel_q(markers_b, p_opt["z"][sel], p_opt["betas"][sel],
                                                p_opt["trans"][sel], o_pose_body_b, root_orient0_b)
        tick("relabel")

        results = []
        for q in range(Q):
            row = scores_rows[q]
            # the confidence ratio from the survivors' converged scores when
            # they hold two distinct values (pruned lanes' scores are stale)
            cand = sc_final[q] if len(np.unique(np.round(sc_final[q], 12))) >= 2 \
                else row[np.isfinite(row)]
            ratio, fitted_cols = self._confidence(cand, marker_weights_b[q])
            weights_out = (torch.as_tensor(fitted_cols, dtype=markers_b.dtype, device=dev)[None, :]
                           * ratio).expand(F, M)
            results.append(PartFitResult(
                params=SmplParams(o_pose_body_b[q], p_opt["betas"][int(sel[q])], best_root_b[q],
                                  p_opt["trans"][int(sel[q])]),
                marker_labels=labels_b[q][None].expand(F, M),
                marker_weights=weights_out,
                chain=np.asarray(per_seq[q][1][int(lane_orig[q, best[q]])], np.int32),
                distance=torch.as_tensor(row[int(best[q])]),
                aabb_volume_ratio=self._aabb_ratio(markers_b[q], fitted_cols, frame_valid_b[q]),
                subtree_losses=torch.as_tensor(row),
                lbfgs_evals=int(evals_per_seq[q]),
            ))
        tick("assemble")
        return results

    def __call__(self, markers: torch.Tensor, marker_weights: torch.Tensor,
                 o_pose_body: torch.Tensor, o_betas: torch.Tensor, root_orient0: torch.Tensor,
                 num_rigid_groups: int, foot_contacts: torch.Tensor | None = None,
                 frame_valid: torch.Tensor | None = None) -> PartFitResult:
        """Fit every subtree lane, score, pick, relabel (``part_fit.py:557-649``)."""
        F, M, _ = markers.shape
        dev, dt = markers.device, markers.dtype
        masks_np, subtrees = self._subtree_masks(num_rigid_groups)
        masks = torch.as_tensor(masks_np, device=dev)
        S = masks.shape[0]
        trans0 = median(markers, dim=1)  # reference seeds at the marker median

        def tile(x):
            return x[None].expand((S,) + x.shape).contiguous()

        params0 = {"z": torch.zeros((S, 1, 1, 1), dtype=dt, device=dev),
                   "trans": tile(trans0), "betas": tile(o_betas)}
        lane = {"vertex_mask": masks}
        shared = {"markers": markers, "marker_weights": marker_weights,
                  "o_pose_body": o_pose_body, "o_betas": o_betas, "root_orient0": root_orient0,
                  "foot_contacts": markers.new_zeros((F, 2)) if foot_contacts is None
                  else foot_contacts,
                  "frame_valid": markers.new_ones(F) if frame_valid is None else frame_valid}
        p_opt, res = self._solver.run(params0, lane, shared)

        scores_s = self._score_lanes_any(p_opt["z"], p_opt["betas"], p_opt["trans"], masks,
                                         markers, marker_weights, o_pose_body, root_orient0)
        scores = scores_s.cpu().numpy()
        best = int(np.argmin(scores))  # padding lanes repeat real subtrees
        labels, best_root = self._relabel_q(markers[None], p_opt["z"][best][None],
                                            p_opt["betas"][best][None], p_opt["trans"][best][None],
                                            o_pose_body[None], root_orient0[None])
        ratio, fitted_cols = self._confidence(scores, marker_weights)
        weights_out = (torch.as_tensor(fitted_cols, dtype=dt, device=dev)[None, :] * ratio
                       ).expand(F, M)
        return PartFitResult(
            params=SmplParams(o_pose_body, p_opt["betas"][best], best_root[0], p_opt["trans"][best]),
            marker_labels=labels[0][None].expand(F, M),
            marker_weights=weights_out,
            chain=np.asarray(subtrees[best % len(subtrees)], np.int32),
            distance=scores_s[best],
            aabb_volume_ratio=self._aabb_ratio(markers, fitted_cols, frame_valid),
            subtree_losses=scores_s,
            lbfgs_evals=int(res.num_evals.sum()),
        )
