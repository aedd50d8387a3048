"""Loss terms of the staged solve (counterpart of
``uuo_mocap_tpu/solver/losses.py``).

Every term of the solve is per lane (``soft_cross_entropy``, a training
loss, is not): its first argument carries a leading lane axis
[L, ...], the other arguments are either lane-batched too or shared
(broadcast over lanes), and the result is [L].  Frame masks follow the same
rule: ``frame_valid`` is [F] (one sequence shared by every lane) or [L, F]
(one sequence per lane, as in the multi-sequence solve).  The reference
computes the same scalars one lane at a time under ``vmap``.
"""
from __future__ import annotations

from typing import Optional

import torch

from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.ops.chamfer import chamfer_by_part, masked_chamfer
from uuo_mocap_tpu_torch.ops.sharded import dense
from uuo_mocap_tpu_torch.settings import MARKER_DISTANCE


def _per_lane_mean(t: torch.Tensor) -> torch.Tensor:
    return t.flatten(1).mean(-1)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _per_lane_mean((a - b) ** 2)


def marker_loss(markers, virtual_markers, marker_weights, marker_distance=MARKER_DISTANCE):
    """((|m - v_hat| - d)^2 * w), averaged over all F*M entries."""
    d2 = ((markers - virtual_markers) ** 2).sum(-1)
    dist = torch.sqrt(d2 + 1e-18)  # NaN-grad-safe at exact overlap
    return _per_lane_mean(((dist - marker_distance) ** 2) * marker_weights)


def _vel_mask(frame_valid: torch.Tensor) -> torch.Tensor:
    """[(L,) F] validity -> [(L,) F-1] velocity-pair validity (both frames real)."""
    return frame_valid[..., 1:] * frame_valid[..., :-1]


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-lane mean of ``values`` [L, F', ...] over entries whose frame
    mask, [F'] or [L, F'], is > 0."""
    m = mask.reshape(mask.shape + (1,) * (values.dim() - 2)).expand(values.shape)
    num = (values * m).flatten(1).sum(-1)
    return num / torch.clamp_min(m.flatten(1).sum(-1), 1e-12)


def trans_vel_loss(trans, markers, frame_valid: Optional[torch.Tensor] = None):
    """Translation velocity [L, F, 3] vs marker-centroid velocity."""
    trans_vel = trans[:, 1:] - trans[:, :-1]
    mm = markers.mean(dim=-2)
    markers_vel = mm[..., 1:, :] - mm[..., :-1, :]
    if frame_valid is None:
        return mse(trans_vel, markers_vel)
    return _masked_mean((trans_vel - markers_vel) ** 2, _vel_mask(frame_valid))


def root_orient_vel_loss(z_root_orient, root_orient, frame_valid: Optional[torch.Tensor] = None):
    """Frame-to-frame root angular speed before/after the yaw offset:
    z_root_orient [L, F, 1, 3, 3], root_orient [(L,) F, 1, 3, 3]."""
    vel_ref = rot.so3_relative_angle(root_orient[..., 1:, 0, :, :], root_orient[..., :-1, 0, :, :])
    vel_new = rot.so3_relative_angle(z_root_orient[:, 1:, 0], z_root_orient[:, :-1, 0])
    vel_ref = vel_ref.expand(vel_new.shape)
    if frame_valid is None:
        return mse(vel_new, vel_ref)
    return _masked_mean((vel_new - vel_ref) ** 2, _vel_mask(frame_valid))


def temporal_loss(pose_body, frame_valid: Optional[torch.Tensor] = None):
    """Second-difference smoothness on pose [L, F, 23, 3, 3] (the
    reference's expression t0 - 2*t1 - t2, reproduced verbatim)."""
    vel = pose_body[:, 2:] - 2 * pose_body[:, 1:-1] - pose_body[:, :-2]
    if frame_valid is None:
        return _per_lane_mean(vel ** 2)
    triple = frame_valid[..., 2:] * frame_valid[..., 1:-1] * frame_valid[..., :-2]
    return _masked_mean(vel ** 2, triple)


def full_chamfer_loss(markers, vertices, marker_weights, single_directional=True):
    """Weighted chamfer markers -> vertices [L, F, V, 3], plus the
    unweighted reverse mean when bidirectional (``losses.py:23-25``)."""
    return masked_chamfer(markers, vertices, marker_weights, single_directional, batch_dims=1)


def part_chamfer_loss(markers, vertices, marker_labels_mode, vertex_labels, part_ids,
                      single_directional, part_index=None):
    """Per-part chamfer of vertices [L, F, V, 3] against the part's markers
    (``losses.py:28-34``); ``part_index`` is ``part_vertex_index``'s
    precomputed gather of each part's vertices."""
    return chamfer_by_part(markers, vertices, marker_labels_mode, vertex_labels, part_ids,
                           marker_distance=MARKER_DISTANCE,
                           single_directional=single_directional, batch_dims=1,
                           part_index=part_index)


def _masked_or_mean(per: torch.Tensor, frame_valid: Optional[torch.Tensor]) -> torch.Tensor:
    return _per_lane_mean(per) if frame_valid is None else _masked_mean(per, frame_valid)


def ground_loss_joints(joints, frame_valid: Optional[torch.Tensor] = None):
    """Joints [L, F, J, 3] below the z = 0 ground plane."""
    return _masked_or_mean(torch.relu(-joints[..., 2]), frame_valid)


def ground_loss_vertices(vertices, frame_valid: Optional[torch.Tensor] = None):
    """Vertices [L, F, V, 3] below the ground plane (the part stage's form)."""
    return _masked_or_mean(torch.relu(-dense(vertices)[..., 2]), frame_valid)


_FEET = (10, 11)  # left and right foot joints


def foot_contact_loss(joints, foot_contacts, left_foot_id=_FEET[0], right_foot_id=_FEET[1],
                      target_height=0.005):
    """Feet held near the ground on contact frames: joints [L, F, J, 3],
    foot_contacts [(L,) F, 2]."""
    feet_z = joints[:, :, [left_foot_id, right_foot_id], 2]  # [L, F, 2]
    return _per_lane_mean((feet_z - target_height) ** 2 * foot_contacts)


def foot_velocity_loss(joints, foot_contacts, left_foot_id=_FEET[0], right_foot_id=_FEET[1]):
    """No foot skating on contact frames: the squared horizontal foot speed
    (through the reference's NaN-safe sqrt) weighted by the later frame's
    contact."""
    feet_xy = joints[:, :, [left_foot_id, right_foot_id], :2]  # [L, F, 2, 2]
    vel = feet_xy[:, 1:] - feet_xy[:, :-1]
    speed = torch.sqrt((vel * vel).sum(-1) + 1e-18)  # [L, F-1, 2]
    return _per_lane_mean(speed ** 2 * foot_contacts[..., 1:, :])


def velocity_loss(trans, markers_subset_mean, frame_valid: Optional[torch.Tensor] = None):
    """Translation velocity [L, F, 3] against the marker centroid's
    [(L,) F, 3] (the part stage's form)."""
    trans_vel = trans[:, 1:] - trans[:, :-1]
    m_vel = markers_subset_mean[..., 1:, :] - markers_subset_mean[..., :-1, :]
    if frame_valid is None:
        return mse(trans_vel, m_vel)
    return _masked_mean((trans_vel - m_vel) ** 2, _vel_mask(frame_valid))


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """KL divergence against soft targets, summed and divided by the batch
    size ``logits.shape[0]`` (a training loss, not per lane): entries whose
    target is 0 add nothing."""
    logp = torch.log_softmax(logits, dim=-1)
    per = torch.where(target_probs > 0, target_probs * (
        torch.log(torch.clamp_min(target_probs, 1e-12)) - logp), torch.zeros_like(logp))
    return per.sum() / logits.shape[0]


def weighted_mse(input, target, weights):
    """Per-lane mean of (input - target)^2 * weights."""
    return _per_lane_mean(((input - target) ** 2) * weights)


def line_segment_loss(points, markers, reduction: str = "mean"):
    """Distance of markers [(L,) F, M, 3] to the infinite line through each
    frame's segment, points [L, F, 2, 3] (endpoints); mean or sum per lane."""
    line = points[..., 0:1, :] - points[..., 1:2, :]  # [L, F, 1, 3]
    line_m = markers - points[..., 1:2, :]  # [L, F, M, 3]
    norm_line = torch.linalg.norm(line, dim=-1)  # [L, F, 1]
    cross = torch.linalg.cross(line.expand(line_m.shape), line_m, dim=-1)
    vals = torch.linalg.norm(cross, dim=-1) / torch.clamp_min(norm_line, 1e-12)
    return _per_lane_mean(vals) if reduction == "mean" else vals.flatten(1).sum(-1)
