"""Loss terms of the shipped config (counterpart of
``uuo_mocap_tpu/solver/losses.py``).

Every term is per lane: its first argument carries a leading lane axis
[L, ...], the other arguments are either lane-batched too or shared
(broadcast over lanes), and the result is [L].  The reference computes the
same scalars one lane at a time under ``vmap``.
"""
from __future__ import annotations

from typing import Optional

import torch

from uuo_mocap_tpu_torch.ops import rotations as rot
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
    """[F] validity -> [F-1] velocity-pair validity (both frames real)."""
    return frame_valid[1:] * frame_valid[:-1]


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-lane mean of ``values`` [L, F', ...] over entries whose frame
    mask [F'] is > 0."""
    m = mask.reshape(mask.shape + (1,) * (values.dim() - 2)).expand(values.shape[1:])
    num = (values * m).flatten(1).sum(-1)
    return num / torch.clamp_min(m.sum(), 1e-12)


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
    triple = frame_valid[2:] * frame_valid[1:-1] * frame_valid[:-2]
    return _masked_mean(vel ** 2, triple)
