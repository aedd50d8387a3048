"""Foot-contact detection heuristics (a copy of the host-side numpy in
``uuo_mocap_tpu/utils/foot_contact.py``):
  * 3D joints: 10th-percentile floor height + 5 cm band x savgol-smoothed
    speed < 5 mm/frame;
  * 2D toe speed from the HMR 2D joints of a 4D-Humans pkl.
"""
from __future__ import annotations

import numpy as np

LEFT_FOOT = 10
RIGHT_FOOT = 11

# 45-joint 2D layout used by 4D-Humans demo pkls (reference
# ``utils/img_smpl_utils.py:4-50``); only the entries we consume.
JOINTS_2D = {
    "pelvis_low": 8,
    "l_toe_in": 19,
    "l_toe_out": 20,
    "r_toe_in": 22,
    "r_toe_out": 23,
}


def compute_foot_contacts(joints: np.ndarray) -> np.ndarray:
    """[N, F, J, 3] joints -> [N, F, 2] left/right contact flags."""
    from scipy.signal import savgol_filter

    left = joints[:, :, LEFT_FOOT, :]  # [N, F, 3]
    right = joints[:, :, RIGHT_FOOT, :]

    floor = min(np.percentile(left[..., 2], 10), np.percentile(right[..., 2], 10))
    height_threshold = 0.05
    # NOTE: the reference heights-masks on axis 1 while flooring on axis 2
    # (utils/foot_contact.py:46-47); we use the up-axis (2, mocap frame)
    # consistently for both.
    l_h = (left[..., 2] <= floor + height_threshold).astype(float)
    r_h = (right[..., 2] <= floor + height_threshold).astype(float)

    def speed(foot):
        vel = np.concatenate([np.zeros_like(foot[:, :1]), np.diff(foot, axis=1)], axis=1)
        s = np.linalg.norm(vel, axis=-1)
        win = min(7, s.shape[1] if s.shape[1] % 2 == 1 else s.shape[1] - 1)
        if win >= 5:
            s = savgol_filter(s, win, 3, axis=1)
        return s

    vel_threshold = 0.005
    l_v = (speed(left) <= vel_threshold).astype(float)
    r_v = (speed(right) <= vel_threshold).astype(float)
    return np.stack([l_h * l_v, r_h * r_v], axis=-1)


def foot_contacts_from_2d(joints_2d: np.ndarray, freq: float) -> np.ndarray:
    """[F, 45, 2] 2D joints -> [F, 2] contacts, from toe speeds normalized by
    the skeleton's 2D extent (reference ``img_smpl_utils.py:54-91``)."""
    F = joints_2d.shape[0]
    min_xy = joints_2d.min(axis=1)
    max_xy = joints_2d.max(axis=1)
    extent = np.sqrt(((max_xy - min_xy) ** 2).sum(-1))
    extent = np.maximum(extent, 0.01)
    threshold = 0.0001 / extent  # [F]

    vel = np.concatenate([np.zeros((1,) + joints_2d.shape[1:]), np.diff(joints_2d, axis=0)], axis=0) / freq
    speed = np.linalg.norm(vel, axis=-1)  # [F, 45]
    contact = speed < threshold[:, None]

    out = np.ones((F, 2))
    for g, keys in enumerate((("l_toe_in", "l_toe_out"), ("r_toe_in", "r_toe_out"))):
        for k in keys:
            out[:, g] *= contact[:, JOINTS_2D[k]]
    return out
