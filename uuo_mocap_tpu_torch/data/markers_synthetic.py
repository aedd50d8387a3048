"""Synthetic marker containers with the ``Markers`` interface (counterpart
of ``uuo_mocap_tpu/data/markers_synthetic.py``): random surface markers, and
named-layout markers at known vertex ids with optional part filtering.
Motion comes from an AMASS npz when one is given, else from the procedural
generator.  The markers are made on the model's device and kept as numpy.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.joints import SMPL_LIMBS
from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward
from uuo_mocap_tpu_torch.data.marker_layout import (
    compute_marker_labels_from_layout, compute_markers_from_layout, resolve_layout_vertex_ids)
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.data.synthetic import generate_markers, random_pose_sequence
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.pipeline.stages import SmplParams


def _params_from_amass(npz_path: str, device) -> Tuple[SmplParams, float]:
    """An AMASS-processed npz (poses [F, 66+], betas, trans,
    mocap_frame_rate) -> (SmplParams on ``device``, frame rate)."""
    data = np.load(npz_path)
    poses = np.asarray(data["poses"], np.float32)
    F = poses.shape[0]
    mats = rot.axis_angle_to_matrix(torch.as_tensor(poses[:, : 24 * 3].reshape(F, 24, 3),
                                                    device=device))
    betas = torch.as_tensor(np.asarray(data["betas"], np.float32)[:10][None], device=device)
    trans = torch.as_tensor(np.asarray(data["trans"], np.float32), device=device)
    freq = float(data["mocap_frame_rate"]) if "mocap_frame_rate" in data else 30.0
    return SmplParams(mats[:, 1:], betas, mats[:, :1], trans), freq


def _motion(model: BodyModel, amass_npz: Optional[str], num_frames: int, seed: int,
            freq: float) -> Tuple[SmplParams, float]:
    if amass_npz is not None:
        return _params_from_amass(amass_npz, model.device)
    return random_pose_sequence(num_frames, seed=seed, device=model.device), freq


class MarkersSynthetic(ArrayMarkers):
    """Virtual markers at random surface vertices."""

    def __init__(self, model: BodyModel, amass_npz: Optional[str] = None, num_frames: int = 150,
                 num_markers: int = 41, seed: int = 0, freq: float = 30.0,
                 occlusion_rate: float = 0.0, shuffle: bool = False):
        params, freq = _motion(model, amass_npz, num_frames, seed, freq)
        mk = generate_markers(model, params, num_markers=num_markers, seed=seed, freq=freq,
                              occlusion_rate=occlusion_rate, shuffle=shuffle)
        super().__init__(mk.points.cpu().numpy(), freq=freq)
        self.gt_params = params
        self.vertex_ids = mk.vertex_ids


class MarkersSyntheticStructured(ArrayMarkers):
    """Virtual markers of a named layout, optionally only those on the
    limbs named in ``parts`` (keys of ``SMPL_LIMBS``)."""

    def __init__(self, model: BodyModel, layout: str = "cmu_41", amass_npz: Optional[str] = None,
                 num_frames: int = 150, seed: int = 0, freq: float = 30.0,
                 parts: Optional[List[str]] = None, vid_table=None, shuffle: bool = False):
        params, freq = _motion(model, amass_npz, num_frames, seed, freq)
        with torch.no_grad():
            verts = lbs_forward(model, params.pose_body, params.betas, params.root_orient,
                                params.trans)["vertices"]
            vids = resolve_layout_vertex_ids(layout, model, vid_table)
            points = compute_markers_from_layout(verts, model.faces, vids)["marker_pos"]
        points = points.cpu().numpy()
        labels = compute_marker_labels_from_layout(vids, model.lbs_weights).cpu().numpy()

        if parts:
            keep_joints = set()
            for p in parts:
                keep_joints.update(SMPL_LIMBS[p])
            keep = np.asarray([l in keep_joints for l in labels])
            points, vids, labels = points[:, keep], vids[keep], labels[keep]

        if shuffle:
            rng = np.random.RandomState(seed)
            for f in range(points.shape[0]):
                points[f] = points[f, rng.permutation(points.shape[1])]

        super().__init__(points, freq=freq)
        self.gt_params = params
        self.vertex_ids = vids
        self.marker_labels = labels
