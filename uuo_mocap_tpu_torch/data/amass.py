"""AMASS-backed training datasets and preprocessing (counterpart of
``uuo_mocap_tpu/data/amass.py``).

``preprocess_amass_npz`` turns a raw AMASS npz into a 30 Hz processed npz
with foot contacts; ``DatasetMocap`` yields windows of SMPL motion with
virtual surface markers, rotated and shifted at random; ``DatasetSMPLHMotion``
yields the motion alone.  AMASS is licensed, so the datasets read
user-supplied processed files; without them they generate procedural
motions, with the same sample schema.  The random draws use numpy
``RandomState`` in the reference's order.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward
from uuo_mocap_tpu_torch.data.synthetic import random_pose_sequence
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.pipeline.stages import SmplParams
from uuo_mocap_tpu_torch.settings import MARKER_DISTANCE
from uuo_mocap_tpu_torch.utils.foot_contact import compute_foot_contacts

# AMASS sub-datasets of each split
SPLITS = {
    "train": ["ACCAD", "BioMotionLab_NTroje", "BMLmovi", "EKUT", "Eyes_Japan_Dataset", "KIT",
              "MPI_Limits"],
    "valid": ["SFU", "BMLhandball"],
}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def preprocess_amass_npz(src: str, dst: str, target_freq: float = 30.0,
                         body: Optional[BodyModel] = None) -> str:
    """Raw AMASS npz -> processed npz: subsampled to ``target_freq``,
    float32, and with ``body`` the foot contacts of its SMPL forward."""
    data = np.load(src, allow_pickle=True)
    freq = float(data.get("mocap_framerate", data.get("mocap_frame_rate", 120.0)))
    stride = max(int(round(freq / target_freq)), 1)
    poses = np.asarray(data["poses"], np.float32)[::stride]
    trans = np.asarray(data["trans"], np.float32)[::stride]
    betas = np.asarray(data["betas"], np.float32)[:10]
    out = {
        "poses": poses,
        "trans": trans,
        "betas": betas,
        "mocap_frame_rate": target_freq,
        "gender": str(data.get("gender", "neutral")),
    }
    if body is not None:
        F = poses.shape[0]
        dev = body.device
        mats = rot.axis_angle_to_matrix(torch.as_tensor(poses[:, :24 * 3].reshape(F, 24, 3),
                                                        device=dev))
        with torch.no_grad():
            joints = lbs_forward(body, mats[:, 1:], torch.as_tensor(betas, device=dev)[None],
                                 mats[:, :1], torch.as_tensor(trans, device=dev))["joints"]
        out["foot_contacts"] = compute_foot_contacts(_numpy(joints)[None, :, :22])[0]
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    np.savez(dst, **out)
    return dst


# ------------------------------------------------------------- augmentations
def apply_random_rotation_to_pos(pos: np.ndarray, rng: np.random.RandomState
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """A random yaw about the mocap frame's up axis (z) -> (rotated, R)."""
    angle = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return pos @ R.T, R


def apply_random_translation_to_pos(pos: np.ndarray, rng: np.random.RandomState,
                                    scale: float = 1.0) -> np.ndarray:
    """A random horizontal shift within ``scale`` metres."""
    offset = rng.uniform(-scale, scale, 3).astype(np.float32)
    offset[2] = 0.0
    return pos + offset


def world_to_local_pos(pos: np.ndarray, root_pos: np.ndarray) -> np.ndarray:
    """Centre a point stream [F, N, 3] on the root trajectory [F, 3]."""
    return pos - root_pos[:, None, :]


class DatasetMocap:
    """Windows of SMPL motion with virtual markers.

    ``amass_dir`` holds processed files as <amass_dir>/<sub_dataset>/
    <subject>/<seq>.npz, the sub-datasets of ``split``.  Without it, each
    sample is a procedural motion.
    """

    def __init__(self, body: BodyModel, amass_dir: Optional[str] = None, split: str = "train",
                 sequence_length: int = 32, stride: int = 4, num_markers: int = 41,
                 seed: int = 0):
        self.body = body
        self.sequence_length = sequence_length
        self.stride = stride
        self.num_markers = num_markers
        self.rng = np.random.RandomState(seed)
        self.vertex_labels = _numpy(body.vertex_part_labels())

        self.files: List[str] = []
        if amass_dir is not None and os.path.isdir(amass_dir):
            for sub in SPLITS.get(split, []):
                sub_dir = os.path.join(amass_dir, sub)
                if not os.path.isdir(sub_dir):
                    continue
                for root, _dirs, files in os.walk(sub_dir):
                    self.files += [os.path.join(root, f) for f in files if f.endswith(".npz")]
        self.files.sort()

    def _load_params(self, index: int) -> SmplParams:
        dev = self.body.device
        if not self.files:
            return random_pose_sequence(self.sequence_length,
                                        seed=int(self.rng.randint(1 << 30)), device=dev)
        span = self.sequence_length * self.stride
        data = np.load(self.files[index % len(self.files)])
        poses = np.asarray(data["poses"], np.float32)
        F = poses.shape[0]
        start = self.rng.randint(0, max(F - span, 1))
        sel = slice(start, min(start + span, F), self.stride)
        mats = rot.axis_angle_to_matrix(torch.as_tensor(
            poses[sel, :24 * 3].reshape(-1, 24, 3), device=dev))
        betas = torch.as_tensor(np.asarray(data["betas"], np.float32)[:10][None], device=dev)
        trans = torch.as_tensor(np.asarray(data["trans"], np.float32)[sel], device=dev)
        return SmplParams(mats[:, 1:], betas, mats[:, :1], trans)

    def compute_markers(self, params: SmplParams) -> Dict[str, np.ndarray]:
        """Markers at random barycentric surface points, pushed out along
        their face's normal by MARKER_DISTANCE; each labelled with its face's
        first vertex's part."""
        with torch.no_grad():
            out = lbs_forward(self.body, params.pose_body, params.betas, params.root_orient,
                              params.trans)
        verts = _numpy(out["vertices"])  # [F, V, 3]
        faces = self.body.faces
        fidx = self.rng.randint(0, faces.shape[0], self.num_markers)
        bary = self.rng.dirichlet((1.0, 1.0, 1.0), size=self.num_markers).astype(np.float32)
        tri = verts[:, faces[fidx]]  # [F, M, 3 corners, 3]
        pts = np.einsum("mk,fmkd->fmd", bary, tri)
        n = np.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        return {
            "markers": (pts + n * MARKER_DISTANCE).astype(np.float32),
            "marker_labels": self.vertex_labels[faces[fidx][:, 0]],
            "joints": _numpy(out["joints"][:, :22]),
        }

    def __len__(self) -> int:
        return len(self.files) if self.files else 1 << 16

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        sample = self.compute_markers(self._load_params(index))
        markers, _ = apply_random_rotation_to_pos(sample["markers"], self.rng)
        sample["markers"] = apply_random_translation_to_pos(markers, self.rng)
        return sample


class DatasetSMPLHMotion:
    """Windows of SMPL motion alone (every frame, no markers)."""

    def __init__(self, body: BodyModel, amass_dir: Optional[str] = None, split: str = "train",
                 sequence_length: int = 64, seed: int = 0):
        self.inner = DatasetMocap(body, amass_dir, split, sequence_length, stride=1, seed=seed)

    def __len__(self) -> int:
        return len(self.inner)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        params = self.inner._load_params(index)
        return {k: _numpy(getattr(params, k))
                for k in ("pose_body", "root_orient", "trans", "betas")}
