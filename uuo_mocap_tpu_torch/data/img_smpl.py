"""Monocular-video SMPL prior container (counterpart of
``uuo_mocap_tpu/data/img_smpl.py``).

Parses the per-frame dicts of a 4D-Humans/PHALP demo ``.pkl`` (read with
``data/pkl_io.load_pkl``), applies the HMR -> mocap axis correction,
slerp/lerp gap-fills untracked frames and derives foot contacts from 2D toe
speeds; ``from_params`` builds a synthetic prior.  Host-side: the fields are
numpy, and the rotation helpers run on CPU tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.utils.foot_contact import JOINTS_2D, foot_contacts_from_2d

# HMR camera frame -> mocap frame (z-up): x, z, -y
CORRECTION_MATRIX = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class ImgSmpl:
    """Fields (numpy): trans [F, 3], root_orient [F, 1, 3, 3] (mocap frame),
    hmr_root_orient [F, 1, 3, 3], pose_body [F, 23, 3, 3], betas [F, 10],
    img_mask [F] bool, camera_bbox [F, 3], center [F, 2], scale [F, 1],
    size [F, 2], foot_contacts [F, 2], freq."""

    def __init__(self, data: Optional[Dict[Any, Any]] = None, freq: float = 30.0, **arrays):
        self.freq = freq
        if data is not None:
            self._parse_phalp(data)
            return
        for k, v in arrays.items():
            setattr(self, k, v)
        F = self.trans.shape[0]
        if not hasattr(self, "img_mask"):
            self.img_mask = np.ones(F, bool)
        if not hasattr(self, "foot_contacts"):
            self.foot_contacts = np.zeros((F, 2), np.float32)
        for name, shape in (("camera_bbox", (F, 3)), ("center", (F, 2)),
                            ("scale", (F, 1)), ("size", (F, 2))):
            if not hasattr(self, name):
                setattr(self, name, np.zeros(shape, np.float32))
        if not hasattr(self, "hmr_root_orient"):
            # invert the axis correction to fabricate a camera-frame root
            self.hmr_root_orient = np.einsum("ij,fajk->faik", CORRECTION_MATRIX.T,
                                             self.root_orient)

    def _parse_phalp(self, data: Dict[Any, Any]) -> None:
        """A 4D-Humans demo pkl: a dict keyed by frame path, each frame with
        ``smpl``, ``3d_joints``, ``2d_joints``, ``camera_bbox``, ``center``,
        ``scale``, ``size`` and ``tracked_ids`` (``img_smpl.py:55-100``)."""
        keys = sorted(data.keys())
        F = len(keys)
        trans = np.zeros((F, 3), np.float32)
        root = np.zeros((F, 1, 3, 3), np.float32)
        hmr_root = np.zeros((F, 1, 3, 3), np.float32)
        pose = np.zeros((F, 23, 3, 3), np.float32)
        betas = np.zeros((F, 10), np.float32)
        self.camera_bbox = np.zeros((F, 3), np.float32)
        self.center = np.zeros((F, 2), np.float32)
        self.scale = np.zeros((F, 1), np.float32)
        self.size = np.zeros((F, 2), np.float32)
        mask = np.zeros(F, bool)
        joints_2d = np.zeros((F, 45, 2), np.float32)

        for f, key in enumerate(keys):
            frame = data[key]
            if len(frame.get("tracked_ids", [])) > 0:
                mask[f] = True
                go = np.asarray(frame["smpl"][0]["global_orient"], np.float32).reshape(1, 3, 3)
                hmr_root[f] = go
                root[f] = CORRECTION_MATRIX @ go
                trans[f] = np.asarray(frame["3d_joints"][0][JOINTS_2D["pelvis_low"]], np.float32)
                pose[f] = np.asarray(frame["smpl"][0]["body_pose"], np.float32).reshape(23, 3, 3)
                betas[f] = np.asarray(frame["smpl"][0]["betas"], np.float32)
            if len(frame.get("camera_bbox", [])) > 0:
                self.camera_bbox[f] = np.asarray(frame["camera_bbox"][0], np.float32)
                self.center[f] = np.asarray(frame["center"][0], np.float32)
                self.scale[f] = np.ravel(np.asarray(frame["scale"][0], np.float32))[:1]
                self.size[f] = np.asarray(frame["size"][0], np.float32)
            j2d = frame.get("2d_joints")
            if j2d is not None and len(j2d) > 0:
                flat = np.ravel(np.asarray(j2d[0], np.float32))
                n = min(45, flat.shape[0] // 2)
                joints_2d[f, :n] = flat[: n * 2].reshape(n, 2)

        self.img_mask = mask
        self.trans, self.root_orient, self.hmr_root_orient, self.pose_body, self.betas = (
            self._gap_fill(trans, root, hmr_root, pose, betas, mask))
        self.foot_contacts = foot_contacts_from_2d(joints_2d, self.freq).astype(np.float32)

    @staticmethod
    def _gap_fill(trans, root, hmr_root, pose, betas, mask):
        """Slerp rotations and lerp vectors across untracked gaps; repeat the
        nearest tracked frame at the ends (``img_smpl.py:102-130``)."""
        valid = np.where(mask)[0]
        if valid.size == 0:
            return trans, root, hmr_root, pose, betas
        for f in range(trans.shape[0]):
            if mask[f]:
                continue
            left = valid[valid < f]
            right = valid[valid > f]
            if left.size == 0 or right.size == 0:
                src = right[0] if left.size == 0 else left[-1]
                for arr in (trans, root, hmr_root, pose, betas):
                    arr[f] = arr[src]
                continue
            l, r = left[-1], right[0]
            a = (f - l) / (r - l)
            trans[f] = trans[l] * (1 - a) + trans[r] * a
            betas[f] = betas[l] * (1 - a) + betas[r] * a
            for arr in (root, hmr_root, pose):
                arr[f] = rot.matrix_slerp(torch.as_tensor(arr[l]), torch.as_tensor(arr[r]),
                                          a).numpy()
        return trans, root, hmr_root, pose, betas

    def get_smpl(self) -> Dict[str, np.ndarray]:
        """The prior in the ``*_stageii.npz`` schema (``img_smpl.py:134-145``)."""
        poses_mat = np.concatenate([self.root_orient, self.pose_body], axis=1)  # [F, 24, 3, 3]
        poses_aa = rot.matrix_to_axis_angle(torch.as_tensor(poses_mat)).numpy()
        return {
            "betas": self.betas[0],
            "gender": np.array("neutral"),
            "mocap_frame_rate": self.freq,
            "poses": poses_aa.reshape(poses_aa.shape[0], -1),
            "trans": self.trans,
        }

    @classmethod
    def from_params(cls, params, freq: float = 30.0, img_mask: Optional[np.ndarray] = None,
                    foot_contacts: Optional[np.ndarray] = None) -> "ImgSmpl":
        """Synthetic prior from SmplParams (tensors or numpy)."""
        F = params.trans.shape[0]
        return cls(
            data=None,
            freq=freq,
            trans=_numpy(params.trans),
            root_orient=_numpy(params.root_orient),
            pose_body=_numpy(params.pose_body),
            betas=np.broadcast_to(_numpy(params.betas), (F, 10)).copy(),
            img_mask=np.ones(F, bool) if img_mask is None else img_mask,
            foot_contacts=np.zeros((F, 2), np.float32) if foot_contacts is None else foot_contacts,
        )
