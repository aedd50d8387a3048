"""Monocular-video SMPL prior container (counterpart of
``uuo_mocap_tpu/data/img_smpl.py:ImgSmpl``): the array constructor and
``from_params``.  Parsing 4D-Humans/PHALP ``.pkl`` files is not ported yet."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# HMR camera frame -> mocap frame (z-up): x, z, -y
CORRECTION_MATRIX = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class ImgSmpl:
    """Fields (numpy): trans [F, 3], root_orient [F, 1, 3, 3] (mocap frame),
    hmr_root_orient [F, 1, 3, 3], pose_body [F, 23, 3, 3], betas [F, 10],
    img_mask [F] bool, camera_bbox [F, 3], center [F, 2], scale [F, 1],
    size [F, 2], foot_contacts [F, 2], freq."""

    def __init__(self, data=None, freq: float = 30.0, **arrays):
        if data is not None:
            raise NotImplementedError(
                "parsing 4D-Humans/PHALP pkl priors is not ported yet (a later slice)")
        self.freq = freq
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
