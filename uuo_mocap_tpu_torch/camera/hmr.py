"""HMR 2.0 crop camera and projection (counterpart of
``uuo_mocap_tpu/camera/hmr.py``): the weak-perspective crop camera turned
into a full-frame pinhole camera (focal length 5000 at a 256-pixel crop),
perspective projection, and the swap between HMR's y-up camera frame and
the z-up mocap frame.  Every function takes any number of leading dims, so
the reprojection stage's lanes pass through unchanged.

The reference's arithmetic is kept: a depth below 1e-9 in magnitude is
replaced by +1e-9 whatever its sign, the square-pad offsets are floor
divisions of float sizes, and the pad side is rounded half to even
(``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

FOCAL_LENGTH = 5000.0
IMG_SIZE = 256.0


def perspective_projection(points: torch.Tensor, translation: torch.Tensor,
                           focal_length: torch.Tensor,
                           camera_center: Optional[torch.Tensor] = None,
                           rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pinhole projection: points [..., N, 3], translation [..., 3], focal
    length [..., 2], camera center [..., 2], rotation [..., 3, 3]
    -> [..., N, 2] (``hmr.py:22-39``)."""
    if rotation is not None:
        points = points @ rotation.transpose(-1, -2)
    points = points + translation[..., None, :]
    z = points[..., 2:3]
    projected = points[..., :2] / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    projected = projected * focal_length[..., None, :]
    if camera_center is not None:
        projected = projected + camera_center[..., None, :]
    return projected


def get_3d_parameters(smpl_inference: Callable[..., Dict[str, torch.Tensor]],
                      pred_smpl_betas: torch.Tensor, pred_smpl_body_pose: torch.Tensor,
                      pred_smpl_global_orient: torch.Tensor, pred_cam: torch.Tensor,
                      center: torch.Tensor, size: torch.Tensor,
                      scale: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Crop camera -> full-frame camera and the 2D joints it projects
    (``hmr.py:42-100``, from PHALP).  betas [..., F, 10], body pose
    [..., F, 23, 3, 3], global orient [..., F, 1, 3, 3] (camera frame),
    pred_cam [..., F, 3] (s, tx, ty), center [..., F, 2] (bbox centre in
    source pixels), size [..., F, 2] (source image h, w), scale [..., F, 1].
    ``smpl_inference(pose, betas, root, trans)`` returns a dict with
    ``joints``.  -> 2D keypoints in [0, 1] crop units, the full-frame camera
    translation ``pred_cam_t``, the normalized focal length, and more."""
    lead = pred_cam.shape[:-1]
    img_h, img_w = size[..., 0:1], size[..., 1:2]
    new_size = size.amax(dim=-1, keepdim=True)  # the square pad's side
    top = torch.div(new_size - img_h, 2, rounding_mode="floor")
    left = torch.div(new_size - img_w, 2, rounding_mode="floor")
    ratio = 1.0 / torch.round(new_size) * IMG_SIZE
    center_sq = (center + torch.cat([left, top], dim=-1)) * ratio
    scale_sq = scale * new_size * ratio
    focal = torch.full(lead + (2,), FOCAL_LENGTH, dtype=pred_cam.dtype, device=pred_cam.device)

    pred_joints = smpl_inference(pred_smpl_body_pose, pred_smpl_betas, pred_smpl_global_orient,
                                 torch.zeros(lead + (3,), dtype=pred_cam.dtype,
                                             device=pred_cam.device))["joints"]
    depth = 2.0 * focal[..., 0] / (pred_cam[..., 0] * scale_sq[..., 0] + 1e-9)
    cam_xy = pred_cam[..., 1:3] + (center_sq - IMG_SIZE / 2.0) * depth[..., None] / focal
    pred_cam_t = torch.cat([cam_xy, depth[..., None]], dim=-1)

    camera_center = torch.zeros_like(focal)
    kp2d = perspective_projection(pred_joints, pred_cam_t, focal / IMG_SIZE, camera_center)
    kp2d = (kp2d + 0.5) * IMG_SIZE
    eye = torch.eye(3, dtype=pred_cam.dtype, device=pred_cam.device)
    return {
        "camera_center": camera_center,
        "focal_length": focal / IMG_SIZE,
        "pred_cam_t": pred_cam_t,
        "pred_joints": pred_joints,
        "pred_keypoints_2d_smpl": kp2d / IMG_SIZE,
        "rotation": eye.expand(lead + (3, 3)),
    }


def convert_hmr_pos_to_mocap_pos(pos: torch.Tensor) -> torch.Tensor:
    """(x, y, z) camera -> (x, z, -y) mocap (``hmr.py:103-105``)."""
    return torch.stack([pos[..., 0], pos[..., 2], -pos[..., 1]], dim=-1)


def convert_mocap_pos_to_hmr_pos(pos: torch.Tensor) -> torch.Tensor:
    """(x, y, z) mocap -> (x, -z, y) camera (``hmr.py:108-110``)."""
    return torch.stack([pos[..., 0], -pos[..., 2], pos[..., 1]], dim=-1)
