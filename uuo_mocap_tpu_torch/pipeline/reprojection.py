"""Camera-aware rotational alignment, the reprojection stage (counterpart of
``uuo_mocap_tpu/pipeline/reprojection.py``; the paper's ``hmr_utils.py:
170-425``): a global yaw about the camera's y axis, per-frame body
translations, one camera translation and betas, fitted jointly to (a) the
2D reprojection error against the prior's own projected joints and (b) the
single-directional chamfer against the markers in the mocap frame.

One L-BFGS problem per lane (``solver/lbfgs.lbfgs_minimize``, batched): a
lane is a yaw seed of one sequence (``__call__``) or a sequence x seed pair
(``lanes``), and a lane that stops is frozen while the others run on, as
under the reference's ``vmap`` of its minimizer; each evaluation runs only
the lanes still running.  The chamfer term runs ``masked_chamfer``: on the
card, the few-query forward kernel and, for its gradient, the backward
kernel.  Both medians of the initial placement
(over every marker of the sequence, zero-filled occluded ones included,
and over the frames' body translations) are numpy's (``ops.geometry.
median``): ``torch.median`` would take the lower middle value.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward
from uuo_mocap_tpu_torch.camera.hmr import (
    convert_hmr_pos_to_mocap_pos, convert_mocap_pos_to_hmr_pos, get_3d_parameters,
    perspective_projection)
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.ops.chamfer import masked_chamfer
from uuo_mocap_tpu_torch.ops.geometry import median
from uuo_mocap_tpu_torch.solver.lbfgs import LbfgsOptions, lbfgs_minimize

# camera frame (y-up) -> mocap frame (z-up) (``reprojection.py:32``)
CORRECTION = ((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, -1.0, 0.0))


class ReprojectionStage:
    """The stage under ``config["stages"][stage_key]``: its ``num_iters``
    and its ``reprojection`` and ``chamfer`` loss weights."""

    def __init__(self, model: BodyModel, config: Dict[str, Any],
                 stage_key: str = "reprojection_part"):
        self.model = model
        self.config = config
        self.stage_key = stage_key
        self.last_result = None  # the last call's LbfgsResult, one row per lane

    @functools.cached_property
    def _opts(self) -> LbfgsOptions:
        cfg = self.config
        return LbfgsOptions(
            max_iter=int(cfg["stages"][self.stage_key]["num_iters"]),
            tolerance_grad=float(cfg["optimizer"]["tolerance_grad"]),
            tolerance_change=float(cfg["optimizer"]["tolerance_change"]),
            history_size=int(cfg["optimizer"].get("history_size", 10)))

    def _fwd(self, pose, betas, root, trans):
        return lbs_forward(self.model, pose, betas, root, trans)

    def lanes(self, angles_l, markers_l, weights_l, o_pose_l, betas0_l, hmr_betas_l, hmr_root_l,
              trans0_l, pred_cam_l, cam_center_l, cam_size_l, cam_scale_l,
              img_mask_l) -> Dict[str, Any]:
        """Every argument carries the lane axis: yaw seeds [L], markers
        [L, F, M, 3], marker weights [L, F, M], the prior's body pose
        [L, F, 23, 3, 3], betas [L, 1, 10], the prior's per-frame betas
        [L, F, 10] and camera-frame root [L, F, 1, 3, 3], translations
        [L, F, 3] (mocap frame), the crop camera [L, F, 3], bbox centre
        [L, F, 2], image size [L, F, 2], bbox scale [L, F, 1], image mask
        [L, F].  -> per lane: betas [L, F, 10], root_orient [L, F, 1, 3, 3]
        and trans [L, F, 3] in the mocap frame, the camera, the 2D joints
        and ``metrics`` {chamfer, reproject} [L] (``reprojection.py:
        55-160``)."""
        scfg = self.config["stages"][self.stage_key]
        w_reproj = float(scfg["losses"]["reprojection"])
        w_chamfer = float(scfg["losses"]["chamfer"])
        L, F = o_pose_l.shape[:2]
        dt, dev = markers_l.dtype, markers_l.device
        correction = torch.tensor(CORRECTION, dtype=dt, device=dev)

        with torch.no_grad():
            cams = get_3d_parameters(self._fwd, hmr_betas_l, o_pose_l, hmr_root_l, pred_cam_l,
                                     cam_center_l, cam_size_l, cam_scale_l)
        gt_2d = torch.nan_to_num(cams["pred_keypoints_2d_smpl"], nan=0.0)  # [L, F, 45, 2]
        cam_t = cams["pred_cam_t"]  # [L, F, 3]
        reproject_mask = torch.isfinite(cam_t).to(dt).mean(-1) * img_mask_l  # [L, F]
        cam_t = torch.nan_to_num(cam_t, nan=0.0)
        focal = cams["focal_length"].mean(dim=-2, keepdim=True)  # [L, 1, 2]
        camera_center = cams["camera_center"]  # [L, F, 2]

        # the body moves to the crop camera's per-frame offsets, the camera to
        # the body's marker-space place (``reprojection.py:84-92``)
        markers_med = median(markers_l.reshape(L, -1, 3), dim=1)[:, None]  # [L, 1, 3]
        offset = convert_mocap_pos_to_hmr_pos(markers_med) - median(cam_t, dim=1)[:, None]
        params0 = {"y_angle": angles_l.to(dt).reshape(L, 1), "body_trans": cam_t + offset,
                   "cam_trans": (trans0_l - offset).mean(dim=1, keepdim=True),
                   "betas": betas0_l}

        def world_state(p, rows):
            """The lanes ``rows`` in the mocap frame; ``p`` holds their rows."""
            y = p["y_angle"].reshape(-1, 1, 1)
            y_root = rot.rot_y(y[:, None].expand(-1, F, 1, 1)) @ hmr_root_l[rows]
            return correction @ y_root, convert_hmr_pos_to_mocap_pos(p["body_trans"]), y

        def errors(p, rows):
            """(reprojection error, chamfer) of the lanes ``rows``, and their
            2D joints; ``p`` holds those lanes' parameters."""
            R = rows.shape[0]
            betas_f = p["betas"].expand(R, F, 10)
            world_root, world_trans, y = world_state(p, rows)
            # the body turned about the camera, for the projection
            cam_trans_f = p["cam_trans"].expand(R, F, 3)
            inv_trans = rot.apply_rotation(rot.rot_y(-y), p["body_trans"] - cam_trans_f) + cam_trans_f
            joints = self._fwd(o_pose_l[rows], betas_f, hmr_root_l[rows], inv_trans)["joints"]
            kp2d = perspective_projection(joints, cam_trans_f, focal[rows].expand(R, F, 2),
                                          camera_center[rows]) + 0.5
            reproj = (((kp2d - gt_2d[rows]) ** 2)
                      * reproject_mask[rows][..., None, None]).flatten(1).mean(-1)
            verts = self._fwd(o_pose_l[rows], betas_f, world_root, world_trans)["vertices"]
            cham = masked_chamfer(markers_l[rows], verts, weights_l[rows],
                                  single_directional=True, batch_dims=1)
            return reproj, cham, kp2d

        def loss(p, rows):
            reproj, cham, _ = errors(p, rows)
            return reproj * w_reproj + cham * w_chamfer

        p_opt, self.last_result = lbfgs_minimize(loss, params0, self._opts, batched=True)
        every = torch.arange(L, device=dev)
        with torch.no_grad():
            reproj_err, cham_err, kp2d = errors(p_opt, every)
            world_root, world_trans, _ = world_state(p_opt, every)
        return {
            "betas": p_opt["betas"].expand(L, F, 10),
            "root_orient": world_root,
            "trans": world_trans,
            "cam_trans": convert_hmr_pos_to_mocap_pos(p_opt["cam_trans"].expand(L, F, 3)),
            "joints_2d": kp2d,
            "joints_2d_gt": gt_2d,
            "focal_length": focal,
            "camera_center": camera_center,
            "reproject_mask": reproject_mask,
            "output_angle": p_opt["y_angle"],
            "metrics": {"chamfer": cham_err, "reproject": reproj_err},
        }

    def __call__(self, angles, markers, marker_weights, o_pose_body, betas0, hmr_betas,
                 hmr_root_orient, trans0, pred_cam, cam_center, cam_size, cam_scale, img_mask):
        """Every yaw seed ``angles`` [A] of one sequence at once -> the
        outputs of ``lanes`` with a leading A axis (``reprojection.py:
        182-189``)."""
        A = angles.shape[0]

        def tile(x):
            return x[None].expand((A,) + x.shape)

        return self.lanes(angles, *(tile(x) for x in (
            markers, marker_weights, o_pose_body, betas0, hmr_betas, hmr_root_orient, trans0,
            pred_cam, cam_center, cam_size, cam_scale, img_mask)))
