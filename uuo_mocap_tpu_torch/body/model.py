"""SMPL body model and LBS forwards in PyTorch (counterpart of
``uuo_mocap_tpu/body/model.py``).

``BodyModel`` holds the model tensors on one device plus the derived
tensors both forwards reuse (flattened blend bases, the regressor
pre-contracted with the template and the shape basis).  ``lbs_forward`` is
the dense forward; ``lbs_forward_at`` evaluates the same pipeline only at
selected vertices, so its backward is O(M) instead of O(V).  All matmuls
run in full FP32 (``device.py`` switches TF32 off).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

import uuo_mocap_tpu_torch.device  # noqa: F401  (sets the FP32 matmul policy)

NUM_VERTICES = 6890
NUM_JOINTS = 24
NUM_BETAS = 10
NUM_POSE_JOINTS = NUM_JOINTS - 1

PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)

# surface joints appended after the 24 LBS joints (45 output joints)
EXTRA_JOINT_VERTEX_IDS = np.array(
    [332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624, 6787,
     2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016, 6133],
    dtype=np.int64,
)


def _tree_levels(parents: np.ndarray) -> List[List[int]]:
    """Joints grouped by depth in the kinematic tree (root level first)."""
    depth = np.zeros(len(parents), np.int64)
    for j in range(1, len(parents)):
        depth[j] = depth[int(parents[j])] + 1
    return [np.where(depth == d)[0].tolist() for d in range(int(depth.max()) + 1)]


class BodyModel:
    """SMPL model tensors on one device.

    v_template [V, 3], shapedirs [V, 3, 10], posedirs [207, V*3],
    j_regressor [24, V], lbs_weights [V, 24]; faces [T, 3] and parents [24]
    stay host numpy."""

    def __init__(self, v_template: torch.Tensor, shapedirs: torch.Tensor,
                 posedirs: torch.Tensor, j_regressor: torch.Tensor,
                 lbs_weights: torch.Tensor, faces: np.ndarray,
                 parents: np.ndarray = PARENTS):
        self.v_template = v_template
        self.shapedirs = shapedirs
        self.posedirs = posedirs
        self.j_regressor = j_regressor
        self.lbs_weights = lbs_weights
        self.faces = np.asarray(faces, np.int32)
        self.parents = np.asarray(parents, np.int32)
        V = v_template.shape[0]
        self.shapedirs_flat = shapedirs.reshape(V * 3, NUM_BETAS).T.contiguous()  # [10, V*3]
        # per-vertex pose-corrective rows [V, 3, 207], gathered by lbs_forward_at
        self.posedirs_v = posedirs.reshape(NUM_POSE_JOINTS * 9, V, 3).permute(1, 2, 0).contiguous()
        self.j_template = j_regressor @ v_template  # [24, 3]
        self.j_shapedirs = torch.einsum("jv,vdk->jdk", j_regressor, shapedirs)  # [24, 3, 10]
        self.levels = _tree_levels(self.parents)
        self.extra_joint_ids = torch.as_tensor(EXTRA_JOINT_VERTEX_IDS, device=v_template.device)

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    def vertex_part_labels(self) -> torch.Tensor:
        """argmax LBS weight per vertex -> joint id [V]."""
        return self.lbs_weights.argmax(dim=-1)


def _compose_kinematic_chain(rot_mats: torch.Tensor, joints_rest: torch.Tensor,
                             parents: np.ndarray, levels: List[List[int]]
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics, one batched 3x3 composition per tree level
    (``body/model.py:283-333``).

    rot_mats [..., 24, 3, 3], joints_rest [..., 24, 3] -> posed joints
    [..., 24, 3] and the rest-relative transforms A [..., 24, 3, 4]."""
    rm = rot_mats.unbind(-3)
    jr = joints_rest.unbind(-2)
    rel = [jr[0]] + [jr[j] - jr[int(parents[j])] for j in range(1, len(parents))]
    R: List[torch.Tensor] = [rm[0]] + [None] * (len(parents) - 1)
    t: List[torch.Tensor] = [rel[0]] + [None] * (len(parents) - 1)
    for level in levels[1:]:
        R_p = torch.stack([R[int(parents[j])] for j in level], dim=-3)
        t_p = torch.stack([t[int(parents[j])] for j in level], dim=-2)
        M = torch.stack([rm[j] for j in level], dim=-3)
        r = torch.stack([rel[j] for j in level], dim=-2)
        # elementwise 3x3 compose, as the reference (exact FP32)
        R_l = (R_p[..., :, :, None] * M[..., None, :, :]).sum(-2)
        t_l = t_p + (R_p * r[..., None, :]).sum(-1)
        for i, j in enumerate(level):
            R[j] = R_l[..., i, :, :]
            t[j] = t_l[..., i, :]
    R_w = torch.stack(R, dim=-3)
    t_w = torch.stack(t, dim=-2)
    t_rel = t_w - (R_w * joints_rest[..., None, :]).sum(-1)
    return t_w, torch.cat([R_w, t_rel[..., None]], dim=-1)


def _rot_mats(pose_body, root_orient, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    pose_body = pose_body.expand(batch + (NUM_POSE_JOINTS, 3, 3))
    root_orient = root_orient.expand(batch + (1, 3, 3))
    return pose_body, torch.cat([root_orient, pose_body], dim=-3)


def lbs_forward(model: BodyModel, pose_body: torch.Tensor, betas: torch.Tensor,
                root_orient: torch.Tensor, trans: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Dense SMPL forward (``body/model.py:336-410``), batched over the
    leading dims of ``trans``: pose_body [..., 23, 3, 3], betas [..., 10],
    root_orient [..., 1, 3, 3], trans [..., 3] (all broadcastable) ->
    {"joints" [..., 45, 3], "vertices" [..., V, 3]}."""
    batch = trans.shape[:-1]
    V = model.num_vertices
    betas = betas.expand(batch + (NUM_BETAS,))
    v_shaped = model.v_template + (betas.reshape(-1, NUM_BETAS) @ model.shapedirs_flat
                                   ).reshape(batch + (V, 3))
    joints_rest = model.j_regressor @ v_shaped  # [..., 24, 3]
    pose_body, rot_mats = _rot_mats(pose_body, root_orient, batch)

    eye = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (pose_body - eye).reshape(-1, NUM_POSE_JOINTS * 9)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(batch + (V, 3))

    posed_joints, A = _compose_kinematic_chain(rot_mats, joints_rest, model.parents, model.levels)
    T = (model.lbs_weights @ A.reshape(batch + (NUM_JOINTS, 12))).reshape(batch + (V, 3, 4))
    vx, vy, vz = v_posed[..., 0:1], v_posed[..., 1:2], v_posed[..., 2:3]
    verts = T[..., 0] * vx + T[..., 1] * vy + T[..., 2] * vz + T[..., 3]
    verts = verts + trans[..., None, :]
    posed_joints = posed_joints + trans[..., None, :]
    extra = verts.index_select(-2, model.extra_joint_ids)
    return {"joints": torch.cat([posed_joints, extra], dim=-2), "vertices": verts}


def lbs_forward_at(model: BodyModel, pose_body: torch.Tensor, betas: torch.Tensor,
                   root_orient: torch.Tensor, trans: torch.Tensor,
                   vertex_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """SMPL forward evaluated only at ``vertex_ids`` (``body/model.py:413-469``).

    ``vertex_ids`` [..., K] broadcasts against the batch dims of ``trans``.
    Rest joints come from the pre-contracted regressor, so no [V]-sized
    tensor appears and autograd's backward is O(K).
    -> {"points" [..., K, 3], "joints" [..., 24, 3]}."""
    batch = trans.shape[:-1]
    betas = betas.expand(batch + (NUM_BETAS,))
    joints_rest = model.j_template + torch.einsum("jdk,...k->...jd", model.j_shapedirs, betas)
    pose_body, rot_mats = _rot_mats(pose_body, root_orient, batch)
    posed_joints, A = _compose_kinematic_chain(rot_mats, joints_rest, model.parents, model.levels)

    v_shaped = model.v_template[vertex_ids] + torch.einsum(
        "...mdk,...k->...md", model.shapedirs[vertex_ids], betas)
    eye = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (pose_body - eye).reshape(batch + (NUM_POSE_JOINTS * 9,))
    v_posed = v_shaped + torch.einsum("...mdp,...p->...md", model.posedirs_v[vertex_ids],
                                      pose_feature)
    T = (model.lbs_weights[vertex_ids] @ A.reshape(batch + (NUM_JOINTS, 12)))
    T = T.reshape(T.shape[:-1] + (3, 4))
    points = (T[..., :3] @ v_posed[..., None])[..., 0] + T[..., 3]
    return {"points": points + trans[..., None, :], "joints": posed_joints + trans[..., None, :]}
