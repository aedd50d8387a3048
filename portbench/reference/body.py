"""Plain PyTorch body model of the benchmark: the synthetic SMPL-format
arrays and linear blend skinning, written out step by step.

``build_arrays`` and the helpers above it are a frozen copy of
``uuo_mocap_tpu_torch/body/synthetic.py`` (``_REST_JOINTS`` to
``_build_arrays``, commit 1ed4835), with the SMPL sizes and kinematic tree
of ``uuo_mocap_tpu_torch/body/model.py`` beside them: a star-shaped
union-of-spheres humanoid with V = 6890, 24 joints, 13776 faces, 10 betas
and 207 pose correctives, built from a fixed seed.  The benchmark builds the
arrays once and hands the same arrays to the program (as its ``BodyModel``)
and to this reference.  Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

NUM_VERTICES = 6890
NUM_JOINTS = 24
NUM_BETAS = 10
NUM_POSE_JOINTS = NUM_JOINTS - 1
PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)

# Hand-authored T-pose skeleton (y-up, meters, SMPL joint order).
_REST_JOINTS = np.array(
    [
        [0.00, 0.00, 0.00],   # pelvis
        [0.09, -0.08, 0.00],  # left_hip
        [-0.09, -0.08, 0.00], # right_hip
        [0.00, 0.11, -0.01],  # spine1
        [0.10, -0.48, 0.00],  # left_knee
        [-0.10, -0.48, 0.00], # right_knee
        [0.00, 0.23, -0.01],  # spine2
        [0.10, -0.88, -0.03], # left_ankle
        [-0.10, -0.88, -0.03],# right_ankle
        [0.00, 0.33, -0.01],  # spine3
        [0.11, -0.95, 0.11],  # left_foot
        [-0.11, -0.95, 0.11], # right_foot
        [0.00, 0.46, -0.02],  # neck
        [0.07, 0.40, -0.01],  # left_collar
        [-0.07, 0.40, -0.01], # right_collar
        [0.00, 0.58, 0.01],   # head
        [0.17, 0.42, -0.01],  # left_shoulder
        [-0.17, 0.42, -0.01], # right_shoulder
        [0.43, 0.41, -0.01],  # left_elbow
        [-0.43, 0.41, -0.01], # right_elbow
        [0.68, 0.41, -0.01],  # left_wrist
        [-0.68, 0.41, -0.01], # right_wrist
        [0.78, 0.40, -0.01],  # left_hand
        [-0.78, 0.40, -0.01], # right_hand
    ],
    dtype=np.float64,
)

# Per-bone flesh radius (bone j spans parent(j) -> j).
_BONE_RADIUS = {
    1: 0.10, 2: 0.10, 3: 0.13, 4: 0.07, 5: 0.07, 6: 0.13, 7: 0.05, 8: 0.05,
    9: 0.13, 10: 0.045, 11: 0.045, 12: 0.06, 13: 0.08, 14: 0.08, 15: 0.09,
    16: 0.06, 17: 0.06, 18: 0.045, 19: 0.045, 20: 0.035, 21: 0.035,
    22: 0.03, 23: 0.03,
}


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    phi = (1 + 5**0.5) / 2
    theta = 2 * np.pi * i / phi
    z = 1 - (2 * i + 1) / n
    r = np.sqrt(np.maximum(1 - z * z, 0))
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=-1)


def _bone_samples():
    """Sample spheres along every bone: centers [S, 3], radii [S]."""
    centers, radii = [], []
    for j in range(1, NUM_JOINTS):
        p0 = _REST_JOINTS[int(PARENTS[j])]
        p1 = _REST_JOINTS[j]
        rad = _BONE_RADIUS[j]
        n = max(2, int(np.ceil(np.linalg.norm(p1 - p0) / 0.04)))
        for t in np.linspace(0, 1, n):
            centers.append(p0 + t * (p1 - p0))
            radii.append(rad)
    # torso center fill
    centers.append(np.array([0.0, 0.05, 0.0]))
    radii.append(0.14)
    return np.asarray(centers), np.asarray(radii)


def _point_to_segment_distance(points: np.ndarray, p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    d = p1 - p0
    t = np.clip((points - p0) @ d / max(float(d @ d), 1e-12), 0.0, 1.0)
    proj = p0 + t[:, None] * d
    return np.linalg.norm(points - proj, axis=-1)



def build_arrays(gender: str = "neutral") -> Dict[str, np.ndarray]:
    from scipy.spatial import ConvexHull

    rng = np.random.RandomState(1234)
    center = np.array([0.0, 0.1, 0.0])  # ray origin inside torso

    dirs = _fibonacci_sphere(NUM_VERTICES)
    centers, radii = _bone_samples()

    # Star-shaped support: furthest exit point of the ray through each sphere.
    rel = centers - center  # [S, 3]
    proj = dirs @ rel.T  # [V, S] — component of each center along each ray
    perp2 = np.maximum(np.sum(rel * rel, axis=-1)[None, :] - proj**2, 0.0)  # [V, S]
    hit = perp2 < radii[None, :] ** 2
    t_exit = np.where(hit, proj + np.sqrt(np.maximum(radii[None, :] ** 2 - perp2, 0.0)), 0.05)
    r = np.maximum(t_exit.max(axis=1), 0.05)  # [V]
    v_template = center + dirs * r[:, None]

    gender_scale = {"neutral": 1.0, "male": 1.05, "female": 0.94}[gender]
    v_template = center + (v_template - center) * gender_scale
    joints_approx = center + (_REST_JOINTS - center) * gender_scale

    # Topology from the *sphere* point set (convex): 2V-4 triangles.
    hull = ConvexHull(dirs)
    faces = hull.simplices.astype(np.int64)
    # Orient all faces outward (w.r.t. sphere centroid ~ origin).
    tri = dirs[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    c = tri.mean(axis=1)
    flip = np.sum(n * c, axis=-1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    # LBS weights: soft assignment by distance to bone segments.
    dist = np.zeros((NUM_VERTICES, NUM_JOINTS))
    for j in range(NUM_JOINTS):
        if j == 0:
            d = _point_to_segment_distance(v_template, joints_approx[0], joints_approx[0] + [0, 0.08, 0])
        else:
            d = _point_to_segment_distance(v_template, joints_approx[int(PARENTS[j])], joints_approx[j])
        dist[:, j] = d
    w = np.exp(-((dist / 0.06) ** 2))
    # top-4 sparsification (SMPL uses <=4 nonzero weights per vertex)
    order = np.argsort(-w, axis=1)
    mask = np.zeros_like(w)
    np.put_along_axis(mask, order[:, :4], 1.0, axis=1)
    w = w * mask
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)

    # Joint regressor: Gaussian neighborhoods around each joint.
    jr = np.zeros((NUM_JOINTS, NUM_VERTICES))
    for j in range(NUM_JOINTS):
        d = np.linalg.norm(v_template - joints_approx[j], axis=-1)
        wj = np.exp(-((d / 0.09) ** 2))
        keep = np.argsort(-wj)[:64]
        row = np.zeros(NUM_VERTICES)
        row[keep] = wj[keep]
        jr[j] = row / row.sum()
    # Rest skeleton := regressed joints (self-consistency)
    joints_rest = jr @ v_template

    # Shape blendshapes: global scale, height, and smooth low-frequency modes.
    shapedirs = np.zeros((NUM_VERTICES, 3, NUM_BETAS))
    shapedirs[:, :, 0] = (v_template - center) * 0.05
    shapedirs[:, 1, 1] = (v_template[:, 1] - center[1]) * 0.06
    for k in range(2, NUM_BETAS):
        freq = rng.uniform(1.0, 3.0, size=(3,))
        phase = rng.uniform(0, 2 * np.pi, size=(3,))
        amp = rng.uniform(0.004, 0.012)
        bump = np.sin(v_template @ freq + phase[0]) * amp
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        shapedirs[:, :, k] = bump[:, None] * axis[None, :]

    # Pose blendshapes: rank-16 smooth corrective basis, ~mm scale.
    rank = 16
    U = rng.randn(NUM_POSE_JOINTS * 9, rank) * 0.01
    Vr = np.zeros((rank, NUM_VERTICES * 3))
    for k in range(rank):
        freq = rng.uniform(1.0, 4.0, size=(3,))
        phase = rng.uniform(0, 2 * np.pi)
        bump = np.sin(v_template @ freq + phase) * 0.02
        direction = rng.randn(3)
        direction /= np.linalg.norm(direction)
        Vr[k] = (bump[:, None] * direction[None, :]).reshape(-1)
    posedirs = (U @ Vr).astype(np.float32)  # [207, V*3]

    return {
        "v_template": v_template.astype(np.float32),
        "shapedirs": shapedirs.astype(np.float32),
        "posedirs": posedirs,
        "j_regressor": jr.astype(np.float32),
        "lbs_weights": w.astype(np.float32),
        "faces": faces.astype(np.int32),
        "joints_rest": joints_rest.astype(np.float32),
    }


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    as the tensor cores read an operand when TF32 is allowed."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """``a @ b``; with ``tf32`` both operands are rounded to TF32 first and
    the products summed in float32, which is what a float32 matmul does on
    the card once TF32 is allowed."""
    if tf32:
        return _round_tf32(a.float()) @ _round_tf32(b.float())
    return a @ b


def model_tensors(arrays: Dict[str, np.ndarray], dtype=torch.float64,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """The arrays ``lbs`` reads, as tensors of ``dtype`` on ``device``."""
    keys = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights")
    return {k: torch.as_tensor(np.asarray(arrays[k]), device=device).to(dtype) for k in keys}


def lbs(model: Dict[str, torch.Tensor], pose_body: torch.Tensor, betas: torch.Tensor,
        root_orient: torch.Tensor, trans: torch.Tensor, vertex_ids: Optional[torch.Tensor] = None,
        tf32: bool = False) -> Dict[str, torch.Tensor]:
    """The SMPL forward over frames: pose_body [F, 23, 3, 3], betas [1 or F,
    10], root_orient [F, 1, 3, 3], trans [F, 3] -> {"joints" [F, 24, 3],
    "vertices" [F, V or K, 3]}, the vertices only at ``vertex_ids`` [K] when
    given.  Every matmul goes through ``matmul`` (``tf32``: the control)."""
    F = trans.shape[0]
    v_t, sd, jr = model["v_template"], model["shapedirs"], model["j_regressor"]
    V = v_t.shape[0]
    betas = betas.expand(F, NUM_BETAS)
    # rest joints from the regressor contracted with the template and shape basis
    j_shape = matmul(jr, sd.reshape(V, 3 * NUM_BETAS), tf32).reshape(NUM_JOINTS, 3, NUM_BETAS)
    j_rest = matmul(jr, v_t, tf32) + matmul(
        betas, j_shape.reshape(NUM_JOINTS * 3, NUM_BETAS).T, tf32).reshape(F, NUM_JOINTS, 3)
    ids = torch.arange(V, device=v_t.device) if vertex_ids is None else vertex_ids
    K = ids.shape[0]
    v_shaped = v_t[ids] + matmul(betas, sd[ids].reshape(K * 3, NUM_BETAS).T, tf32).reshape(F, K, 3)
    posedirs = model["posedirs"].reshape(NUM_POSE_JOINTS * 9, V, 3)[:, ids].reshape(NUM_POSE_JOINTS * 9, K * 3)
    eye = torch.eye(3, dtype=v_t.dtype, device=v_t.device)
    pose_feature = (pose_body - eye).reshape(F, NUM_POSE_JOINTS * 9)
    v_posed = v_shaped + matmul(pose_feature, posedirs, tf32).reshape(F, K, 3)

    rot = torch.cat([root_orient, pose_body], dim=-3)  # [F, 24, 3, 3]
    R, t = [rot[:, 0]], [j_rest[:, 0]]
    for j in range(1, NUM_JOINTS):
        p = int(PARENTS[j])
        R.append(matmul(R[p], rot[:, j], tf32))
        t.append(t[p] + matmul(R[p], (j_rest[:, j] - j_rest[:, p])[..., None], tf32)[..., 0])
    R_w, t_w = torch.stack(R, dim=1), torch.stack(t, dim=1)  # [F, 24, 3, 3], [F, 24, 3]
    t_rel = t_w - matmul(R_w, j_rest[..., None], tf32)[..., 0]
    A = torch.cat([R_w, t_rel[..., None]], dim=-1).reshape(F, NUM_JOINTS, 12)
    T = matmul(model["lbs_weights"][ids], A, tf32).reshape(F, K, 3, 4)
    verts = matmul(T[..., :3], v_posed[..., None], tf32)[..., 0] + T[..., 3]
    return {"joints": t_w + trans[:, None], "vertices": verts + trans[:, None]}


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3] (the identity at angle 0)."""
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)  # [..., 1]
    k = aa / torch.where(theta > 0, theta, torch.ones_like(theta))  # unit axis [..., 3]
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    hat = torch.stack([torch.stack([zero, -kz, ky], -1), torch.stack([kz, zero, -kx], -1),
                       torch.stack([-ky, kx, zero], -1)], -2)
    theta = theta[..., None]  # [..., 1, 1]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + torch.sin(theta) * hat + (1 - torch.cos(theta)) * (hat @ hat)
