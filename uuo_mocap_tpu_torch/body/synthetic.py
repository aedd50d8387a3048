"""Deterministic synthetic SMPL-format body model (a numpy copy of the
construction in ``uuo_mocap_tpu/body/synthetic.py:112-231``).

Same arrays, bit for bit: a star-shaped union-of-spheres humanoid with the
SMPL tensor shapes (V=6890, J=24, 13776 faces, 10 betas, 207 pose
correctives), built from a fixed seed.
"""
from __future__ import annotations

import functools

import numpy as np

from uuo_mocap_tpu_torch.body.model import (
    NUM_BETAS,
    NUM_JOINTS,
    NUM_POSE_JOINTS,
    NUM_VERTICES,
    PARENTS,
    BodyModel,
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


@functools.lru_cache(maxsize=4)
def _build_arrays(gender: str = "neutral"):
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


def synthetic_body_model(device=None, gender: str = "neutral") -> BodyModel:
    """The deterministic synthetic model on ``device`` (default: the card);
    the male and female models are the neutral one scaled by 1.05 and 0.94."""
    from uuo_mocap_tpu_torch.convert import body_model_from_numpy

    return body_model_from_numpy(_build_arrays(gender), device=device, gender=gender)


def export_synthetic_npz(path: str, gender: str = "neutral") -> str:
    """Write the synthetic model in the npz schema ``load_body_model`` reads
    (the SMPL pickles' field names; posedirs [V, 3, 207])."""
    arrs = _build_arrays(gender)
    np.savez(
        path,
        v_template=arrs["v_template"],
        shapedirs=arrs["shapedirs"],
        posedirs=arrs["posedirs"].T.reshape(NUM_VERTICES, 3, -1),
        J_regressor=arrs["j_regressor"],
        weights=arrs["lbs_weights"],
        f=arrs["faces"],
    )
    return path
