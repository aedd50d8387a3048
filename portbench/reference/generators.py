"""The benchmark's input generators: ground-truth motion, markers and an
HMR-like prior, made on the host from a seed.

Frozen copies of ``random_pose_sequence``, ``generate_markers`` and
``perturb_params`` in ``uuo_mocap_tpu_torch/data/synthetic.py`` (commit
1ed4835): the same ``RandomState`` draws in the same order, the arithmetic
in float64 on the CPU (so a seed gives the same bits on every machine), and
the markers posed with ``body.lbs`` at their vertices and the vertices of
the faces around them only.  Outputs are float64 numpy; the benchmark hands
their float32 cast to the program and to the reference alike.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench.reference.body import axis_angle_to_matrix, lbs

MARKER_DISTANCE = 0.0095  # the markers' normal offset, m (uuo_mocap_tpu_torch/settings.py)

# per-joint motion amplitude (radians): limbs move, the spine is stiffer
_JOINT_AMP = np.array(
    [0.4, 0.4, 0.15, 0.5, 0.5, 0.12, 0.35, 0.35, 0.1, 0.15, 0.15, 0.2,
     0.1, 0.1, 0.25, 0.45, 0.45, 0.5, 0.5, 0.3, 0.3, 0.15, 0.15],
    dtype=np.float32,
)


def _rotations(aa: np.ndarray) -> np.ndarray:
    return axis_angle_to_matrix(torch.as_tensor(np.asarray(aa, np.float64))).numpy()


def random_pose_sequence(num_frames: int, seed: int, freq: float = 30.0, yaw: float = 0.0,
                         travel: float = 0.5) -> Dict[str, np.ndarray]:
    """Smooth random body motion: band-limited joint angles, a yawing root and
    a smooth path of about ``travel`` metres.  -> {"pose_body" [F, 23, 3, 3],
    "betas" [1, 10], "root_orient" [F, 1, 3, 3], "trans" [F, 3]}."""
    rng = np.random.RandomState(seed)
    t = np.arange(num_frames, dtype=np.float32) / freq

    def band_limited(shape, fmax=1.5, n_comp=4, amp=1.0):
        out = np.zeros((num_frames,) + shape, np.float32)
        for _ in range(n_comp):
            f = rng.uniform(0.1, fmax, shape).astype(np.float32)
            phase = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
            a = rng.uniform(0.2, 1.0, shape).astype(np.float32) * amp / n_comp
            out += a * np.sin(2 * np.pi * f * t.reshape(-1, *([1] * len(shape))) + phase)
        return out

    aa = band_limited((23, 3)) * _JOINT_AMP[None, :, None]
    root_aa = np.zeros((num_frames, 1, 3), np.float32)
    root_aa[:, 0, 2] = yaw + band_limited((), fmax=0.3, amp=0.2)
    path = band_limited((3,), fmax=0.4, amp=travel)
    path[:, 1] *= 0.1  # mostly planar travel (y is up in the body model)
    betas = rng.randn(1, 10).astype(np.float32) * 0.5
    return {"pose_body": _rotations(aa), "betas": betas.astype(np.float64),
            "root_orient": _rotations(root_aa), "trans": path.astype(np.float64)}


def _vertex_normals_at(verts: np.ndarray, faces: np.ndarray, ids: np.ndarray,
                       index: Dict[int, int]) -> np.ndarray:
    """Area-weighted unit normals at vertices ``ids`` [K]: each sums the
    normals of the faces around it in face order.  verts [F, S, 3] holds the
    posed vertices listed in ``index`` (vertex id -> column)."""
    order = np.argsort(faces.ravel(), kind="stable")  # corners by vertex, faces ascending
    ptr = np.searchsorted(faces.ravel()[order], np.asarray(ids))
    end = np.searchsorted(faces.ravel()[order], np.asarray(ids), side="right")
    around = [faces[order[a:b] // 3] for a, b in zip(ptr, end)]
    deg = max(len(a) for a in around)
    cols = np.zeros((len(ids), deg, 3), np.int64)
    live = np.zeros((len(ids), deg, 1))
    for k, a in enumerate(around):
        cols[k, :len(a)] = [[index[int(c)] for c in face] for face in a]
        live[k, :len(a)] = 1.0
    t0, t1, t2 = (verts[:, cols[..., c]] for c in range(3))  # [F, K, deg, 3]
    out = np.zeros(verts.shape[:1] + (len(ids), 3))
    for j in range(deg):  # in face order, as the program's generator sums them
        out += np.cross(t1[:, :, j] - t0[:, :, j], t2[:, :, j] - t0[:, :, j]) * live[:, j]
    return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)


def generate_markers(model: Dict[str, torch.Tensor], faces: np.ndarray, gt: Dict[str, np.ndarray],
                     num_markers: int, seed: int, occlusion_rate: float = 0.0,
                     vertex_ids: Optional[np.ndarray] = None,
                     surface_offset: float = MARKER_DISTANCE) -> Dict[str, np.ndarray]:
    """Markers at random surface vertices (or at ``vertex_ids``) plus a
    normal offset; occluded markers are zeroed.  ``model``: ``body.
    model_tensors`` in float64 on the CPU.  -> {"points" [F, M, 3],
    "vertex_ids" [M]}."""
    rng = np.random.RandomState(seed)
    V = model["v_template"].shape[0]
    if vertex_ids is not None:
        vid = np.asarray(vertex_ids, np.int64)
    else:
        vid = rng.choice(V, num_markers, replace=False)
    ring = np.unique(np.concatenate([vid, faces[np.isin(faces, vid).any(axis=1)].ravel()]))
    posed = lbs(model, *(torch.as_tensor(gt[k]) for k in ("pose_body", "betas", "root_orient",
                                                          "trans")),
                vertex_ids=torch.as_tensor(ring))["vertices"].numpy()
    index = {int(v): i for i, v in enumerate(ring)}
    cols = [index[int(v)] for v in vid]
    points = posed[:, cols] + _vertex_normals_at(posed, faces, vid, index) * surface_offset
    if occlusion_rate > 0:
        occl = rng.rand(points.shape[0], len(vid)) < occlusion_rate
        points = np.where(occl[..., None], 0.0, points)
    return {"points": points, "vertex_ids": vid}


def perturb_params(params: Dict[str, np.ndarray], seed: int, pose_noise: float,
                   trans_noise: float, betas_noise: float) -> Dict[str, np.ndarray]:
    """An HMR-like degraded prior: noisy pose, root, translation and betas."""
    rng = np.random.RandomState(seed + 1)
    F = params["trans"].shape[0]

    def noise(*shape, scale):
        return rng.randn(*shape).astype(np.float32).astype(np.float64) * scale

    return {"pose_body": _rotations(noise(F, 23, 3, scale=pose_noise)) @ params["pose_body"],
            "root_orient": _rotations(noise(F, 1, 3, scale=pose_noise)) @ params["root_orient"],
            "trans": params["trans"] + noise(F, 3, scale=trans_noise),
            "betas": params["betas"] + noise(1, 10, scale=betas_noise)}
