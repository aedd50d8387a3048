"""Synthetic sequences and markers with known ground truth (counterpart of
``uuo_mocap_tpu/data/synthetic.py``).  The random draws use numpy
``RandomState`` in the reference's order, so the same seeds give the same
motion, marker anchors, occlusions and prior noise."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward
from uuo_mocap_tpu_torch.device import resolve_device
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.pipeline.stages import SmplParams
from uuo_mocap_tpu_torch.settings import MARKER_DISTANCE

# per-joint motion amplitude (radians) — limbs move, spine is stiffer
_JOINT_AMP = np.array(
    [0.4, 0.4, 0.15, 0.5, 0.5, 0.12, 0.35, 0.35, 0.1, 0.15, 0.15, 0.2,
     0.1, 0.1, 0.25, 0.45, 0.45, 0.5, 0.5, 0.3, 0.3, 0.15, 0.15],
    dtype=np.float32,
)


def random_pose_sequence(num_frames: int, seed: int = 0, freq: float = 30.0, yaw: float = 0.0,
                         travel: float = 0.5, device=None) -> SmplParams:
    """Smooth random body motion: band-limited joint angles, a yawing root
    and a smooth path of ~``travel`` meters."""
    dev = resolve_device(device)
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
    pose_body = rot.axis_angle_to_matrix(torch.as_tensor(aa, device=dev))
    root_aa = np.zeros((num_frames, 1, 3), np.float32)
    root_aa[:, 0, 2] = yaw + band_limited((), fmax=0.3, amp=0.2)
    root_orient = rot.axis_angle_to_matrix(torch.as_tensor(root_aa, device=dev))
    path = band_limited((3,), fmax=0.4, amp=travel)
    path[:, 1] *= 0.1  # mostly planar travel (y is up in the body model)
    betas = torch.as_tensor(rng.randn(1, 10).astype(np.float32) * 0.5, device=dev)
    return SmplParams(pose_body, betas, root_orient, torch.as_tensor(path, device=dev))


class SyntheticMarkers(NamedTuple):
    points: torch.Tensor  # [F, M, 3]
    vertex_ids: np.ndarray  # [M] generating vertex
    freq: float
    gt: SmplParams


def _vertex_faces(faces: np.ndarray, num_vertices: int) -> np.ndarray:
    """[V, K] ids of the faces around each vertex in face order, padded with
    ``len(faces)`` (the id of an appended zero normal)."""
    v = faces.reshape(-1)
    f = np.repeat(np.arange(faces.shape[0]), faces.shape[1])
    order = np.argsort(v, kind="stable")
    v, f = v[order], f[order]
    counts = np.bincount(v, minlength=num_vertices)
    slot = np.arange(v.size) - (np.cumsum(counts) - counts)[v]
    table = np.full((num_vertices, int(counts.max())), faces.shape[0], np.int64)
    table[v, slot] = f
    return table


def _vertex_normals(verts: torch.Tensor, faces: np.ndarray) -> torch.Tensor:
    """Area-weighted unit vertex normals of [F, V, 3].  Each vertex sums its
    faces' normals in face order, the same order on every device and run
    (a CUDA ``index_add_`` sums in whatever order its atomics land, so the
    markers would change in their last bits from run to run)."""
    fi = torch.as_tensor(faces, device=verts.device)
    t0, t1, t2 = (verts[:, fi[:, k]] for k in range(3))
    face_n = torch.linalg.cross(t1 - t0, t2 - t0, dim=-1)
    face_n = torch.cat([face_n, face_n.new_zeros(face_n.shape[0], 1, 3)], dim=1)
    table = torch.as_tensor(_vertex_faces(faces, verts.shape[1]), device=verts.device)
    vn = face_n[:, table[:, 0]]
    for k in range(1, table.shape[1]):
        vn = vn + face_n[:, table[:, k]]
    return vn / torch.clamp_min(torch.linalg.norm(vn, dim=-1, keepdim=True), 1e-12)


def generate_markers(model: BodyModel, params: SmplParams, num_markers: int = 41, seed: int = 0,
                     freq: float = 30.0, surface_offset: float = MARKER_DISTANCE,
                     occlusion_rate: float = 0.0, position_noise: float = 0.0,
                     shuffle: bool = False, vertex_ids=None) -> SyntheticMarkers:
    """Virtual markers at random surface vertices plus a normal offset;
    occluded markers are zeroed (the origin-mask protocol)."""
    rng = np.random.RandomState(seed)
    F = params.trans.shape[0]
    dev = model.device
    if vertex_ids is not None:
        vid = np.asarray(vertex_ids, np.int64)
        num_markers = int(vid.shape[0])
    else:
        vid = rng.choice(model.num_vertices, num_markers, replace=False)
    with torch.no_grad():
        verts = lbs_forward(model, params.pose_body, params.betas, params.root_orient,
                            params.trans)["vertices"]
        vid_t = torch.as_tensor(vid, device=dev)
        points = verts[:, vid_t] + _vertex_normals(verts, model.faces.astype(np.int64))[:, vid_t] \
            * surface_offset
    if position_noise > 0:
        points = points + torch.as_tensor(
            rng.randn(F, num_markers, 3).astype(np.float32) * position_noise, device=dev)
    if occlusion_rate > 0:
        occl = torch.as_tensor(rng.rand(F, num_markers) < occlusion_rate, device=dev)
        points = torch.where(occl[..., None], torch.zeros_like(points), points)
    if shuffle:
        for f in range(F):
            points[f] = points[f, torch.as_tensor(rng.permutation(num_markers), device=dev)]
    return SyntheticMarkers(points=points, vertex_ids=vid, freq=freq, gt=params)


def perturb_params(params: SmplParams, seed: int = 0, pose_noise: float = 0.05,
                   trans_noise: float = 0.1, betas_noise: float = 0.3) -> SmplParams:
    """An HMR-like degraded prior: noisy pose, root, translation and betas."""
    rng = np.random.RandomState(seed + 1)
    F = params.trans.shape[0]
    dev = params.trans.device

    def noise(*shape, scale):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * scale, device=dev)

    pose = rot.axis_angle_to_matrix(noise(F, 23, 3, scale=pose_noise)) @ params.pose_body
    root = rot.axis_angle_to_matrix(noise(F, 1, 3, scale=pose_noise)) @ params.root_orient
    trans = params.trans + noise(F, 3, scale=trans_noise)
    betas = params.betas + noise(1, 10, scale=betas_noise)
    return SmplParams(pose, betas, root, trans)
