"""AABB, marker-mask and vertex-normal helpers (counterpart of
``uuo_mocap_tpu/ops/geometry.py``)."""
from __future__ import annotations

import numpy as np
import torch


def get_aabb(points: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] -> [..., 2, 3] (min, max)."""
    return torch.stack([points.amin(dim=-2), points.amax(dim=-2)], dim=-2)


def get_aabb_volume(aabb: torch.Tensor) -> torch.Tensor:
    """[..., 2, 3] -> [...] volume."""
    return (aabb[..., 1, :] - aabb[..., 0, :]).prod(dim=-1)


def get_marker_mask(markers: torch.Tensor) -> torch.Tensor:
    """1 where the marker is valid (not exactly at the origin; occluded
    markers are zero-filled upstream).  [..., M, 3] -> [..., M] float."""
    return (markers.abs().sum(dim=-1) != 0.0).to(markers.dtype)


def median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median as numpy and JAX define it: the mean of the two middle values
    for an even count (``torch.median`` returns the lower one)."""
    return torch.quantile(x, 0.5, dim=dim)


def upsample_frames(x: torch.Tensor, F_full: int, stride: int) -> torch.Tensor:
    """Linear interpolation of a frame-strided lane tensor [Ln, F_s, ...]
    (sampled at frames 0, s, 2s, ...) back to [Ln, F_full, ...]
    (``geometry.py:83-93``): the warm start handed from a frame-strided
    tournament round to a full-frame one."""
    Fs = x.shape[1]
    pos = torch.arange(F_full, dtype=torch.float32, device=x.device) / float(stride)
    i0 = torch.clamp(torch.floor(pos).long(), 0, Fs - 1)
    i1 = torch.clamp(i0 + 1, 0, Fs - 1)
    w = (pos - i0.to(torch.float32)).reshape((1, F_full) + (1,) * (x.dim() - 2)).to(x.dtype)
    return x[:, i0] * (1.0 - w) + x[:, i1] * w


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


def vertex_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """Area-weighted unit vertex normals of [..., V, 3] (``geometry.py:58``).
    Each vertex sums its faces' normals in face order, the same order on
    every device and run (a CUDA ``index_add_`` sums in whatever order its
    atomics land, so the markers would change in their last bits from run
    to run)."""
    faces = np.asarray(faces, np.int64)
    fi = torch.as_tensor(faces, device=verts.device)
    t0, t1, t2 = (verts[..., fi[:, k], :] for k in range(3))
    face_n = torch.linalg.cross(t1 - t0, t2 - t0, dim=-1)
    face_n = torch.cat([face_n, face_n.new_zeros(face_n.shape[:-2] + (1, 3))], dim=-2)
    table = torch.as_tensor(_vertex_faces(faces, verts.shape[-2]), device=verts.device)
    vn = face_n[..., table[:, 0], :]
    for k in range(1, table.shape[1]):
        vn = vn + face_n[..., table[:, k], :]
    return vn / torch.clamp_min(torch.linalg.norm(vn, dim=-1, keepdim=True), 1e-12)
