"""Point -> triangle-mesh distance, closed form and batched (counterpart of
``uuo_mocap_tpu/ops/point_mesh.py``).

The closed-form point-triangle projection (Eberly's region decomposition,
branch-free) runs for all (point, face) pairs as one [..., M, T] tensor
program.  The JAX package runs it as XLA, not Pallas, so plain PyTorch is
its port.  The m2s metric takes |distance| only, so no winding-number sign
is computed.  ``marker_to_surface_distance`` walks the frames in chunks so
that the [chunk, M, T] working set fits on the card (T = 13776 SMPL faces).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def point_triangle_closest(points: torch.Tensor, tri0: torch.Tensor, tri1: torch.Tensor,
                           tri2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest point on each triangle [..., T, 3] (corners tri0..tri2) to each
    point [..., M, 3] -> (squared distances [..., M, T], barycentric
    coordinates [..., M, T, 3])."""
    # P = B + s E0 + t E1
    B = tri0[..., None, :, :]
    E0 = (tri1 - tri0)[..., None, :, :]
    E1 = (tri2 - tri0)[..., None, :, :]
    D = B - points[..., :, None, :]  # [..., M, T, 3]

    a = (E0 * E0).sum(-1)
    b = (E0 * E1).sum(-1)
    c = (E1 * E1).sum(-1)
    d = (E0 * D).sum(-1)
    e = (E1 * D).sum(-1)

    det = torch.clamp_min(a * c - b * b, 1e-20)
    s = b * e - c * d
    t = b * d - a * e
    a_s = torch.clamp_min(a, 1e-20)
    c_s = torch.clamp_min(c, 1e-20)
    inside = (s + t <= det) & (s >= 0) & (t >= 0)

    # the interior candidate and the best point of each edge
    sA, tA = s / det, t / det
    t_s0 = torch.clamp(-e / c_s, 0.0, 1.0)  # edge s = 0
    s_t0 = torch.clamp(-d / a_s, 0.0, 1.0)  # edge t = 0
    denom_e = torch.clamp_min(a - 2 * b + c, 1e-20)
    s_e = torch.clamp((c + e - b - d) / denom_e, 0.0, 1.0)  # edge s + t = 1
    t_e = 1.0 - s_e

    def q(sv, tv):
        diff = D + sv[..., None] * E0 + tv[..., None] * E1
        return (diff * diff).sum(-1)

    zero = torch.zeros_like(s)
    q_in = q(sA, tA)
    q_s0 = q(zero, t_s0)
    q_t0 = q(s_t0, zero)
    q_e = q(s_e, t_e)

    q_edge = torch.minimum(torch.minimum(q_s0, q_t0), q_e)
    is_s0 = q_edge == q_s0
    is_t0 = (~is_s0) & (q_edge == q_t0)
    s_out = torch.where(is_s0, zero, torch.where(is_t0, s_t0, s_e))
    t_out = torch.where(is_s0, t_s0, torch.where(is_t0, zero, t_e))

    s_fin = torch.where(inside, sA, s_out)
    t_fin = torch.where(inside, tA, t_out)
    d2 = torch.clamp_min(torch.where(inside, q_in, q_edge), 0.0)
    return d2, torch.stack([1.0 - s_fin - t_fin, s_fin, t_fin], dim=-1)


def point_mesh_distance(points: torch.Tensor, vertices: torch.Tensor,
                        faces) -> Dict[str, torch.Tensor]:
    """Unsigned point -> mesh distance: points [..., M, 3], vertices
    [..., V, 3], faces [T, 3] -> {"distance" [..., M], "face_index"
    [..., M], "barycentric" [..., M, 3], "closest_point" [..., M, 3]}."""
    faces = torch.as_tensor(np.asarray(faces, np.int64), device=vertices.device)
    tri = vertices[..., faces, :]  # [..., T, 3 corners, 3]
    d2, bary = point_triangle_closest(points, tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])
    face_index = d2.argmin(dim=-1)  # [..., M]
    d2_min = torch.gather(d2, -1, face_index[..., None])[..., 0]
    bary_min = torch.gather(bary, -2, face_index[..., None, None].expand(
        face_index.shape + (1, 3)))[..., 0, :]
    f_sel = faces[face_index]  # [..., M, 3] corner vertex ids
    closest = torch.zeros_like(points)
    for k in range(3):
        idx = f_sel[..., k:k + 1].expand(f_sel.shape[:-1] + (3,))
        closest = closest + bary_min[..., k:k + 1] * torch.gather(vertices, -2, idx)
    return {
        "distance": torch.sqrt(torch.clamp_min(d2_min, 0.0)),
        "face_index": face_index,
        "barycentric": bary_min,
        "closest_point": closest,
    }


def marker_to_surface_distance(markers: torch.Tensor, vertices: torch.Tensor, faces,
                               chunk: int = 32) -> torch.Tensor:
    """The m2s metric: the mean over frames of each frame's mean |marker ->
    surface| distance.  markers [F, M, 3], vertices [F, V, 3]; ``chunk``
    frames at a time bound the [chunk, M, T] working set."""
    per_frame = []
    with torch.no_grad():
        for f0 in range(0, markers.shape[0], chunk):
            out = point_mesh_distance(markers[f0:f0 + chunk], vertices[f0:f0 + chunk], faces)
            per_frame.append(out["distance"].mean(dim=-1))
    return torch.cat(per_frame).mean()
