"""3D rotations in PyTorch (counterpart of ``uuo_mocap_tpu/ops/rotations.py``).

Same conventions as the reference: quaternions are (w, x, y, z), matrices
act on column vectors, and the 6d representation is the first two ROWS of
the matrix.  Closed forms keep the small-angle guards, so gradients at zero
are exact and NaN-free (``uuo_mocap_tpu/ops/rotations.py:25-31``).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, [..., 3] -> [..., 3, 3].

    theta^2 is replaced by 1.0 before the sqrt in the small-angle region and
    the small branch is polynomial in theta^2, so the gradient at 0 is exact
    (``torch.where`` does not stop NaN gradients of the untaken branch)."""
    theta2 = (axis_angle * axis_angle).sum(-1, keepdim=True)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    cos_t = torch.where(small, 1.0 - theta2 / 2.0, torch.cos(theta))[..., None]
    sinc_t = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)[..., None]
    omc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)[..., None]
    ax, ay, az = axis_angle[..., 0], axis_angle[..., 1], axis_angle[..., 2]
    zero = torch.zeros_like(ax)
    hat = torch.stack([
        torch.stack([zero, -az, ay], dim=-1),
        torch.stack([az, zero, -ax], dim=-1),
        torch.stack([-ay, ax, zero], dim=-1),
    ], dim=-2)
    outer = axis_angle[..., :, None] * axis_angle[..., None, :]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return cos_t * eye + sinc_t * hat + omc * outer


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z), branch-free Shepperd variant."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, _EPS))

    qw = safe_sqrt(1.0 + m00 + m11 + m22)
    qx = safe_sqrt(1.0 + m00 - m11 - m22)
    qy = safe_sqrt(1.0 - m00 + m11 - m22)
    qz = safe_sqrt(1.0 - m00 - m11 + m22)
    cand_w = torch.stack([qw * qw, m21 - m12, m02 - m20, m10 - m01], -1) / (2.0 * qw[..., None])
    cand_x = torch.stack([m21 - m12, qx * qx, m01 + m10, m02 + m20], -1) / (2.0 * qx[..., None])
    cand_y = torch.stack([m02 - m20, m01 + m10, qy * qy, m12 + m21], -1) / (2.0 * qy[..., None])
    cand_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz * qz], -1) / (2.0 * qz[..., None])
    trace_based = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                               1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = trace_based.argmax(-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # [..., 4, 4]
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 4] (w, x, y, z), with the small-angle guard of
    ``axis_angle_to_matrix``."""
    theta2 = (axis_angle * axis_angle).sum(-1, keepdim=True)
    small = theta2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = theta * 0.5
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    sinc_half = torch.where(small, 1.0 - theta2 / 24.0, torch.sin(half) / half)
    return torch.cat([w, axis_angle * 0.5 * sinc_half], dim=-1)


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3].  The angle comes from
    atan2(|xyz|, w), which stays accurate near 0 and near pi; below
    |xyz|^2 = 1e-12 the scale 2 * half / |xyz| is its limit, 2."""
    q = quat * torch.where(quat[..., :1] < 0, -1.0, 1.0)
    n2 = (q[..., 1:] * q[..., 1:]).sum(-1, keepdim=True)
    small = n2 < 1e-12
    norm_xyz = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    half = torch.atan2(norm_xyz, q[..., :1])
    scale = torch.where(small, torch.full_like(n2, 2.0), 2.0 * half / norm_xyz)
    return q[..., 1:] * scale


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3], through the quaternion."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """First two rows, flattened: [..., 3, 3] -> [..., 6]."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt two 3-vectors into orthonormal rows: [..., 6] -> [..., 3, 3]."""
    a1, a2 = d6[..., 0:3], d6[..., 3:6]
    b1 = a1 / torch.clamp_min(torch.linalg.norm(a1, dim=-1, keepdim=True), _EPS)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.clamp_min(torch.linalg.norm(a2p, dim=-1, keepdim=True), _EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def normalize_rotation(matrix: torch.Tensor) -> torch.Tensor:
    """``rotation_6d_to_matrix(matrix_to_rotation_6d(x))``."""
    return rotation_6d_to_matrix(matrix_to_rotation_6d(matrix))


def so3_rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle of [..., 3, 3] in radians, via atan2(|skew|, trace)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    sx = R[..., 2, 1] - R[..., 1, 2]
    sy = R[..., 0, 2] - R[..., 2, 0]
    sz = R[..., 1, 0] - R[..., 0, 1]
    sin_term = 0.5 * torch.sqrt(torch.clamp_min(sx * sx + sy * sy + sz * sz, _EPS * _EPS))
    cos_term = 0.5 * (trace - 1.0)
    return torch.atan2(sin_term, cos_term)


def so3_relative_angle(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle of R1 @ R2^T."""
    return so3_rotation_angle(R1 @ R2.transpose(-1, -2))


def quaternion_slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Shortest-arc slerp of unit quaternions; lerp when nearly parallel."""
    alpha = torch.as_tensor(alpha, dtype=q0.dtype, device=q0.device)
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot_c = torch.clamp(dot.abs(), -1.0, 1.0)
    theta = torch.acos(torch.clamp(dot_c, 0.0, 1.0 - _EPS))
    sin_theta = torch.sin(theta)
    near = dot_c > 1.0 - 1e-6
    safe = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(near, 1.0 - alpha, torch.sin((1.0 - alpha) * theta) / safe)
    w1 = torch.where(near, alpha, torch.sin(alpha * theta) / safe)
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def matrix_slerp(R0: torch.Tensor, R1: torch.Tensor, alpha) -> torch.Tensor:
    """Slerp on rotation matrices (prior-stream resampling)."""
    return quaternion_to_matrix(
        quaternion_slerp(matrix_to_quaternion(R0), matrix_to_quaternion(R1), alpha))


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    """Yaw rotation about +z from a [..., 1] angle -> [..., 3, 3]."""
    zeros = torch.zeros_like(angle)
    return axis_angle_to_matrix(torch.cat([zeros, zeros, angle], dim=-1))


def rot_y(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about +y from a [..., 1] angle -> [..., 3, 3]."""
    zeros = torch.zeros_like(angle)
    return axis_angle_to_matrix(torch.cat([zeros, angle, zeros], dim=-1))


def apply_rotation(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """R @ v for [..., 3, 3] x [..., 3] -> [..., 3]."""
    return (mat @ vec[..., None])[..., 0]
