"""AABB and marker-mask helpers (counterpart of ``uuo_mocap_tpu/ops/geometry.py``)."""
from __future__ import annotations

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
