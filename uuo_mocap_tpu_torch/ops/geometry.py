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
