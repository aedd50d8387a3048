"""Marker <-> vertex distances (counterpart of ``uuo_mocap_tpu/ops/chamfer.py``).

Distances are squared Euclidean; clouds are centered on the target
centroid before the |x|^2 + |y|^2 - 2xy expansion, which keeps the FP32
cancellation error near 1e-7 m^2 even meters from the origin.

The reductions take a ``batch_dims`` argument: the reference reduces to a
scalar and runs under ``vmap``; here the lane axis is written out, so a
caller passes ``batch_dims=1`` to get one value per lane.  With the default
``batch_dims=0`` every function reduces exactly as the reference does.

``min_sqdist`` dispatches on the tensor's device: CUDA tensors run the
Hopper kernels of ``ops.chamfer_kernels``, CPU tensors their plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from uuo_mocap_tpu_torch.ops import chamfer_kernels as K

BIG = 1e10  # vertex-exclusion bias (0 keeps a vertex)


def squared_distance_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances [..., M, 3] x [..., V, 3] -> [..., M, V],
    centered on the y centroid and clamped at 0 (``chamfer.py:62-86``)."""
    c = y.mean(dim=-2, keepdim=True)
    x = x - c
    y = y - c
    x2 = (x * x).sum(-1)[..., :, None]
    y2 = (y * y).sum(-1)[..., None, :]
    xy = x @ y.transpose(-1, -2)
    return torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0)


def nearest_vertex(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """min_v ||x_m - y_v||^2 and argmin over V: -> ([..., M], [..., M])."""
    d2 = squared_distance_matrix(x, y)
    return d2.min(dim=-1)


class MinSqdist(torch.autograd.Function):
    """min over V of d^2(x, y) + y_bias with the O(M) argmin-gather backward
    (``chamfer.py:95-178``): the gradient flows only through each query's
    selected target, so no [..., M, V] tensor is built backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, y: torch.Tensor, y_bias: torch.Tensor) -> torch.Tensor:
        batch = x.shape[:-2]
        M, V = x.shape[-2], y.shape[-2]
        xf = x.reshape(-1, M, 3).contiguous()
        yf = y.reshape(-1, V, 3).contiguous()
        bf = y_bias.expand(y.shape[:-1]).reshape(-1, V).contiguous()
        val, idx = K.min_sqdist_forward(xf, yf, bf)
        ctx.save_for_backward(xf, yf, idx)
        ctx.shapes = (x.shape, y.shape, y_bias.shape)
        return val.reshape(batch + (M,))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        xf, yf, idx = ctx.saved_tensors
        x_shape, y_shape, bias_shape = ctx.shapes
        B, M = idx.shape
        V = yf.shape[1]
        gf = g.reshape(B, M).contiguous()
        y_near = torch.gather(yf, 1, idx[..., None].expand(B, M, 3))
        diff = 2.0 * (xf - y_near) * gf[..., None]  # d d2 / dx
        dx = diff.reshape(x_shape) if ctx.needs_input_grad[0] else None
        dy = dbias = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dy_f, dbias_f = K.min_sqdist_backward(idx, diff, gf, V)
            dy = dy_f.reshape(y_shape)
            dbias = dbias_f.reshape(y_shape[:-1]).sum_to_size(bias_shape)
        return dx, dy, dbias


def min_sqdist(x: torch.Tensor, y: torch.Tensor, y_bias: torch.Tensor) -> torch.Tensor:
    """[..., M, 3] x [..., V, 3] x [..., V] (leading dims broadcast) -> [..., M]."""
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2], y_bias.shape[:-1])
    return MinSqdist.apply(x.expand(batch + x.shape[-2:]), y.expand(batch + y.shape[-2:]),
                           y_bias.expand(batch + y.shape[-2:-1]))


def _reduce(t: torch.Tensor, batch_dims: int) -> torch.Tensor:
    return t.flatten(batch_dims).sum(-1) if t.dim() > batch_dims else t


def _broadcast_clouds(x: torch.Tensor, y: torch.Tensor):
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    return x.expand(batch + x.shape[-2:]), y.expand(batch + y.shape[-2:])


def masked_chamfer(x: torch.Tensor, y: torch.Tensor, x_weights: Optional[torch.Tensor] = None,
                   single_directional: bool = True, batch_dims: int = 0) -> torch.Tensor:
    """Weighted chamfer: sum(w * min_v d^2) / sum(w) over every (frame,
    marker), plus the unweighted mean of the reverse direction when
    bidirectional (``chamfer.py:248-272``)."""
    x, y = _broadcast_clouds(x, y)
    if x_weights is None:
        x_weights = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    zero_y = torch.zeros((), dtype=y.dtype, device=y.device).expand(y.shape[:-1])
    d2_x = min_sqdist(x, y, zero_y)
    w = x_weights.to(x.dtype).expand(d2_x.shape)
    loss = _reduce(d2_x * w, batch_dims) / torch.clamp_min(_reduce(w, batch_dims), 1e-12)
    if single_directional:
        return loss
    zero_x = torch.zeros((), dtype=x.dtype, device=x.device).expand(x.shape[:-1])
    d2_y = min_sqdist(y, x, zero_x)
    return loss + d2_y.flatten(batch_dims).mean(-1)


def masked_chamfer_vertex_subset(x: torch.Tensor, y: torch.Tensor, x_mask: torch.Tensor,
                                 y_mask: torch.Tensor, single_directional: bool = True,
                                 batch_dims: int = 0) -> torch.Tensor:
    """Chamfer against a masked vertex subset (``chamfer.py:285-328``):
    invalid vertices (and, backward, invalid markers) are pushed away by a
    1e10 bias instead of gathered, so every subset shares one shape."""
    x, y = _broadcast_clouds(x, y)
    ym = y_mask.to(x.dtype).expand(y.shape[:-1])
    xm = x_mask.to(x.dtype).expand(x.shape[:-1])
    y_bias = (1.0 - (ym > 0).to(x.dtype)) * BIG
    d2_x = min_sqdist(x, y, y_bias)
    loss = _reduce(d2_x * xm, batch_dims) / torch.clamp_min(_reduce(xm, batch_dims), 1e-12)
    if single_directional:
        return loss
    x_bias = (1.0 - (xm > 0).to(x.dtype)) * BIG
    d2_y = min_sqdist(y, x, x_bias)
    return loss + _reduce(d2_y * ym, batch_dims) / torch.clamp_min(_reduce(ym, batch_dims), 1e-12)


def summed_frame_distances(markers: torch.Tensor, vertices: torch.Tensor,
                           frame_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_f w_f ||marker_mf - vertex_vf||: markers [F, M, 3], vertices
    [..., F, V, 3] -> [..., M, V].  Frames are added one at a time, in
    order, as the reference's scan does, so only an [..., M, V] accumulator
    is ever held (no [F, M, V] tensor)."""
    F, M = markers.shape[0], markers.shape[1]
    acc = torch.zeros(vertices.shape[:-3] + (M, vertices.shape[-2]),
                      dtype=markers.dtype, device=markers.device)
    for f in range(F):
        d = torch.sqrt(squared_distance_matrix(markers[f], vertices[..., f, :, :]) + 1e-18)
        acc = acc + (d if frame_weights is None else d * frame_weights[f])
    return acc


def mean_nearest_vertex_over_frames(markers: torch.Tensor, vertices: torch.Tensor,
                                    frame_mask: torch.Tensor) -> torch.Tensor:
    """argmin_v of mean_f ||marker_mf - vertex_vf|| over masked frames
    (``chamfer.py:366-394``): markers [F, M, 3], vertices [..., F, V, 3],
    frame_mask [F] -> vertex ids [..., M]."""
    w = frame_mask.to(markers.dtype)
    acc = summed_frame_distances(markers, vertices, w)
    return (acc / torch.clamp_min(w.sum(), 1.0)).argmin(dim=-1)
