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

from typing import List, Optional, Sequence, Tuple

import numpy as np
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
    # A frame with no valid marker (a frame-bucket padding frame) has no
    # reverse term.  The reference keeps it: its vertices' nearest "marker"
    # is the 1e10 bias, and a 1e10-scale sum leaves no float32 bits for the
    # real frames, so its part scores become rounding noise (ROADMAP C.4).
    ym = ym * (xm.amax(dim=-1, keepdim=True) > 0).to(x.dtype)
    return loss + _reduce(d2_y * ym, batch_dims) / torch.clamp_min(_reduce(ym, batch_dims), 1e-12)


def chamfer_bidirectional(x: torch.Tensor, y: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """Unweighted bidirectional chamfer: the mean of each direction's d2,
    summed (``chamfer.py:275-282``)."""
    x, y = _broadcast_clouds(x, y)
    zero_x = torch.zeros((), dtype=x.dtype, device=x.device).expand(x.shape[:-1])
    zero_y = torch.zeros((), dtype=y.dtype, device=y.device).expand(y.shape[:-1])
    return (min_sqdist(x, y, zero_y).flatten(batch_dims).mean(-1)
            + min_sqdist(y, x, zero_x).flatten(batch_dims).mean(-1))


def part_vertex_index(vertex_labels, part_ids, device=None) -> List[Tuple[int, torch.Tensor]]:
    """The vertex ids of every part in ``part_ids`` that has an id >= 0 and
    at least one vertex: [(part id, ids [Vp] on ``device``)], in the order
    of ``part_ids`` (a repeated id is listed again).  Host work, done once
    per model."""
    labels = (vertex_labels.cpu().numpy() if isinstance(vertex_labels, torch.Tensor)
              else np.asarray(vertex_labels))
    pids = part_ids.cpu().numpy() if isinstance(part_ids, torch.Tensor) else np.asarray(part_ids)
    if device is None and isinstance(vertex_labels, torch.Tensor):
        device = vertex_labels.device
    out = []
    for pid in pids.reshape(-1).tolist():
        ids = np.nonzero(labels == pid)[0]
        if pid >= 0 and ids.size:
            out.append((int(pid), torch.as_tensor(ids, dtype=torch.long, device=device)))
    return out


def chamfer_by_part(markers: torch.Tensor, vertices: torch.Tensor,
                    marker_labels_mode: torch.Tensor, vertex_labels, part_ids,
                    marker_distance: float, single_directional: bool = False,
                    batch_dims: int = 0,
                    part_index: Optional[Sequence[Tuple[int, torch.Tensor]]] = None) -> torch.Tensor:
    """Per-part chamfer sum (``chamfer.py:331-363``): for each part, the
    chamfer of the part's vertices against the markers labelled with it,
    scored (chamfer - marker_distance)^2; zero for an id < 0 and for a part
    with no vertex or no marker.  markers [..., F, M, 3], vertices
    [..., F, V, 3], marker_labels_mode [..., M] (leading dims broadcast;
    ``batch_dims`` of them are kept in the result).

    The vertices are the queries and the markers the targets (the
    reference's direction); the reverse term is added when bidirectional.
    Each part's vertices are gathered by static ids (``part_index``, or
    computed here from ``vertex_labels`` and ``part_ids``), where the JAX
    package masks all V vertices once per part; the other part's markers
    are pushed away by the 1e10 bias, as there.  A part without markers
    scores 1e10 + d and is zeroed before the sum."""
    if part_index is None:
        part_index = part_vertex_index(vertex_labels, part_ids, vertices.device)
    lead = torch.broadcast_shapes(markers.shape[:-3], vertices.shape[:-3],
                                  marker_labels_mode.shape[:-1])
    F = vertices.shape[-3]
    markers = markers.expand(lead + markers.shape[-3:])
    labels = marker_labels_mode.expand(lead + marker_labels_mode.shape[-1:])
    total = torch.zeros(lead[:batch_dims], dtype=vertices.dtype, device=vertices.device)
    for pid, ids in part_index:
        verts = vertices.index_select(-2, ids).expand(lead + (F, ids.numel(), 3))
        mmask = (labels == pid).to(vertices.dtype)  # [..., M]
        bias = ((1.0 - mmask) * BIG)[..., None, :].expand(lead + (F, mmask.shape[-1]))
        cham = min_sqdist(verts, markers, bias).flatten(batch_dims).mean(-1)
        if not single_directional:
            zero = torch.zeros((), dtype=verts.dtype, device=verts.device).expand(verts.shape[:-1])
            ym = mmask[..., None, :].expand(lead + (F, mmask.shape[-1]))
            d2_y = min_sqdist(markers, verts, zero)
            cham = cham + _reduce(d2_y * ym, batch_dims) / torch.clamp_min(_reduce(ym, batch_dims),
                                                                           1e-12)
        valid = _reduce(mmask, batch_dims) > 0
        total = total + torch.where(valid, (cham - marker_distance) ** 2, torch.zeros_like(cham))
    return total


def nearest_vertex_frames(markers: torch.Tensor, vertices: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame nearest vertex, no gradient: markers [L, F, M, 3], vertices
    [L, F, V, 3] -> (d2 [L, F, M], vertex ids [L, F, M]).  The ids come from
    the rank kernel on CUDA (its plain version on the CPU); d2 is
    ``squared_distance_matrix``'s value at the picked vertex (centered on the
    frame's vertex centroid, clamped at 0), as ``nearest_vertex`` returns it
    (``chamfer.py:89-92``)."""
    idx = K.rank_nearest(markers.expand(vertices.shape[:-2] + markers.shape[-2:]), vertices)
    c = vertices.mean(dim=-2, keepdim=True)
    x = markers - c
    y = torch.gather(vertices, -2, idx[..., None].expand(idx.shape + (3,))) - c
    d2 = (x * x).sum(-1) + (y * y).sum(-1) - 2.0 * (x * y).sum(-1)
    return torch.clamp_min(d2, 0.0), idx


def summed_frame_distances(markers: torch.Tensor, vertices: torch.Tensor,
                           frame_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_f w_f ||marker_mf - vertex_vf||: markers [..., F, M, 3], vertices
    [..., F, V, 3], frame_weights [..., F] (leading lane dims broadcast:
    one sequence shared by every lane, or one per lane) -> [..., M, V].
    Frames are added one at a time, in order, as the reference's scan does,
    so only an [..., M, V] accumulator is ever held (no [F, M, V] tensor)."""
    F, M = markers.shape[-3], markers.shape[-2]
    lead = [markers.shape[:-3], vertices.shape[:-3]]
    if frame_weights is not None:
        lead.append(frame_weights.shape[:-1])
    acc = torch.zeros(torch.broadcast_shapes(*lead) + (M, vertices.shape[-2]),
                      dtype=markers.dtype, device=markers.device)
    for f in range(F):
        d = torch.sqrt(squared_distance_matrix(markers[..., f, :, :], vertices[..., f, :, :]) + 1e-18)
        acc = acc + (d if frame_weights is None else d * frame_weights[..., f, None, None])
    return acc


def mean_nearest_vertex_over_frames(markers: torch.Tensor, vertices: torch.Tensor,
                                    frame_mask: torch.Tensor) -> torch.Tensor:
    """argmin_v of mean_f ||marker_mf - vertex_vf|| over masked frames
    (``chamfer.py:366-394``): markers [..., F, M, 3], vertices [..., F, V, 3],
    frame_mask [..., F] (leading lane dims broadcast) -> vertex ids [..., M]."""
    w = frame_mask.to(markers.dtype)
    acc = summed_frame_distances(markers, vertices, w)
    return (acc / torch.clamp_min(w.sum(-1), 1.0)[..., None, None]).argmin(dim=-1)
