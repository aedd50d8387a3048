"""Vertex-sharded clouds and the reductions over V across shards (the model
axis of ``parallel/mesh.py``).

A ``VertexShards`` holds a [..., V, 3] cloud as contiguous vertex blocks,
block s on its own device and holding global vertices ``offsets[s]`` to
``offsets[s] + V_s - 1``.  The reductions over V run on each block where it
lies, with the port's kernels on CUDA blocks (the rank kernel, the forward
and backward kernels of ``min_sqdist``), and combine across blocks on the
lanes' device (``home``): each block's pick is measured the same way in
every block (its exact squared distance, or its distance about the whole
frame's centroid), and the least wins, the lower block on a tie, so the
global argmin keeps the unsharded scan's rule (the lowest vertex id among
equal values).  This combine takes the place of the collective GSPMD
inserts in the JAX package.  A gradient reaches only the winning block.

``masked_chamfer``, ``masked_chamfer_vertex_subset``, ``nearest_vertex_frames``
and ``mean_nearest_vertex_over_frames`` (``ops/chamfer.py``) and the
stages' rank dispatch here when handed a ``VertexShards``; ``chamfer_by_part``
reads one through ``index_select``; the rest (``summed_frame_distances``,
the point-mesh distance, the ground loss on vertices, the SDF soft
assignment, the coarse-to-fine rank) take ``dense()``, the blocks gathered
on ``home``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from uuo_mocap_tpu_torch.ops import chamfer_kernels as K


class VertexShards:
    """A [..., V, 3] cloud split by vertex: ``parts[s]`` [..., V_s, 3] on its
    block's device, global vertex ``offsets[s] + v`` at row v of block s."""

    def __init__(self, parts: Sequence[torch.Tensor], offsets: Sequence[int],
                 home: torch.device):
        self.parts = list(parts)
        self.offsets = list(offsets)
        self.home = home

    @property
    def num_vertices(self) -> int:
        return self.offsets[-1] + self.parts[-1].shape[-2]

    @property
    def shape(self) -> torch.Size:
        return self.parts[0].shape[:-2] + (self.num_vertices, self.parts[0].shape[-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.home

    def dim(self) -> int:
        return self.parts[0].dim()

    def dense(self) -> torch.Tensor:
        """The whole cloud on ``home``."""
        return torch.cat([p.to(self.home) for p in self.parts], dim=-2)

    def blocks(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A [..., V] tensor (on any device, broadcast views included) cut
        into the blocks' column ranges, each on its block's device."""
        return [t[..., o:o + p.shape[-2]].to(p.device) for o, p in zip(self.offsets, self.parts)]

    def index_select(self, dim: int, ids: torch.Tensor) -> torch.Tensor:
        """Rows at global vertex ids [K] (``dim`` is the vertex axis), on
        ``home``."""
        if dim % self.dim() != self.dim() - 2:
            raise ValueError("VertexShards.index_select selects along the vertex axis only")
        return take_rows(self.parts, self.offsets, ids, self.home, axis=-2)


def take_rows(parts: Sequence[torch.Tensor], offsets: Sequence[int], ids: torch.Tensor,
              home: torch.device, axis: int = 0) -> torch.Tensor:
    """Rows of a vertex-split tensor at global ids: each id read from the
    block that owns it (``axis`` is the vertex axis of every block; ids
    [...] index it), gathered on ``home``."""
    out = None
    for o, p in zip(offsets, parts):
        n = p.shape[axis]
        local = ids.to(home) - o
        inside = (local >= 0) & (local < n)
        picked = p.index_select(axis, local.clamp(0, n - 1).reshape(-1).to(p.device))
        picked = picked.reshape(p.shape[:axis % p.dim()] + ids.shape
                                + p.shape[axis % p.dim() + 1:]).to(home)
        mask = inside.reshape((1,) * (axis % p.dim()) + inside.shape
                              + (1,) * (p.dim() - axis % p.dim() - 1))
        out = picked if out is None else torch.where(mask, picked, out)
    return out


def dense(v):
    """A ``VertexShards`` gathered on its home device; a tensor as it is."""
    return v.dense() if isinstance(v, VertexShards) else v


def _combine(vals: Sequence[torch.Tensor], idxs: Sequence[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The least value over blocks, the lower block winning a tie, with its
    global id.  vals / idxs [S x [...]] on one device."""
    val, idx = vals[0], idxs[0]
    for v, i in zip(vals[1:], idxs[1:]):
        take = v < val
        val, idx = torch.where(take, v, val), torch.where(take, i, idx)
    return val, idx


def _exact_d2(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """|x - y[idx]|^2 (+ bias[idx]), no gradient: a block's pick measured
    the same way in every block, so equal vertices tie exactly and the
    lower block wins.  x [..., M, 3], y [..., V, 3], idx [..., M], bias
    [..., V] broadcast with y's leading dims."""
    with torch.no_grad():
        yp = torch.gather(y.expand(idx.shape[:-1] + y.shape[-2:]), -2,
                          idx[..., None].expand(idx.shape + (3,)))
        d2 = ((x - yp) ** 2).sum(-1)
        if bias is not None:
            d2 = d2 + torch.gather(bias.expand(idx.shape[:-1] + bias.shape[-1:]), -1, idx)
        return d2


def min_value(x: torch.Tensor, ys: VertexShards, y_bias: torch.Tensor) -> torch.Tensor:
    """min over V of d^2(x, y) + y_bias, differentiable: x [..., M, 3] on
    ``ys.home``, y_bias [..., V] (broadcast with the clouds) -> [..., M].
    Each block runs ``min_sqdist`` (the forward kernel, and the backward
    kernel when differentiated, on CUDA); the blocks' picks are compared by
    their exact distance (the lower block on a tie) and the winner's value
    taken, so the gradient flows into the winning block only."""
    from uuo_mocap_tpu_torch.ops.chamfer import min_sqdist_argmin

    vals, exact, blk = [], [], []
    for s, (p, b) in enumerate(zip(ys.parts, ys.blocks(y_bias))):
        xs = x.to(p.device)
        v, i = min_sqdist_argmin(xs, p, b)
        vals.append(v.to(ys.home))
        exact.append(_exact_d2(xs, p, i, b).to(ys.home))
        blk.append(torch.full_like(i, s).to(ys.home))
    win = _combine(exact, blk)[1]
    return torch.stack(vals).gather(0, win[None])[0]


def reverse_terms(ys: VertexShards, x: torch.Tensor, x_bias: torch.Tensor
                  ) -> List[torch.Tensor]:
    """The reverse direction per block: each vertex's min over the markers,
    min_m d^2(y_v, x_m) + x_bias_m -> [[..., V_s]] on ``home``."""
    from uuo_mocap_tpu_torch.ops.chamfer import min_sqdist

    return [min_sqdist(p, x.to(p.device), x_bias.to(p.device)).to(ys.home) for p in ys.parts]


def _batch_of(x: torch.Tensor, ys: VertexShards):
    batch = torch.broadcast_shapes(x.shape[:-2], ys.shape[:-2])
    return x.expand(batch + x.shape[-2:]), batch


def masked_chamfer(x: torch.Tensor, ys: VertexShards, x_weights: Optional[torch.Tensor],
                   single_directional: bool, batch_dims: int) -> torch.Tensor:
    """``ops.chamfer.masked_chamfer`` on a vertex-split target cloud."""
    from uuo_mocap_tpu_torch.ops.chamfer import _reduce

    x, batch = _batch_of(x, ys)
    if x_weights is None:
        x_weights = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    zero_y = torch.zeros((), dtype=x.dtype, device=x.device).expand(batch + (ys.num_vertices,))
    d2_x = min_value(x, ys, zero_y)
    w = x_weights.to(x.dtype).expand(d2_x.shape)
    loss = _reduce(d2_x * w, batch_dims) / torch.clamp_min(_reduce(w, batch_dims), 1e-12)
    if single_directional:
        return loss
    zero_x = torch.zeros((), dtype=x.dtype, device=x.device).expand(x.shape[:-1])
    parts = [t.expand(batch + t.shape[-1:]) for t in reverse_terms(ys, x, zero_x)]
    count = sum(t.flatten(batch_dims).shape[-1] for t in parts)
    total = sum(t.flatten(batch_dims).sum(-1) for t in parts)
    return loss + total / count


def masked_chamfer_vertex_subset(x: torch.Tensor, ys: VertexShards, x_mask: torch.Tensor,
                                 y_mask: torch.Tensor, single_directional: bool,
                                 batch_dims: int, big: float) -> torch.Tensor:
    """``ops.chamfer.masked_chamfer_vertex_subset`` on a vertex-split target
    cloud: the reverse term's masked mean sums its numerator and its
    denominator over the blocks."""
    from uuo_mocap_tpu_torch.ops.chamfer import _reduce

    x, batch = _batch_of(x, ys)
    V = ys.num_vertices
    ym = y_mask.to(x.dtype).expand(batch + (V,))
    xm = x_mask.to(x.dtype).expand(x.shape[:-1])
    y_bias = (1.0 - (ym > 0).to(x.dtype)) * big
    d2_x = min_value(x, ys, y_bias)
    loss = _reduce(d2_x * xm, batch_dims) / torch.clamp_min(_reduce(xm, batch_dims), 1e-12)
    if single_directional:
        return loss
    x_bias = (1.0 - (xm > 0).to(x.dtype)) * big
    ym = ym * (xm.amax(dim=-1, keepdim=True) > 0).to(x.dtype)
    num = den = 0.0
    for d2_y, o in zip(reverse_terms(ys, x, x_bias), ys.offsets):
        ym_s = ym[..., o:o + d2_y.shape[-1]]
        num = num + _reduce(d2_y * ym_s, batch_dims)
        den = den + _reduce(ym_s, batch_dims)
    return loss + num / torch.clamp_min(den, 1e-12)


def rank_nearest(markers: torch.Tensor, ys: VertexShards,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nearest vertex per (lane, frame, marker), no gradient: markers
    [(L,) F, M, 3], a [L, F, V, 3] cloud, bias [L, V] or None -> global ids
    [L, F, M].  The rank kernel runs once per block (on CUDA), at the
    block's V; the blocks' picks are compared by their exact squared
    distance plus bias."""
    markers = markers.expand(ys.shape[:-2] + markers.shape[-2:])
    biases = ys.blocks(bias) if bias is not None else [None] * len(ys.parts)
    vals, idxs = [], []
    for o, p, b in zip(ys.offsets, ys.parts, biases):
        mk = markers.to(p.device)
        idx = K.rank_nearest(mk, p, b)
        vals.append(_exact_d2(mk, p, idx, None if b is None else b[:, None, :]).to(ys.home))
        idxs.append(idx.to(ys.home) + o)
    return _combine(vals, idxs)[1]


def nearest_vertex_frames(markers: torch.Tensor, ys: VertexShards
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.chamfer.nearest_vertex_frames`` on a vertex-split cloud: the
    rank kernel per block, the picks compared as there (centered on the
    whole frame's vertex centroid)."""
    V = ys.num_vertices
    c = sum(p.sum(dim=-2, keepdim=True).to(ys.home) for p in ys.parts) / V
    x = markers.expand(ys.shape[:-2] + markers.shape[-2:]) - c
    vals, idxs = [], []
    for o, p in zip(ys.offsets, ys.parts):
        idx = K.rank_nearest(markers.expand(p.shape[:-2] + markers.shape[-2:]).to(p.device), p)
        y = torch.gather(p, -2, idx[..., None].expand(idx.shape + (3,))).to(ys.home) - c
        d2 = (x * x).sum(-1) + (y * y).sum(-1) - 2.0 * (x * y).sum(-1)
        vals.append(torch.clamp_min(d2, 0.0))
        idxs.append(idx.to(ys.home) + o)
    return _combine(vals, idxs)


def mean_nearest_vertex_over_frames(markers: torch.Tensor, ys: VertexShards,
                                    frame_mask: torch.Tensor) -> torch.Tensor:
    """``ops.chamfer.mean_nearest_vertex_over_frames`` on a vertex-split
    cloud: each block's frame-summed distances about the whole frame's
    centroid (so equal vertices in two blocks tie exactly) and their (min,
    argmin), then the combine."""
    w = frame_mask.to(markers.dtype)
    norm = torch.clamp_min(w.sum(-1), 1.0)[..., None, None]
    c = sum(p.sum(dim=-2, keepdim=True).to(ys.home) for p in ys.parts) / ys.num_vertices
    x = markers - c  # [..., F, M, 3]
    vals, idxs = [], []
    for o, p in zip(ys.offsets, ys.parts):
        xs, ws = x.to(p.device), w.to(p.device)
        y = p - c.to(p.device)
        x2 = (xs * xs).sum(-1)[..., :, None]
        y2 = (y * y).sum(-1)[..., None, :]
        acc = 0.0
        for f in range(xs.shape[-3]):  # frame by frame, as ``summed_frame_distances``
            d2 = torch.clamp_min(x2[..., f, :, :] + y2[..., f, :, :]
                                 - 2.0 * (xs[..., f, :, :] @ y[..., f, :, :].transpose(-1, -2)),
                                 0.0)
            acc = acc + torch.sqrt(d2 + 1e-18) * ws[..., f, None, None]
        v, i = (acc / norm.to(p.device)).min(dim=-1)
        vals.append(v.to(ys.home))
        idxs.append(i.to(ys.home) + o)
    return _combine(vals, idxs)[1]
