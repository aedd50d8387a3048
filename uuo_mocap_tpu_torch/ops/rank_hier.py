"""Hierarchical (coarse-to-fine) nearest-vertex ranking (counterpart of
``uuo_mocap_tpu/ops/rank_hier.py``; ``optimizer.rank_hier``).

Each (frame, marker) is ranked against C posed coarse centres, a
farthest-point subsample of the template; then exactly, in FP32, among the
fine vertices of the top-P centres' template-space neighbourhoods.  The
distance work per (frame, marker) drops from V to C + P * K, and a pick can
differ from the dense argmin only where the true nearest vertex lies
outside every candidate cell.  Not a TPU kernel: the reference writes it
in plain XLA, and the port in plain PyTorch.  The table (``RankTable``,
``build_rank_table``) is numpy on the host, a copy of the reference's, so
one template gives the reference's table element for element.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from uuo_mocap_tpu_torch.ops.chamfer import squared_distance_matrix


class RankTable(NamedTuple):
    """The static coarse-to-fine candidate structure, in template space."""

    coarse_ids: np.ndarray  # [C] int32: vertex ids of the coarse centres
    cand_ids: np.ndarray  # [C, K] int32: each cell's fine candidates
    top_p: int  # how many coarse picks' candidates are searched


def _farthest_point_sample(points: np.ndarray, count: int, seed_idx: int = 0) -> np.ndarray:
    """Greedy farthest-point subsample (``rank_hier.py:42-53``)."""
    chosen = np.empty(count, np.int64)
    chosen[0] = seed_idx
    d2 = np.sum((points - points[seed_idx]) ** 2, axis=1)
    for i in range(1, count):
        nxt = int(np.argmax(d2))
        chosen[i] = nxt
        d2 = np.minimum(d2, np.sum((points - points[nxt]) ** 2, axis=1))
    return chosen


def build_rank_table(template: np.ndarray, num_coarse: int = 640, num_cell_neighbors: int = 10,
                     top_p: int = 2) -> RankTable:
    """The table of the rest-pose template [V, 3] (``rank_hier.py:56-108``):
    each vertex is owned by its nearest centre; a cell's candidates are its
    centre and the vertices owned by its ``num_cell_neighbors`` nearest
    cells (itself included), padded by repeating the first candidate."""
    template = np.asarray(template, np.float64)
    centers_idx = _farthest_point_sample(template, num_coarse)
    centers = template[centers_idx]
    d2_vc = (np.sum(template ** 2, 1)[:, None] - 2.0 * template @ centers.T
             + np.sum(centers ** 2, 1)[None, :])
    owner = np.argmin(d2_vc, axis=1)
    d2_cc = (np.sum(centers ** 2, 1)[:, None] - 2.0 * centers @ centers.T
             + np.sum(centers ** 2, 1)[None, :])
    nbr = np.argsort(d2_cc, axis=1)[:, :num_cell_neighbors]
    members = [np.where(owner == c)[0] for c in range(num_coarse)]
    cand_lists = [np.concatenate([centers_idx[c:c + 1]] + [members[int(b)] for b in nbr[c]])
                  for c in range(num_coarse)]
    K = max(len(c) for c in cand_lists)
    cand_ids = np.stack([np.pad(c, (0, K - len(c)), mode="edge") for c in cand_lists])
    return RankTable(centers_idx.astype(np.int32), cand_ids.astype(np.int32), int(top_p))


_TABLE_CACHE: dict = {}


def rank_table_for(model, **kw) -> RankTable:
    """The table of ``model``'s template, built once per model and keyword
    set (``rank_hier.py:111-128``).  The cache holds the model weakly,
    checked by identity, and drops dead entries on every call."""
    for k in [k for k, (ref, _) in _TABLE_CACHE.items() if ref() is None]:
        del _TABLE_CACHE[k]
    key = (id(model), tuple(sorted(kw.items())))
    hit = _TABLE_CACHE.get(key)
    if hit is not None and hit[0]() is model:
        return hit[1]
    table = build_rank_table(model.v_template.detach().cpu().numpy(), **kw)
    try:
        _TABLE_CACHE[key] = (weakref.ref(model), table)
    except TypeError:  # a model type without weak references: not cached
        pass
    return table


def hierarchical_nearest(markers: torch.Tensor, verts: torch.Tensor, table: RankTable,
                         frame_chunk: int = 64) -> torch.Tensor:
    """Coarse-to-fine nearest vertex per marker (``rank_hier.py:131-174``):
    markers [..., M, 3], verts [..., V, 3] (the leading dims flattened into
    frames) -> vertex ids [..., M] int64.  ``frame_chunk`` frames at a time
    bound the [chunk, M, C] coarse block and the [chunk, M, P K, 3]
    candidate gather.  The reference zero-pads the last chunk to keep one
    compiled shape; nothing is compiled per shape here, so it runs as it
    is."""
    lead, M = markers.shape[:-2], markers.shape[-2]
    mk = markers.reshape(-1, M, 3)
    vs = verts.reshape(-1, verts.shape[-2], 3)
    dev = vs.device
    coarse_ids = torch.as_tensor(table.coarse_ids, dtype=torch.long, device=dev)
    cand_ids = torch.as_tensor(table.cand_ids, dtype=torch.long, device=dev)
    C = coarse_ids.shape[0]
    out = []
    for f0 in range(0, mk.shape[0], frame_chunk):
        m_c, v_c = mk[f0:f0 + frame_chunk], vs[f0:f0 + frame_chunk]
        d2c = squared_distance_matrix(m_c, v_c[:, coarse_ids])  # [Cf, M, C]
        picks = []
        for p in range(table.top_p):
            ci = d2c.argmin(dim=-1)  # [Cf, M]
            picks.append(ci)
            if p + 1 < table.top_p:  # the pick is excluded from the next
                d2c = d2c + 1e30 * torch.nn.functional.one_hot(ci, C).to(d2c.dtype)
        cand = torch.cat([cand_ids[c] for c in picks], dim=-1)  # [Cf, M, P K]
        Cf = cand.shape[0]
        gathered = torch.gather(v_c, 1, cand.reshape(Cf, -1, 1).expand(-1, -1, 3))
        d2f = ((m_c[:, :, None, :] - gathered.reshape(cand.shape + (3,))) ** 2).sum(-1)
        out.append(cand.gather(-1, d2f.argmin(dim=-1, keepdim=True))[..., 0])
    return torch.cat(out).reshape(lead + (M,))
