"""What the reference works out again from a solve's answers: the chamfer
score that picks a window's hypothesis, the nearest-vertex picks behind the
markers' labels and the final marker pass, and the joint error against the
ground truth.  Plain PyTorch in any dtype and on any device; with ``tf32``
every matmul reads TF32 operands (the control)."""
from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.body import lbs

BODY_JOINTS = 22  # the pelvis and 21 body joints: the hands and extra joints are not fitted
_FRAME_BLOCK = 32  # frames per block of the [frames, markers, vertices, 3] differences


def _tensors(params: Dict, dtype, device) -> Dict[str, torch.Tensor]:
    """The body parameters as tensors; betas as [1 or F, 10]."""
    out = {k: torch.as_tensor(params[k]).to(device=device, dtype=dtype)
           for k in ("pose_body", "betas", "root_orient", "trans")}
    out["betas"] = out["betas"].reshape(-1, out["betas"].shape[-1])
    return out


def chamfer_score(model: Dict[str, torch.Tensor], markers, params: Dict,
                  tf32: bool = False) -> float:
    """sum(w * min_v |m - v|^2) / sum(w) over every (frame, marker), w = 1
    for a marker not at the origin: the single-directional chamfer the
    solve scores hypotheses by, for markers [F, M, 3] and the body
    ``params`` (pose_body [F, 23, 3, 3], betas [F or 1, 10], root_orient
    [F, 1, 3, 3], trans [F, 3]), posed by the model's dtype and device."""
    dt, dev = model["v_template"].dtype, model["v_template"].device
    p = _tensors(params, dt, dev)
    mk = torch.as_tensor(markers).to(device=dev, dtype=dt)
    verts = lbs(model, p["pose_body"], p["betas"][:1], p["root_orient"], p["trans"],
                tf32=tf32)["vertices"]
    w = (mk.abs().sum(-1) != 0).to(dt)
    total = torch.zeros((), dtype=dt, device=dev)
    for f0 in range(0, mk.shape[0], _FRAME_BLOCK):
        d = mk[f0:f0 + _FRAME_BLOCK, :, None, :] - verts[f0:f0 + _FRAME_BLOCK, None, :, :]
        total = total + (((d * d).sum(-1)).amin(-1) * w[f0:f0 + _FRAME_BLOCK]).sum()
    return float(total / torch.clamp_min(w.sum(), 1e-12))


def mpjpe_mm(model: Dict[str, torch.Tensor], params: Dict, gt: Dict) -> float:
    """Mean per-joint position error of the body joints, in mm."""
    dt, dev = model["v_template"].dtype, model["v_template"].device
    p, g = _tensors(params, dt, dev), _tensors(gt, dt, dev)
    ids = torch.zeros(0, dtype=torch.long, device=dev)  # joints only
    j_p = lbs(model, p["pose_body"], p["betas"][:1], p["root_orient"], p["trans"], ids)["joints"]
    j_g = lbs(model, g["pose_body"], g["betas"][:1], g["root_orient"], g["trans"], ids)["joints"]
    return float(torch.linalg.norm(j_p - j_g, dim=-1)[:, :BODY_JOINTS].mean()) * 1e3


def mean_distances(model: Dict[str, torch.Tensor], markers, params: Dict,
                   tf32: bool = False) -> torch.Tensor:
    """mean_f |m_fm - v_fv| for every marker m and vertex v: markers [F, M,
    3], taken as they stand (an occluded marker at the origin counts, as it
    does in the picks the solve makes), the body ``params`` posed by the
    model's dtype and device -> [M, V].  The argmin over v is the vertex
    that the solve's nearest-vertex picks choose for marker m."""
    dt, dev = model["v_template"].dtype, model["v_template"].device
    p = _tensors(params, dt, dev)
    mk = torch.as_tensor(markers).to(device=dev, dtype=dt)
    verts = lbs(model, p["pose_body"], p["betas"][:1], p["root_orient"], p["trans"],
                tf32=tf32)["vertices"]
    total = torch.zeros(mk.shape[1], verts.shape[1], dtype=dt, device=dev)
    for f0 in range(0, mk.shape[0], _FRAME_BLOCK):
        d = mk[f0:f0 + _FRAME_BLOCK, :, None, :] - verts[f0:f0 + _FRAME_BLOCK, None, :, :]
        total = total + torch.sqrt((d * d).sum(-1)).sum(0)
    return total / mk.shape[0]


def vertex_labels(model: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each vertex's body part: the joint of its largest skinning weight -> [V]."""
    return model["lbs_weights"].argmax(-1)


def label_gap_mm(dist: torch.Tensor, labels_v: torch.Tensor, labels) -> float:
    """How far, in mm of mean distance, the nearest vertex of the part that
    each marker is labelled with lies beyond the nearest vertex of all,
    worst marker: 0 where every label is the part of the marker's nearest
    vertex.  dist [M, V] (``mean_distances``), labels_v [V], labels [M]."""
    lab = torch.as_tensor(labels, device=dist.device).long()
    same = labels_v[None, :] == lab[:, None]
    inf = torch.full_like(dist, float("inf"))
    gap = torch.where(same, dist, inf).amin(-1) - dist.amin(-1)
    return float(gap.max()) * 1e3


def pick_gap_mm(dist: torch.Tensor, ids) -> float:
    """How far, in mm of mean distance, each marker's picked vertex lies
    beyond its nearest vertex, worst marker: 0 where every pick is the
    nearest.  dist [M, V], ids [M]."""
    ids = torch.as_tensor(ids, device=dist.device).long()
    return float((dist.gather(1, ids[:, None])[:, 0] - dist.amin(-1)).max()) * 1e3
