"""The held-out data and metrics that ``checkpoints/MANIFEST.json`` records
(the port's copy of ``uuo_mocap_tpu/models/train.py``'s
``_segmentation_batch``, ``_surface_samples`` and ``pos_diff_pool``, and of
``tools/train_demo_checkpoints.py``'s ``eval_segmenter``, ``eval_pos2bc``
and ``eval_pos_diff``).  The draws use numpy ``RandomState`` in the
reference's order, so the same seeds give the same data; everything runs on
the body model's device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward
from uuo_mocap_tpu_torch.data.synthetic import random_pose_sequence
from uuo_mocap_tpu_torch.models.marker_segmenter import WINDOW

HELD_OUT_SEED = 777_001  # never used by the training streams


def _segmentation_batch(model: BodyModel, batch: int, num_markers: int, seed: int,
                        vertex_ids: Optional[np.ndarray] = None):
    """One batch of marker windows and part labels (``train.py:43-67``):
    WINDOW-frame random motions, markers at random surface vertices (or at
    ``vertex_ids``), each labelled with its vertex's argmax-LBS part.
    -> (points [B, W, M, 3], labels [B, M], joints [B, W, 22, 3])."""
    dev = model.device
    rng = np.random.RandomState(seed)
    vertex_labels = model.vertex_part_labels().cpu().numpy()
    gts = [random_pose_sequence(WINDOW, seed=seed * 1000 + b, yaw=rng.uniform(0, 6.28),
                                device=dev) for b in range(batch)]
    pose = torch.stack([g.pose_body for g in gts])
    betas = torch.stack([g.betas.expand(WINDOW, 10) for g in gts])
    root = torch.stack([g.root_orient for g in gts])
    trans = torch.stack([g.trans for g in gts])
    if vertex_ids is not None:
        vid = np.broadcast_to(np.asarray(vertex_ids), (batch, len(vertex_ids))).copy()
    else:
        vid = np.stack([rng.choice(model.num_vertices, num_markers, replace=False)
                        for _ in range(batch)])
    with torch.no_grad():
        out = lbs_forward(model, pose, betas, root, trans)
    ids = torch.as_tensor(vid, device=dev)
    pts = torch.stack([v[:, i] for v, i in zip(out["vertices"], ids)])  # [B, W, M, 3]
    labels = torch.as_tensor(vertex_labels[vid], device=dev)
    return pts, labels, out["joints"][..., :22, :]


def _surface_samples(model: BodyModel, n: int, seed: int):
    """Random barycentric points on the template surface (``train.py:
    216-227``) -> (points [n, 3], face vertex ids [n, 3], barycentric
    [n, 3]) on the model's device."""
    rng = np.random.RandomState(seed)
    faces = np.asarray(model.faces)
    v = model.v_template.detach().cpu().numpy()
    fidx = rng.randint(0, faces.shape[0], n)
    bary = rng.dirichlet((1.0, 1.0, 1.0), size=n).astype(np.float32)
    pts = np.einsum("nk,nkd->nd", bary, v[faces[fidx]])
    dev = model.device
    return (torch.as_tensor(pts, device=dev), torch.as_tensor(faces[fidx], device=dev),
            torch.as_tensor(bary, device=dev))


def _mesh_distance(model: BodyModel, points: torch.Tensor, key: str, chunk: int = 512):
    """``point_mesh_distance`` on the template, ``chunk`` points at a time."""
    from uuo_mocap_tpu_torch.ops.point_mesh import point_mesh_distance

    with torch.no_grad():
        return torch.cat([point_mesh_distance(points[c:c + chunk], model.v_template,
                                              model.faces)[key]
                          for c in range(0, points.shape[0], chunk)])


def pos_diff_pool(model: BodyModel, n: int, noise: float, seed: int,
                  chunk: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """(queries [n, 3], displacements to the nearest surface point [n, 3])
    for PosDiff (``train.py:347-394``, without its disk cache): surface
    samples moved by Gaussian noise of ``noise`` metres."""
    pts, _, _ = _surface_samples(model, n, seed)
    rng = np.random.RandomState(seed ^ 0xA5A5)
    q = pts.cpu().numpy() + rng.randn(n, 3).astype(np.float32) * noise
    cp = _mesh_distance(model, torch.as_tensor(q, device=model.device), "closest_point", chunk)
    return q, cp.cpu().numpy() - q


def eval_segmenter(model: BodyModel, net, multimodal: bool, batches: int = 4,
                   num_markers: int = 41, layout: Optional[str] = None) -> float:
    """Held-out accuracy of a segmenter (``train_demo_checkpoints.py:
    53-83``): ``batches`` batches of 8 windows, random vertices or the named
    layout's."""
    vids = None
    if layout:
        from uuo_mocap_tpu_torch.data.marker_layout import resolve_layout_vertex_ids

        vids = resolve_layout_vertex_ids(layout, model)
    correct = total = 0
    with torch.no_grad():
        for b in range(batches):
            pts, labels, jts = _segmentation_batch(model, 8, num_markers,
                                                   seed=HELD_OUT_SEED + b, vertex_ids=vids)
            logits = net(pts, jts) if multimodal else net(pts)
            correct += int((logits.argmax(dim=-1) == labels).sum())
            total += labels.numel()
    return correct / total


def eval_pos2bc(model: BodyModel, net, n: int = 2048) -> float:
    """Mean distance (m) between the soft assignment's expected point on the
    template and the true surface sample (``train_demo_checkpoints.py:
    98-108``)."""
    pts, _, _ = _surface_samples(model, n, seed=HELD_OUT_SEED)
    with torch.no_grad():
        expected = torch.softmax(net(pts), dim=-1) @ model.v_template
        return float(torch.linalg.norm(expected - pts, dim=-1).mean())


def eval_pos_diff(model: BodyModel, net, n: int = 2048, noise: float = 0.05
                  ) -> Tuple[float, float]:
    """Mean distance (m) to the surface of held-out noised queries after and
    before the net's displacement (``train_demo_checkpoints.py:111-133``)."""
    q, _ = pos_diff_pool(model, n, noise, HELD_OUT_SEED)
    q_t = torch.as_tensor(q, device=model.device)
    with torch.no_grad():
        moved = q_t + net(q_t)
    return (float(_mesh_distance(model, moved, "distance").cpu().numpy().mean()),
            float(_mesh_distance(model, q_t, "distance").cpu().numpy().mean()))
