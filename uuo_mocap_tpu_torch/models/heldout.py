"""The held-out metrics that ``checkpoints/MANIFEST.json`` records (the
port's copy of ``tools/train_demo_checkpoints.py``'s ``eval_segmenter``,
``eval_pos2bc`` and ``eval_pos_diff``), on data from the training loops'
generators (``models/train.py``) at a seed no training stream uses.  The
draws use numpy ``RandomState`` in the reference's order, so the same seeds
give the same data; everything runs on the body model's device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from uuo_mocap_tpu_torch.body.model import BodyModel
from uuo_mocap_tpu_torch.models.train import (
    _mesh_distance, _segmentation_batch, _surface_samples, pos_diff_pool)

HELD_OUT_SEED = 777_001  # never used by the training streams


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
