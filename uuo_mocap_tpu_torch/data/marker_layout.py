"""Named marker layouts (counterpart of ``uuo_mocap_tpu/data/marker_layout.py``).

The ``cmu_41`` layout places named markers at SMPL vertices plus a 9.5 mm
normal offset.  Vertex ids resolve from a user-supplied name -> vertex-id
table (the MoSh++ table reproduces the original layout exactly), or by the
deterministic anatomical fallback: per marker, the vertex of its anchor
joint's part (argmax LBS weight) furthest along the anchor direction.  The
fallback runs in numpy on the model's float32 arrays with the reference's
exact arithmetic (float32 mean, float64 score), so both packages pick the
same vertices.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.joints import get_joint_id
from uuo_mocap_tpu_torch.body.model import BodyModel
from uuo_mocap_tpu_torch.ops.geometry import vertex_normals
from uuo_mocap_tpu_torch.settings import MARKER_DISTANCE

# marker name lists per layout (SOMA convention; reference
# ``utils/marker_layout.py:9-51``)
MARKER_LAYOUTS: Dict[str, List[str]] = {
    "cmu_41": [
        "C7", "CLAV", "LANK", "LBHD", "LBWT", "LELB", "LFIN", "LFHD", "LFRM",
        "LFWT", "LHEE", "LIWR", "LKNE", "LMT5", "LOWR", "LSHN", "LSHO", "LTHI",
        "LTOE", "LUPA", "RANK", "RBAK", "RBHD", "RBWT", "RELB", "RFHD", "RFIN",
        "RFWT", "RHEE", "RIWR", "RKNE", "RMT5", "RSHN", "RSHO", "RTHI", "RTOE",
        "RUPA", "STRN", "T10",
    ]
}

# anatomical anchor for the deterministic fallback: marker name ->
# (joint name, direction in body frame to disambiguate within the part)
_ANATOMY: Dict[str, tuple] = {
    "C7": ("neck", (0, 0, -1)), "CLAV": ("neck", (0, 0, 1)),
    "STRN": ("spine3", (0, 0, 1)), "T10": ("spine2", (0, 0, -1)),
    "LANK": ("left_ankle", (1, 0, 0)), "RANK": ("right_ankle", (-1, 0, 0)),
    "LBHD": ("head", (1, 1, -1)), "RBHD": ("head", (-1, 1, -1)),
    "LFHD": ("head", (1, 1, 1)), "RFHD": ("head", (-1, 1, 1)),
    "LBWT": ("left_hip", (1, 1, -1)), "RBWT": ("right_hip", (-1, 1, -1)),
    "LFWT": ("left_hip", (1, 1, 1)), "RFWT": ("right_hip", (-1, 1, 1)),
    "LELB": ("left_elbow", (0, 0, -1)), "RELB": ("right_elbow", (0, 0, -1)),
    "LFIN": ("left_hand", (1, 0, 0)), "RFIN": ("right_hand", (-1, 0, 0)),
    "LFRM": ("left_elbow", (1, 0, 1)), "RBAK": ("right_collar", (-1, 0, -1)),
    "LHEE": ("left_ankle", (0, 0, -1)), "RHEE": ("right_ankle", (0, 0, -1)),
    "LIWR": ("left_wrist", (0, -1, 0)), "RIWR": ("right_wrist", (0, -1, 0)),
    "LOWR": ("left_wrist", (0, 1, 0)), "ROWR": ("right_wrist", (0, 1, 0)),
    "LKNE": ("left_knee", (1, 0, 0)), "RKNE": ("right_knee", (-1, 0, 0)),
    "LMT5": ("left_foot", (1, 0, 1)), "RMT5": ("right_foot", (-1, 0, 1)),
    "LSHN": ("left_knee", (0, -1, 1)), "RSHN": ("right_knee", (0, -1, 1)),
    "LSHO": ("left_shoulder", (0, 1, 0)), "RSHO": ("right_shoulder", (0, 1, 0)),
    "LTHI": ("left_hip", (1, -1, 0)), "RTHI": ("right_hip", (-1, -1, 0)),
    "LTOE": ("left_foot", (0, 0, 1)), "RTOE": ("right_foot", (0, 0, 1)),
    "LUPA": ("left_shoulder", (1, -1, 0)), "RUPA": ("right_shoulder", (-1, -1, 0)),
}


def get_marker_layout(name: str) -> List[str]:
    return MARKER_LAYOUTS[name]


def resolve_layout_vertex_ids(layout: str | List[str], body: BodyModel,
                              vid_table: Optional[Dict[str, int] | str] = None) -> np.ndarray:
    """Marker names (or a layout's name) -> vertex ids [M] int64.

    ``vid_table``: a dict or JSON path with the MoSh++-style name -> vertex
    id mapping.  Without it, the anatomical fallback (``marker_layout.py:68-99``)."""
    names = MARKER_LAYOUTS[layout] if isinstance(layout, str) else layout
    if vid_table is not None:
        if isinstance(vid_table, str):
            with open(vid_table) as f:
                vid_table = json.load(f)
        return np.asarray([int(vid_table[n]) for n in names], np.int64)

    vertex_labels = np.argmax(body.lbs_weights.detach().cpu().numpy(), axis=-1)
    v = body.v_template.detach().cpu().numpy()
    ids = []
    for name in names:
        joint_name, direction = _ANATOMY.get(name, ("pelvis", (0, 0, 1)))
        part_idx = np.where(vertex_labels == get_joint_id(joint_name))[0]
        if part_idx.size == 0:
            part_idx = np.arange(v.shape[0])
        center = v[part_idx].mean(0)
        score = (v[part_idx] - center) @ np.asarray(direction, np.float64)
        ids.append(int(part_idx[np.argmax(score)]))
    return np.asarray(ids, np.int64)


def compute_markers_from_layout(vertices: torch.Tensor, faces: np.ndarray,
                                marker_vertex_ids: np.ndarray,
                                marker_offset: float = MARKER_DISTANCE) -> Dict[str, torch.Tensor]:
    """Markers at the layout's vertices plus the vertex normal x 9.5 mm:
    vertices [..., V, 3] -> {"marker_pos": [..., M, 3]}."""
    vid = torch.as_tensor(np.asarray(marker_vertex_ids, np.int64), device=vertices.device)
    normals = vertex_normals(vertices, faces)
    return {"marker_pos": vertices[..., vid, :] + normals[..., vid, :] * marker_offset}


def compute_marker_labels_from_layout(marker_vertex_ids: np.ndarray,
                                      lbs_weights: torch.Tensor) -> torch.Tensor:
    """argmax-LBS part of each layout marker [M]."""
    vid = torch.as_tensor(np.asarray(marker_vertex_ids, np.int64), device=lbs_weights.device)
    return lbs_weights[vid].argmax(dim=-1)
