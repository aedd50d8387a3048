"""Scene assembly for the matplotlib renderer (counterpart of
``uuo_mocap_tpu/vis/scene.py``): a checkerboard floor, meshes, marker
clouds and lines per frame, as numpy arrays.  The contract (mesh + markers +
colors per frame) is the one the pyrender viewer renders too.  Host code: a
caller holding tensors moves them to the host (``.cpu().numpy()``) first.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from uuo_mocap_tpu_torch.utils.colors import PART_COLORS, colors_for_labels

SMPL_COLORS = PART_COLORS


def create_floor(extent: float = 3.0, tiles: int = 8) -> Dict[str, np.ndarray]:
    """Checkerboard floor tile corners + colors; the renderer draws them as
    flat patches."""
    xs = np.linspace(-extent, extent, tiles + 1)
    quads, colors = [], []
    for i in range(tiles):
        for j in range(tiles):
            quads.append([(xs[i], xs[j]), (xs[i + 1], xs[j]), (xs[i + 1], xs[j + 1]), (xs[i], xs[j + 1])])
            colors.append([0.85, 0.85, 0.85] if (i + j) % 2 == 0 else [0.55, 0.55, 0.55])
    return {"quads": np.asarray(quads), "colors": np.asarray(colors)}


def extract_part_vertices(vertex_labels: np.ndarray, parts: Sequence[int]) -> np.ndarray:
    """Vertex indices for a set of part labels."""
    return np.where(np.isin(vertex_labels, np.asarray(list(parts))))[0]


class VideoMocapScene:
    """Per-frame drawable collection: meshes (vertices+faces+color),
    marker clouds (points+colors), lines."""

    def __init__(self, floor: bool = True, up_axis: str = "z"):
        self.floor = create_floor() if floor else None
        self.up_axis = up_axis
        self.meshes: List[Dict] = []
        self.points: List[Dict] = []
        self.lines: List[Dict] = []

    def add_mesh(self, vertices: np.ndarray, faces: np.ndarray, color=(0.65, 0.74, 0.86),
                 vertex_colors: Optional[np.ndarray] = None, name: str = "body"):
        self.meshes.append(
            {"vertices": np.asarray(vertices), "faces": np.asarray(faces),
             "color": np.asarray(color), "vertex_colors": vertex_colors, "name": name}
        )

    def add_markers(self, points: np.ndarray, labels: Optional[np.ndarray] = None,
                    color=(1.0, 0.1, 0.1), size: float = 20.0, name: str = "markers"):
        colors = colors_for_labels(labels) if labels is not None else np.asarray(color)
        self.points.append({"points": np.asarray(points), "colors": colors, "size": size, "name": name})

    def add_lines(self, starts: np.ndarray, ends: np.ndarray, color=(0.2, 0.2, 0.2), name: str = "lines"):
        self.lines.append({"starts": np.asarray(starts), "ends": np.asarray(ends),
                           "color": np.asarray(color), "name": name})

    def clear_dynamic(self):
        self.meshes.clear()
        self.points.clear()
        self.lines.clear()
