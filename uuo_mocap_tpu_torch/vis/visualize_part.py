"""Per-part fit renderer: markers against a fitted subtree's vertex subset
(counterpart of ``uuo_mocap_tpu/vis/visualize_part.py``).

Host code: the arrays come in as numpy (a caller holding tensors moves them
to the host first), and the renderer needs matplotlib.
"""
from __future__ import annotations

import numpy as np


def visualize_part(
    filename: str,
    markers: np.ndarray,  # [F, M, 3]
    vertices: np.ndarray,  # [F, V, 3]
    faces: np.ndarray,  # [T, 3]
    marker_labels: np.ndarray,  # [F, M]
    marker_indices: np.ndarray,  # subset fitted
    vertex_indices: np.ndarray,  # part vertex subset
    max_frames: int = 60,
) -> str:
    from uuo_mocap_tpu_torch.vis.renderer import VideoMocapRenderer
    from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene

    F = min(markers.shape[0], max_frames)
    vertex_mask = np.zeros(vertices.shape[1], bool)
    vertex_mask[vertex_indices] = True
    face_keep = vertex_mask[faces].all(axis=1)
    part_faces = faces[face_keep]

    scene = VideoMocapScene()

    def render_frame(s, frame):
        if part_faces.size:
            s.add_mesh(vertices[frame], part_faces, color=(0.4, 0.7, 0.9))
        s.add_markers(markers[frame], color=(0.7, 0.7, 0.7), size=8, name="all")
        s.add_markers(markers[frame, marker_indices], color=(1.0, 0.2, 0.2), size=25, name="fitted")

    return VideoMocapRenderer(scene, render_frame, F, filename).run()
