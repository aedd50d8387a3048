"""Mesh part culling (counterpart of ``uuo_mocap_tpu/utils/mesh.py``)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def cull_parts(faces: np.ndarray, vertex_labels: np.ndarray, keep_parts: Sequence[int]) -> np.ndarray:
    """Keep only faces all of whose vertices belong to ``keep_parts``.

    faces [T, 3], vertex_labels [V] -> culled faces [T', 3].
    """
    keep = np.isin(vertex_labels, np.asarray(list(keep_parts)))
    face_keep = keep[faces].all(axis=1)
    return faces[face_keep]
