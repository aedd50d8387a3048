"""In-memory marker cloud (counterpart of ``uuo_mocap_tpu/data/markers.py:ArrayMarkers``)."""
from __future__ import annotations

import numpy as np


class ArrayMarkers:
    """Markers [F, M, 3] (zero rows = occluded) at ``freq`` Hz."""

    def __init__(self, points: np.ndarray, freq: float = 30.0):
        self.points = np.asarray(points, np.float32)
        self.freq = float(freq)

    def get_points(self) -> np.ndarray:
        return self.points

    def set_points(self, points: np.ndarray) -> None:
        self.points = points

    def get_frequency(self) -> float:
        return self.freq
