"""Marker-cloud containers (counterpart of ``uuo_mocap_tpu/data/markers.py``).

``Markers`` reads a .c3d file through ``data/c3d.py`` (the native parser);
``ArrayMarkers`` wraps in-memory arrays (synthetic data, tests).  Points are
scaled to meters by the file's POINT:UNITS (m, cm, mm).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

_UNIT_SCALE = {"m": 1.0, "cm": 100.0, "mm": 1000.0}


class ArrayMarkers:
    """Markers [F, M, 3] (zero rows = occluded) at ``freq`` Hz."""

    def __init__(self, points: np.ndarray, freq: float = 30.0, labels: Optional[List[str]] = None):
        self.points = np.asarray(points, np.float32)
        self.freq = float(freq)
        self.labels = labels or []

    def get_points(self) -> np.ndarray:
        return self.points

    def set_points(self, points: np.ndarray) -> None:
        self.points = points

    def get_labels(self) -> List[str]:
        return self.labels

    def get_num_markers(self) -> int:
        return self.points.shape[1]

    def __len__(self) -> int:
        return self.points.shape[0]

    def get_duration(self) -> float:
        # the reference's definition (``markers.py:38-39``), kept as it is
        return self.freq * self.points.shape[0]

    def get_frequency(self) -> float:
        return self.freq


def markers_from_c3d_dict(data, filename: Optional[str] = None) -> "Markers":
    """A ``Markers`` from ``read_c3d``'s dict (the prefetcher's output)."""
    markers = Markers.__new__(Markers)
    ArrayMarkers.__init__(markers, _meters(data), freq=data["rate"], labels=data.get("labels", []))
    markers.filename = filename
    return markers


def _meters(data) -> np.ndarray:
    """``read_c3d``'s points [F, M, 3] scaled to meters by the file's units."""
    return data["points"][:, :, :3] / _UNIT_SCALE.get(data.get("units", "m"), 1.0)


class Markers(ArrayMarkers):
    """C3D-backed markers with an optional per-frame shuffle."""

    def __init__(self, filename: str, shuffle: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        from uuo_mocap_tpu_torch.data.c3d import read_c3d

        data = read_c3d(filename)
        points = _meters(data)
        if shuffle:
            rng = rng or np.random
            shuffled = np.zeros_like(points)
            for f in range(points.shape[0]):
                shuffled[f] = points[f, rng.permutation(points.shape[1])]
            points = shuffled
        super().__init__(points, freq=data["rate"], labels=data.get("labels", []))
        self.filename = filename
