"""Perceptually distinct part colors (counterpart of
``uuo_mocap_tpu/utils/colors.py``)."""
from __future__ import annotations

import numpy as np

from uuo_mocap_tpu_torch.body.joints import SMPL_JOINT_NAMES

# 24 distinct colors, one per SMPL part
PART_COLORS = np.array(
    [
        [0.00, 0.00, 1.00], [1.00, 0.00, 1.00], [1.00, 1.00, 0.00], [0.30, 0.30, 1.00],
        [0.70, 0.00, 0.70], [0.70, 0.70, 0.00], [0.50, 0.50, 1.00], [0.50, 0.00, 0.50],
        [0.50, 0.50, 0.00], [0.70, 0.70, 1.00], [0.20, 0.00, 0.20], [0.20, 0.20, 0.00],
        [1.00, 0.40, 0.00], [1.00, 0.20, 0.00], [0.20, 0.40, 0.00], [0.50, 0.20, 0.00],
        [0.20, 0.00, 0.00], [0.00, 0.20, 0.00], [0.50, 0.00, 0.00], [0.00, 0.50, 0.00],
        [0.80, 0.00, 0.00], [0.00, 0.80, 0.00], [1.00, 0.00, 0.00], [0.00, 1.00, 0.00],
    ]
)

# distinct colors for arbitrary label sets (rigid clusters etc.)
DISTINCT_COLORS = PART_COLORS


def get_joint_color(joint_id: int) -> np.ndarray:
    return PART_COLORS[joint_id % len(PART_COLORS)]


def get_joint_color_by_name(name: str) -> np.ndarray:
    return get_joint_color(SMPL_JOINT_NAMES.index(name))


def colors_for_labels(labels: np.ndarray) -> np.ndarray:
    """[N] int labels -> [N, 3] colors."""
    return PART_COLORS[np.asarray(labels) % len(PART_COLORS)]
