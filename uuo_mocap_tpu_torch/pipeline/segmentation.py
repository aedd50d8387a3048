"""Rigid marker segmentation on the host (counterpart of
``uuo_mocap_tpu/pipeline/segmentation.py:segment_rigid``).

The reference clusters with scikit-learn's ``AgglomerativeClustering``;
this port uses ``scipy.cluster.hierarchy`` (average linkage, cut at the same
distance threshold), which gives the same partition without scikit-learn.
"""
from __future__ import annotations

from typing import List

import numpy as np


def segment_rigid(points: np.ndarray, distance_threshold: float = 0.005) -> List[List[int]]:
    """Cluster markers into rigid bodies by the stddev over time of their
    pairwise distances (average linkage, 5 mm).  points [F, M, 3] -> marker
    index clusters, ordered by their lowest marker index."""
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    M = points.shape[1]
    if M == 1:
        return [[0]]
    diff = points[:, :, None, :] - points[:, None, :, :]  # [F, M, M, 3]
    mat = np.linalg.norm(diff, axis=-1).std(axis=0)  # [M, M]
    labels = fcluster(linkage(squareform(mat, checks=False), "average"),
                      t=distance_threshold, criterion="distance")
    clusters = [np.where(labels == v)[0].tolist() for v in np.unique(labels)]
    return sorted(clusters, key=lambda c: c[0])


def filter_rigid(points: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Vote each rigid cluster to its median label."""
    output = np.array(labels)
    for group in segment_rigid(points):
        output[:, group] = np.median(labels[:, group])
    return output
