"""Marker segmentation and cleanup on the host (counterpart of
``uuo_mocap_tpu/pipeline/segmentation.py``: ``segment_rigid``,
``filter_rigid``, ``cleanup_markers``, ``trim_trailing_zero_frames``,
``id_markers``, ``shuffle_markers``; numpy and scipy).

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


def cleanup_markers(points: np.ndarray) -> np.ndarray:
    """Drop markers whose median speed is zero (static junk, dead channels):
    [F, M, 3] -> [F, M_kept, 3]; all of them are kept if none moves."""
    speed = np.linalg.norm(points[1:] - points[:-1], axis=-1)  # [F-1, M]
    keep = np.median(speed, axis=0) > 0
    if not keep.any():
        return points
    return points[:, keep]


def trim_trailing_zero_frames(points: np.ndarray) -> np.ndarray:
    """Trim the trailing frames where every channel is zero:
    [F, M, 3] -> [F_t, M, 3]."""
    nonzero = np.abs(points).sum(axis=(1, 2)) != 0
    if not nonzero.any():
        return points
    return points[: np.max(np.where(nonzero)[0]) + 1]


def id_markers(points: np.ndarray) -> np.ndarray:
    """Frame-to-frame marker re-identification by bipartite matching:
    [F, M, 3] -> [F, M, 3]."""
    from scipy.optimize import linear_sum_assignment

    output = np.zeros_like(points)
    output[0] = points[0]
    for f in range(1, points.shape[0]):
        cost = np.linalg.norm(output[f - 1][:, None] - points[f][None, :], axis=-1)
        _, order = linear_sum_assignment(cost)
        output[f] = points[f][order]
    return output


def shuffle_markers(points: np.ndarray, rng: np.random.RandomState | None = None) -> np.ndarray:
    """A random permutation of the markers in every frame (labels destroyed)."""
    rng = rng or np.random
    output = np.zeros_like(points)
    for f in range(points.shape[0]):
        output[f] = points[f, rng.permutation(points.shape[1])]
    return output
