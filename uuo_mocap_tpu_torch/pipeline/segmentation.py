"""Marker segmentation and cleanup on the host (counterpart of
``uuo_mocap_tpu/pipeline/segmentation.py``: ``segment_rigid``,
``filter_rigid``, ``cleanup_markers``, ``trim_trailing_zero_frames``,
``id_markers``, ``shuffle_markers``; numpy and scipy), and network-mode
segmentation: the learned segmenter's labels (on the solve's device), their
per-marker mode, the left/right merge and the kinematic chains.

The reference clusters with scikit-learn's ``AgglomerativeClustering``;
this port uses ``scipy.cluster.hierarchy`` (average linkage, cut at the same
distance threshold), which gives the same partition without scikit-learn.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

SEGMENTER_CHECKPOINT = "marker_segmenter"
MULTIMODAL_CHECKPOINT = "marker_segmenter_multimodal"


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


def labels_mode(marker_labels: np.ndarray) -> np.ndarray:
    """Per-marker temporal mode of [F, M] labels (the least label among
    ties)."""
    from scipy import stats

    return stats.mode(marker_labels, axis=0, keepdims=False).mode


def segment_markers_network(points: np.ndarray, freq: float,
                            checkpoint_root: str = "./checkpoints",
                            joints=None, device=None) -> np.ndarray:
    """Per-frame part labels [F, M] from the learned segmenter: the
    multimodal net when ``joints`` (the prior's [F, 22, 3] joint stream) is
    given and its checkpoint exists, else the marker-only net (windows of
    32 frames at stride 4 x max(freq // 30, 1), softmax over the 24 parts,
    argmax).  Runs on ``device`` (default: the card).  A missing
    checkpoint raises ``FileNotFoundError``."""
    from uuo_mocap_tpu_torch.convert import (
        marker_segmenter_from_flax, marker_segmenter_multimodal_from_flax)
    from uuo_mocap_tpu_torch.device import resolve_device
    from uuo_mocap_tpu_torch.models.checkpoints import checkpoint_path, load_params

    multimodal = joints is not None and os.path.exists(
        checkpoint_path(checkpoint_root, MULTIMODAL_CHECKPOINT))
    name = MULTIMODAL_CHECKPOINT if multimodal else SEGMENTER_CHECKPOINT
    path = checkpoint_path(checkpoint_root, name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no segmenter checkpoint at {path}; the repository ships them under checkpoints/ "
            "(set the config's checkpoints_dir)")
    dev = resolve_device(device)
    pts = torch.as_tensor(np.nan_to_num(np.asarray(points, np.float32), nan=0.0), device=dev)
    with torch.no_grad():
        if multimodal:
            net = marker_segmenter_multimodal_from_flax(load_params(checkpoint_root, name), dev)
            probs = net.forward_sequence(
                pts, torch.as_tensor(joints, dtype=torch.float32, device=dev), freq=freq)
        else:
            net = marker_segmenter_from_flax(load_params(checkpoint_root, name), dev)
            probs = net.forward_sequence(pts, freq=freq)
        return probs.argmax(dim=-1).cpu().numpy()


def merge_symmetric_labels(labels_mode_arr: np.ndarray) -> np.ndarray:
    """Right-side labels merged into their left counterparts (the
    multi-hypothesis solve resolves the side later)."""
    from uuo_mocap_tpu_torch.body.joints import SMPL_JOINT_SYMMETRY

    out = np.array(labels_mode_arr)
    for left, right in SMPL_JOINT_SYMMETRY:
        out[out == right] = left
    return out


def chains_from_labels(labels_merged: np.ndarray, parents: np.ndarray) -> List[List[int]]:
    """The present part labels grouped into connected kinematic chains (in
    increasing label order, a part joins the first chain holding its
    parent), sorted by (parts, markers) with the largest first."""
    present = sorted(set(int(label) for label in labels_merged))
    chains: List[List[int]] = []
    for j in present:
        for chain in chains:
            if int(parents[j]) in chain:
                chain.append(j)
                break
        else:
            chains.append([j])

    def chain_score(chain):
        return (len(chain), sum(int((labels_merged == j).sum()) for j in chain))

    return sorted(chains, key=chain_score, reverse=True)
