"""2D diagnostic plots (counterpart of ``uuo_mocap_tpu/vis/plots.py``): root
trajectories, 2D-joint overlays, error heatmaps, label histograms and
confusion matrices, written as PNGs with matplotlib (imported when a plot
is drawn, never on import).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_root_trajectories(filename: str, trajectories: List[np.ndarray],
                           labels: Optional[List[str]] = None) -> str:
    """Top-down (x, y) root paths."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    for i, traj in enumerate(trajectories):
        label = labels[i] if labels else f"traj {i}"
        ax.plot(traj[:, 0], traj[:, 1], label=label)
        ax.scatter(traj[0, 0], traj[0, 1], marker="o")
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(filename, dpi=150)
    plt.close(fig)
    return filename


def plot_2d_joints(filename: str, joints_2d: np.ndarray, frame: int = 0,
                   image: Optional[np.ndarray] = None,
                   foot_contacts: Optional[np.ndarray] = None) -> str:
    """2D joint scatter (+ foot-contact highlighting) for one frame."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    if image is not None:
        ax.imshow(image)
    j = joints_2d[frame]
    ax.scatter(j[:, 0], j[:, 1], s=12, c="red")
    if foot_contacts is not None:
        from uuo_mocap_tpu_torch.utils.foot_contact import JOINTS_2D

        for g, keys in enumerate((("l_toe_in", "l_toe_out"), ("r_toe_in", "r_toe_out"))):
            if foot_contacts[frame, g] > 0.5:
                for k in keys:
                    ax.scatter(*j[JOINTS_2D[k]], s=60, facecolors="none", edgecolors="lime")
    ax.invert_yaxis()
    fig.savefig(filename, dpi=150)
    plt.close(fig)
    return filename


def plot_error_heatmap(filename: str, error: np.ndarray, vmax: float = 0.5) -> str:
    """[F, J] error heatmap."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(error.T, aspect="auto", cmap="viridis", vmin=0.0, vmax=vmax)
    ax.set_xlabel("frame")
    ax.set_ylabel("joint")
    fig.colorbar(im, orientation="horizontal")
    fig.savefig(filename, dpi=150)
    plt.close(fig)
    return filename


def plot_label_histogram(filename: str, labels: np.ndarray, num_classes: int = 24) -> str:
    """Per-part marker-label counts."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 3))
    counts = np.bincount(np.asarray(labels).ravel().astype(np.int64), minlength=num_classes)
    ax.bar(range(num_classes), counts[:num_classes])
    ax.set_xlabel("part")
    ax.set_ylabel("#markers")
    fig.savefig(filename, dpi=150)
    plt.close(fig)
    return filename


def plot_confusion_matrix(filename: str, true_labels: np.ndarray, pred_labels: np.ndarray,
                          num_classes: int = 24) -> str:
    """Part-segmentation confusion matrix, rows normalised."""
    plt = _plt()
    cm = np.zeros((num_classes, num_classes))
    for t, p in zip(np.ravel(true_labels), np.ravel(pred_labels)):
        cm[int(t), int(p)] += 1
    cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(cm, cmap="Blues", vmin=0, vmax=1)
    ax.set_xlabel("predicted part")
    ax.set_ylabel("true part")
    fig.colorbar(im)
    fig.savefig(filename, dpi=150)
    plt.close(fig)
    return filename
