"""Paper-figure scripts (counterpart of ``uuo_mocap_tpu/vis/paper.py``).

The reference's five ``vis/paper/`` scripts:
  * ``plot_part_errors.py``       -> ``plot_part_error_histograms``
  * ``visualize_part_metrics.py`` -> ``visualize_part_metrics``
  * ``part_segmentation_confusion_matrix.py`` -> ``segmentation_confusion_matrix``
  * ``crop_results.py``           -> ``crop_results`` / ``crop_method_results``
  * ``visualize_smpl.py`` (paper stills) -> ``render_paper_stills``

All figure paths read the comparisons-harness outputs
(``results/stats/<dataset>/<part>/<method>.{yaml,csv}``), matching the
reference's directory conventions.  Run as
``python -m uuo_mocap_tpu_torch.vis.paper <command> ...``.

The plots, the crops and the renders are host code (matplotlib, PIL).  Two
figures have a device half, on the card unless ``--cpu_only``:
``segmentation_labels`` (``segment_markers_network`` on synthetic
sequences) and ``stills_vertices`` (the LBS forward of a solved npz).  The
reference's ``segmentation_confusion_matrix`` hands its count matrix to
``plot_confusion_matrix``, which takes the label vectors and so raises
``TypeError``; here the figure plots the labels.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _agg():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_part_errors(
    filename: str,
    stats_per_method: Dict[str, Dict],
    metric: str = "mpjpe",
    parts: Optional[List[str]] = None,
) -> str:
    """Grouped bars of per-part metric means across methods; input is the
    comparisons harness output (``eval/comparisons.py`` stats dicts)."""
    plt = _agg()

    if parts is None:
        from uuo_mocap_tpu_torch.eval.metrics import PARTS_MAP

        parts = [p for p in PARTS_MAP if p != "full"]

    methods = list(stats_per_method)
    width = 0.8 / max(len(methods), 1)
    fig, ax = plt.subplots(figsize=(1.2 * len(parts) + 2, 3.5))
    for mi, method in enumerate(methods):
        stats = stats_per_method[method]
        vals = [stats.get(f"{p}__{metric}", {}).get("mean", np.nan) for p in parts]
        ax.bar(np.arange(len(parts)) + mi * width, vals, width, label=method)
    ax.set_xticks(np.arange(len(parts)) + 0.4 - width / 2)
    ax.set_xticklabels(parts, rotation=30, ha="right")
    ax.set_ylabel(f"{metric} (mm)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(filename, dpi=200)
    plt.close(fig)
    return filename


def plot_part_error_histograms(
    stats_root: str,
    dataset: str,
    out_dir: str,
    method: str = "video_mocap",
    part_groups: Sequence[str] = ("arm", "leg", "shoulder"),
    nbins: int = 10,
) -> List[str]:
    """Left/right stacked per-sequence error histograms for each part group
    and each of {m2s, mpjpe, mpjve} (reference ``plot_part_errors.py``:
    reads ``results/stats/<dataset>/<side>_<group>/<method>.csv``)."""
    plt = _agg()
    os.makedirs(out_dir, exist_ok=True)

    metrics = ("m2s", "mpjpe", "mpjve")
    values: Dict[str, Dict[str, Dict[str, List[float]]]] = {
        m: {g: {"left": [], "right": []} for g in part_groups} for m in metrics
    }
    for group in part_groups:
        for side in ("left", "right"):
            path = os.path.join(stats_root, dataset, f"{side}_{group}", method + ".csv")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                reader = csv.DictReader(f)
                for row in reader:
                    for m in metrics:
                        if m in row:
                            values[m][group][side].append(float(row[m]))

    ylabels = {"m2s": "m2s (mm)", "mpjpe": "MPJPE (mm)", "mpjve": "MPJVE (mm/s)"}
    written = []
    for m in metrics:
        fig, axes = plt.subplots(1, len(part_groups), figsize=(5, 2))
        axes = np.atleast_1d(axes)
        for gi, group in enumerate(part_groups):
            cols = [values[m][group]["left"], values[m][group]["right"]]
            if any(len(c) for c in cols):
                # ragged lists go to plt.hist directly — zero-padding the
                # shorter side would inject fake 0.0 samples (ADVICE r2)
                axes[gi].hist([np.asarray(c, float) for c in cols], nbins,
                              histtype="bar", stacked=True,
                              label=["left", "right"] if gi == 0 else None)
            axes[gi].set_title(group.capitalize() + "s")
            if gi == 0:
                axes[gi].set_ylabel(ylabels[m])
                axes[gi].legend()
        fig.tight_layout()
        path = os.path.join(out_dir, f"part_error_{m}.pdf")
        fig.savefig(path)
        fig.savefig(path[:-4] + ".png", dpi=200)
        plt.close(fig)
        written.append(path)
    return written


def visualize_part_metrics(
    dataset: str,
    stats_root: str = "./results/stats",
    out_dir: str = "results/vis/part_metrics",
    method: str = "video_mocap",
    part_names: Sequence[str] = (
        "left_arm", "left_leg", "left_shoulder",
        "right_arm", "right_leg", "right_shoulder",
    ),
) -> str:
    """Per-part mean-metric bars, hue = body side (reference
    ``visualize_part_metrics.py``: reads the per-part method YAMLs, as
    ``eval/comparisons.py:save_stats`` writes them)."""
    from uuo_mocap_tpu_torch.data.config import parse_yaml

    plt = _agg()
    metrics_labels = {
        "m2s": {"title": "m2s ↓", "y": "mm"},
        "mpjpe": {"title": "MPJPE ↓", "y": "mm"},
        "mpjve": {"title": "MPJVE ↓", "y": "mm/s"},
    }
    data = {m: {"parts": [], "values": [], "sides": []} for m in metrics_labels}
    for part_name in part_names:
        path = os.path.join(stats_root, dataset, part_name, method + ".yaml")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            text = f.read()
        stats = {} if text.strip() == "{}" else parse_yaml(text)
        side = part_name.split("_")[0]
        bare = part_name.replace("left_", "").replace("right_", "")
        for m in metrics_labels:
            if m in stats:
                data[m]["parts"].append(bare)
                data[m]["sides"].append(side)
                data[m]["values"].append(stats[m]["mean"])

    fig, axes = plt.subplots(ncols=3, figsize=(12, 4))
    for mi, (m, label) in enumerate(metrics_labels.items()):
        ax = axes[mi]
        parts = sorted(set(data[m]["parts"]))
        width = 0.35
        for si, side in enumerate(("left", "right")):
            vals = []
            for p in parts:
                found = [v for pp, ss, v in zip(data[m]["parts"], data[m]["sides"], data[m]["values"])
                         if pp == p and ss == side]
                vals.append(found[0] if found else np.nan)
            ax.bar(np.arange(len(parts)) + si * width, vals, width, label=side)
        ax.set_xticks(np.arange(len(parts)) + width / 2)
        ax.set_xticklabels(parts)
        ax.set_title(label["title"])
        ax.set_ylabel(label["y"])
        if mi == 0:
            ax.legend()
    os.makedirs(out_dir, exist_ok=True)
    fig.tight_layout()
    path = os.path.join(out_dir, dataset + ".pdf")
    fig.savefig(path)
    fig.savefig(os.path.join(out_dir, dataset + ".png"), dpi=300)
    plt.close(fig)
    return path


def segmentation_labels(
    checkpoint_root: str = "./checkpoints",
    num_sequences: int = 8,
    frames: int = 64,
    markers: int = 24,
    seed: int = 0,
    device=None,
):
    """The device half of ``segmentation_confusion_matrix``: synthetic
    marker sequences with known parts through ``segment_markers_network``
    on ``device`` (default: the card) -> (true parts [S * M], predicted
    parts [S * M] (each marker's mode over frames), count matrix [P, P])."""
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.data.synthetic import generate_markers, random_pose_sequence
    from uuo_mocap_tpu_torch.pipeline.segmentation import segment_markers_network

    model = synthetic_body_model(device=device)
    vertex_labels = model.vertex_part_labels().cpu().numpy()
    num_parts = int(model.lbs_weights.shape[1])

    y_true, y_pred = [], []
    for s in range(num_sequences):
        gt = random_pose_sequence(frames, seed=seed + s, device=model.device)
        mk = generate_markers(model, gt, num_markers=markers, seed=seed + 100 + s)
        true_labels = vertex_labels[np.asarray(mk.vertex_ids)]  # [M]
        pred = segment_markers_network(mk.points.cpu().numpy(), 30.0,
                                       checkpoint_root=checkpoint_root, device=model.device)
        mode = np.apply_along_axis(lambda c: np.bincount(c).argmax(), 0, pred)
        y_true.append(true_labels)
        y_pred.append(mode)

    y_true, y_pred = np.concatenate(y_true), np.concatenate(y_pred)
    cm = np.zeros((num_parts, num_parts), np.int64)
    for t, p in zip(y_true, y_pred):
        cm[int(t), int(p)] += 1
    return y_true, y_pred, cm


def segmentation_confusion_matrix(
    out_path: str,
    checkpoint_root: str = "./checkpoints",
    num_sequences: int = 8,
    frames: int = 64,
    markers: int = 24,
    seed: int = 0,
    device=None,
) -> str:
    """Segmenter confusion matrix on synthetic marker sequences with known
    part labels (reference ``part_segmentation_confusion_matrix.py:31-41``:
    predicted vs ground-truth part of every marker)."""
    from uuo_mocap_tpu_torch.vis.plots import plot_confusion_matrix

    y_true, y_pred, cm = segmentation_labels(checkpoint_root, num_sequences, frames, markers,
                                             seed, device)
    return plot_confusion_matrix(out_path, y_true, y_pred, num_classes=cm.shape[0])


def crop_results(input_paths: List[str], out_dir: str, box: tuple) -> List[str]:
    """Crop rendered result images to a (left, top, right, bottom) box
    (reference ``vis/paper/crop_results.py``)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for path in input_paths:
        img = Image.open(path).crop(box)
        out = os.path.join(out_dir, os.path.basename(path))
        img.save(out)
        written.append(out)
    return written


def crop_method_results(
    qual_root: str,
    out_root: str,
    dataset: str,
    subject: str,
    sequence: str,
    methods: Sequence[str],
    frame: int = 0,
    scale: float = 1.0,
    offset: tuple = (0, 0),
    part: Optional[str] = None,
) -> List[str]:
    """Reference ``crop_results.py`` semantics: collect one frame from every
    method's qualitative render dir, crop to ``scale`` of the image about
    ``offset``, write ``<out_root>/<dataset>/<subject>/<sequence>[/<part>]/``."""
    from PIL import Image

    sub = (subject, part, sequence) if part else (subject, sequence)
    out_dir = os.path.join(out_root, dataset, *(s for s in sub if s))
    os.makedirs(out_dir, exist_ok=True)
    frame_name = str(frame).zfill(8) + ".png"
    written = []
    for method in methods:
        in_sub = (subject, part, sequence) if (part and method != "moshpp") else (subject, sequence)
        in_path = os.path.join(qual_root, method, *(s for s in in_sub if s), frame_name)
        if not os.path.exists(in_path):
            print("skip (missing render):", in_path)
            continue
        img = Image.open(in_path)
        w, h = img.width * scale, img.height * scale
        left = (img.width - w) / 2 + offset[0]
        top = (img.height - h) / 2 + offset[1]
        out = os.path.join(out_dir, method + ".png")
        img.crop((left, top, left + w, top + h)).save(out)
        written.append(out)
    return written


def stills_vertices(npz_path: str, model) -> np.ndarray:
    """The device half of ``render_paper_stills``: a solved npz's posed
    vertices [F, V, 3] on the model's device, as numpy."""
    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.eval.comparisons import load_smpl_npz
    from uuo_mocap_tpu_torch.ops import rotations as rot

    smpl = load_smpl_npz(npz_path)
    F = smpl["trans"].shape[0]
    dev = model.device
    mats = rot.axis_angle_to_matrix(torch.as_tensor(smpl["pose_aa"], device=dev))
    with torch.no_grad():
        out = lbs_forward(model, mats[:, 1:],
                          torch.as_tensor(smpl["betas"], device=dev)[None].expand(F, 10),
                          mats[:, :1], torch.as_tensor(smpl["trans"], device=dev))
    return out["vertices"].cpu().numpy()


def render_paper_stills(
    npz_path: str,
    out_dir: str,
    frames: Sequence[int] = (0,),
    body_models: str = "./body_models",
    azims: Sequence[float] = (-60.0, 30.0),
    device=None,
) -> List[str]:
    """Multi-view SMPL stills from a solved npz (reference paper
    ``visualize_smpl.py``: camera-orbit teaser renders); the forward on
    ``device`` (default: the card)."""
    from uuo_mocap_tpu_torch.eval.comparisons import default_model_provider
    from uuo_mocap_tpu_torch.vis.renderer import VideoMocapRenderer
    from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene

    model = default_model_provider(body_models, device=device)("neutral")
    verts = stills_vertices(npz_path, model)
    F = verts.shape[0]

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for frame in frames:
        frame = min(int(frame), F - 1)
        for azim in azims:
            scene = VideoMocapScene()

            def render(s, _f, fr=frame):
                s.add_mesh(verts[fr], model.faces)

            r = VideoMocapRenderer(scene, render, 1, None, azim=azim)
            r.run()
            path = os.path.join(out_dir, f"still_f{frame}_az{int(azim)}.png")
            os.replace(os.path.join(os.getcwd(), "render_preview.png"), path)
            written.append(path)
    return written


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="paper figure scripts")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("part_errors")
    p.add_argument("--stats_root", default="./results/stats")
    p.add_argument("--dataset", required=True)
    p.add_argument("--out_dir", default="paper")
    p.add_argument("--method", default="video_mocap")

    p = sub.add_parser("part_metrics")
    p.add_argument("--stats_root", default="./results/stats")
    p.add_argument("--dataset", required=True)
    p.add_argument("--out_dir", default="results/vis/part_metrics")
    p.add_argument("--method", default="video_mocap")

    p = sub.add_parser("confusion_matrix")
    p.add_argument("--out", default="paper/segmentation_cm.png")
    p.add_argument("--checkpoints", default="./checkpoints")
    p.add_argument("--cpu_only", action="store_true", help="run the segmenter on the CPU")
    p.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")

    p = sub.add_parser("crop")
    p.add_argument("--qual_root", default="results/qual")
    p.add_argument("--out_root", default="paper/results_section")
    p.add_argument("--dataset", required=True)
    p.add_argument("--subject", required=True)
    p.add_argument("--sequence", required=True)
    p.add_argument("--methods", nargs="+", required=True)
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--part", default=None)

    p = sub.add_parser("stills")
    p.add_argument("--npz", required=True)
    p.add_argument("--out_dir", default="paper/stills")
    p.add_argument("--frames", nargs="+", type=int, default=[0])
    p.add_argument("--body_models", default="./body_models")
    p.add_argument("--cpu_only", action="store_true", help="run the forward on the CPU")
    p.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")

    args = parser.parse_args(argv)
    if args.cmd == "part_errors":
        out = plot_part_error_histograms(args.stats_root, args.dataset, args.out_dir, args.method)
    elif args.cmd == "part_metrics":
        out = visualize_part_metrics(args.dataset, args.stats_root, args.out_dir, args.method)
    elif args.cmd == "confusion_matrix":
        from uuo_mocap_tpu_torch.cli.test import device_from_args

        out = segmentation_confusion_matrix(args.out, args.checkpoints,
                                            device=device_from_args(args))
    elif args.cmd == "crop":
        out = crop_method_results(
            args.qual_root, args.out_root, args.dataset, args.subject, args.sequence,
            args.methods, args.frame, args.scale, part=args.part,
        )
    else:  # stills
        from uuo_mocap_tpu_torch.cli.test import device_from_args

        out = render_paper_stills(args.npz, args.out_dir, args.frames, args.body_models,
                                  device=device_from_args(args))
    print(out)
    return out


if __name__ == "__main__":
    main()
