"""Reprojection-stage debug overlays (counterpart of
``uuo_mocap_tpu/vis/visualize_reprojection.py``): for each yaw seed, the
optimized projected 2D joints against the HMR targets, and the per-angle
reprojection / chamfer metrics.

``run_reprojection`` is the device half (the reprojection stage on a
synthetic prior, on the card unless ``--cpu_only``; its outputs come back as
numpy); ``plot_reprojection_overlays`` plots on the host (matplotlib).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def plot_reprojection_overlays(out_dir: str, reproj_out, angles, frame: int = 0) -> list:
    """``reproj_out`` is the dict ``ReprojectionStage.__call__`` returns
    (leading angle axis), as tensors or numpy."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    reproj_out, angles = _host(reproj_out), np.asarray(_host(angles))
    os.makedirs(out_dir, exist_ok=True)
    written = []
    A = len(angles)
    for a in range(A):
        pred = np.asarray(reproj_out["joints_2d"][a][frame])
        gt = np.asarray(reproj_out["joints_2d_gt"][a][frame])
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(gt[:, 0], gt[:, 1], s=14, c="black", label="HMR 2D")
        ax.scatter(pred[:, 0], pred[:, 1], s=14, c="red", marker="x", label="projected")
        for p, g in zip(pred, gt):
            ax.plot([p[0], g[0]], [p[1], g[1]], color="gray", linewidth=0.5)
        ax.invert_yaxis()
        ax.set_title(f"angle {np.degrees(float(angles[a])):.0f} deg")
        ax.legend()
        path = os.path.join(out_dir, f"reproject_angle_{a}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        written.append(path)

    fig, axes = plt.subplots(1, 2, figsize=(9, 3))  # per-angle metric bars
    for ax, key in zip(axes, ("reproject", "chamfer")):
        vals = np.asarray(reproj_out["metrics"][key])
        ax.bar(range(A), vals)
        ax.set_title(key)
        ax.set_xlabel("angle index")
    path = os.path.join(out_dir, "reprojection_metrics.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    written.append(path)
    return written


def run_reprojection(model, frames: int = 30, num_angles: int = 4, num_iters: int = 50,
                     seed: int = 0):
    """The reprojection stage on a synthetic prior with a plausible camera,
    on the model's device -> (outputs as numpy, angles [A])."""
    from uuo_mocap_tpu_torch.data.config import default_config_dir, load_config
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.synthetic import (
        generate_markers, perturb_params, random_pose_sequence)
    from uuo_mocap_tpu_torch.ops.geometry import get_marker_mask
    from uuo_mocap_tpu_torch.pipeline.reprojection import ReprojectionStage

    dev = model.device
    cfg = load_config(os.path.join(os.path.dirname(default_config_dir()), "configs",
                                   "video_mocap.yaml"))
    cfg["stages"]["reprojection_part"]["num_iters"] = num_iters
    cfg["stages"]["reprojection_part"]["num_angles"] = num_angles

    F = frames
    gt = random_pose_sequence(F, seed=seed, device=dev)
    mk = generate_markers(model, gt, num_markers=30, seed=seed + 1)
    prior = perturb_params(gt, seed=seed + 2)
    img = ImgSmpl.from_params(prior)
    # plausible camera data for the synthetic prior
    img.camera_bbox = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (F, 1))
    img.center = np.tile(np.array([320.0, 240.0], np.float32), (F, 1))
    img.scale = np.full((F, 1), 200.0, np.float32)
    img.size = np.tile(np.array([480.0, 640.0], np.float32), (F, 1))

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    stage = ReprojectionStage(model, cfg, "reprojection_part")
    angles = put(np.arange(num_angles) * 2 * np.pi / num_angles)
    out = stage(angles, mk.points, get_marker_mask(mk.points), put(img.pose_body),
                put(img.betas[:1]), put(img.betas), put(img.hmr_root_orient), put(img.trans),
                put(img.camera_bbox), put(img.center), put(img.size), put(img.scale),
                torch.ones(F, device=dev))
    return _host(out), angles.cpu().numpy()


def main(argv=None):
    from uuo_mocap_tpu_torch.cli.test import device_from_args

    parser = argparse.ArgumentParser(
        description="Run the reprojection stage on a synthetic prior and render overlays")
    parser.add_argument("--out_dir", type=str, default="render_reprojection")
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--num_angles", type=int, default=4)
    parser.add_argument("--num_iters", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu_only", action="store_true", help="run the stage on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    args = parser.parse_args(argv)

    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model

    model = synthetic_body_model(device=device_from_args(args))
    out, angles = run_reprojection(model, args.frames, args.num_angles, args.num_iters, args.seed)
    paths = plot_reprojection_overlays(args.out_dir, out, angles)
    print("wrote", *paths, sep="\n  ")
    return paths


if __name__ == "__main__":
    main()
