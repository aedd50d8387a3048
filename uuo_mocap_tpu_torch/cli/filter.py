"""Savgol smoother of a solved sequence (counterpart of
``uuo_mocap_tpu/cli/filter.py``): smooth the axis-angle pose channels and
the translation of a ``*_stageii.npz`` over time.  Host code (scipy).

Usage:
    python -m uuo_mocap_tpu_torch.cli.filter --input A_stageii.npz --output B.npz
"""
from __future__ import annotations

import argparse

import numpy as np


def smooth_poses(poses: np.ndarray, window: int = 7, order: int = 3) -> np.ndarray:
    """Savgol-filter each axis-angle channel over frames ([F, D])."""
    from scipy.signal import savgol_filter

    F = poses.shape[0]
    win = min(window, F if F % 2 == 1 else F - 1)
    if win < order + 2:
        return poses
    return savgol_filter(poses, win, order, axis=0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="*_stageii.npz")
    parser.add_argument("--output", required=True)
    parser.add_argument("--window", type=int, default=7)
    parser.add_argument("--order", type=int, default=3)
    args = parser.parse_args(argv)

    data = dict(np.load(args.input, allow_pickle=True))
    data["poses"] = smooth_poses(np.asarray(data["poses"], np.float64), args.window, args.order)
    data["trans"] = smooth_poses(np.asarray(data["trans"], np.float64), args.window, args.order)
    np.savez(args.output, **data)
    print("wrote", args.output)


if __name__ == "__main__":
    main()
