"""Raw marker-cloud viewer with corruption experiments (counterpart of
``uuo_mocap_tpu/vis/visualize_markers.py``): renders a c3d marker cloud,
optionally after drop / shuffle / re-ID / rigid-cluster coloring.  Host
code throughout (numpy and matplotlib); nothing runs on the card.
"""
from __future__ import annotations

import argparse

import numpy as np


def prepare_points(path: str, shuffle: bool = False, reidentify: bool = False, drop: int = 0,
                   rigid_colors: bool = False, max_frames: int = 300):
    """The cloud the viewer draws -> (points [F, M, 3], labels [M] or None,
    frame rate)."""
    from uuo_mocap_tpu_torch.data.markers import Markers
    from uuo_mocap_tpu_torch.data.markers_noise import randomly_drop_markers
    from uuo_mocap_tpu_torch.pipeline.segmentation import id_markers, segment_rigid, shuffle_markers

    mk = Markers(path)
    points = np.nan_to_num(mk.get_points(), nan=0.0)[:max_frames]
    if shuffle:
        points = shuffle_markers(points, np.random.RandomState(0))
    if reidentify:
        points = id_markers(points)
    if drop:
        points = randomly_drop_markers(points, mk.get_frequency(), num_drop=drop)

    labels = None
    if rigid_colors:
        groups = segment_rigid(points)
        labels = np.zeros(points.shape[1], np.int64)
        for gi, g in enumerate(groups):
            labels[g] = gi
    return points, labels, mk.get_frequency()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help=".c3d file")
    parser.add_argument("--video", type=str, default=None)
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--id_markers", action="store_true", help="re-identify after shuffle")
    parser.add_argument("--drop", type=int, default=0, help="number of markers to drop")
    parser.add_argument("--rigid_colors", action="store_true", help="color rigid clusters")
    parser.add_argument("--max_frames", type=int, default=300)
    args = parser.parse_args(argv)

    from uuo_mocap_tpu_torch.vis.renderer import VideoMocapRenderer
    from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene

    points, labels, freq = prepare_points(args.input, args.shuffle, args.id_markers, args.drop,
                                          args.rigid_colors, args.max_frames)
    scene = VideoMocapScene()

    def render_frame(s, frame):
        s.add_markers(points[frame], labels=labels)

    out = VideoMocapRenderer(scene, render_frame, points.shape[0], args.video, freq).run()
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
