"""Render saved SMPL npz files (and optional c3d markers) to a video
(counterpart of ``uuo_mocap_tpu/vis/visualize_smpl.py``).

``smpl_bodies`` is the device half (each file's SMPL forward with the hands
zeroed, on the model's device: the card unless ``--cpu_only``);
``visualize_smpl`` renders on the host (matplotlib).

Usage:
    python -m uuo_mocap_tpu_torch.vis.visualize_smpl --input_files a_stageii.npz \\
        [--markers seq.c3d] --video out.mp4 [--cpu_only]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from uuo_mocap_tpu_torch.body.model import BodyModel


def smpl_bodies(input_files: List[str], model: BodyModel) -> List[np.ndarray]:
    """Each npz's posed vertices [F, V, 3] (hands zeroed), as numpy."""
    from uuo_mocap_tpu_torch.eval.comparisons import load_smpl_npz, smpl_forward_zeroed_hands

    return [smpl_forward_zeroed_hands(model, load_smpl_npz(path))["vertices"].cpu().numpy()
            for path in input_files]


def visualize_smpl(
    input_files: List[str],
    model: BodyModel,
    markers_file: Optional[str] = None,
    video_path: Optional[str] = None,
    fps: Optional[float] = None,
    part_colors: bool = False,
    up_axis: str = "z",
):
    from uuo_mocap_tpu_torch.eval.comparisons import load_smpl_npz
    from uuo_mocap_tpu_torch.utils.colors import colors_for_labels
    from uuo_mocap_tpu_torch.vis.renderer import VideoMocapRenderer
    from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene

    bodies = smpl_bodies(input_files, model)
    F = min(b.shape[0] for b in bodies)
    freq = fps or load_smpl_npz(input_files[0])["freq"]

    markers = None
    if markers_file:
        from uuo_mocap_tpu_torch.data.markers import Markers

        markers = np.nan_to_num(Markers(markers_file).get_points()[:F], nan=0.0)

    vertex_colors = None
    if part_colors:
        vertex_colors = colors_for_labels(model.vertex_part_labels().cpu().numpy())

    scene = VideoMocapScene(up_axis=up_axis)

    def render_frame(s: VideoMocapScene, frame: int):
        for b in bodies:
            s.add_mesh(b[frame], model.faces, vertex_colors=vertex_colors)
        if markers is not None:
            s.add_markers(markers[frame])

    renderer = VideoMocapRenderer(scene, render_frame, F, video_path, video_fps=freq)
    return renderer.run()


def main(argv=None):
    from uuo_mocap_tpu_torch.cli.test import device_from_args
    from uuo_mocap_tpu_torch.eval.comparisons import default_model_provider

    parser = argparse.ArgumentParser()
    parser.add_argument("--input_files", nargs="+", required=True)
    parser.add_argument("--markers", type=str, default=None)
    parser.add_argument("--video", type=str, default=None)
    parser.add_argument("--fps", type=float, default=None)
    parser.add_argument("--part_colors", action="store_true")
    parser.add_argument("--up_axis", type=str, default="z", choices=("x", "y", "z"))
    parser.add_argument("--body_models", type=str, default="./body_models")
    parser.add_argument("--cpu_only", action="store_true", help="run the forward on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    args = parser.parse_args(argv)

    model = default_model_provider(args.body_models, device=device_from_args(args))("neutral")
    out = visualize_smpl(args.input_files, model, args.markers, args.video, args.fps,
                         args.part_colors, args.up_axis)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
