"""Run the full solver on one sequence and render the result: the demo CLI
(counterpart of ``uuo_mocap_tpu/vis/visualize_model.py``).  Flags for
marker corruption (swap / tracking loss / drop / shuffle), part culling,
the iteration journal, and side-by-side rendering of markers, the solved
SMPL and (optionally) the HMR prior body.

``solve_sequence`` is the device half (``multimodal_video_mocap`` and the
LBS forwards of the solved and the prior body, on the card unless
``--cpu_only``, handed back as numpy); ``main`` renders on the host
(matplotlib; ``--viewer`` opens pyrender where the host has it).  The
4D-Humans pkl is read without joblib (``data/pkl_io.py``).

Usage:
    python -m uuo_mocap_tpu_torch.vis.visualize_model --config configs/video_mocap.yaml \\
        --dataset <ds> --input_dir <dir> --subject s1 --sequence seq \\
        [--video out.mp4] [--marker_swap P] [--marker_tracking_loss P] ... [--cpu_only]
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--subject", required=True)
    parser.add_argument("--sequence", required=True)
    parser.add_argument("--camera", type=str, default=None)
    parser.add_argument("--video", type=str, default=None)
    parser.add_argument("--viewer", action="store_true",
                        help="open the interactive viewer (pyrender/matplotlib) "
                             "instead of writing files; headless falls back")
    parser.add_argument("--body_models", type=str, default="./body_models")
    parser.add_argument("--show_hmr", action="store_true", help="render the HMR prior body too")
    parser.add_argument("--marker_swap", type=float, default=0.0)
    parser.add_argument("--marker_tracking_loss", type=float, default=0.0)
    parser.add_argument("--marker_drop", type=int, default=0)
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--cull_parts", nargs="+", type=int, default=None)
    parser.add_argument("--save_iterations", type=str, default=None, help="journal pkl path")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu_only", action="store_true", help="solve on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    return parser


def solve_sequence(args, model) -> Dict[str, Any]:
    """The demo's device half on ``model``'s device: read and corrupt the
    markers, solve, pose the result (and the prior with ``show_hmr``).
    -> {"result": the solve's output dict, "points" [F, M, 3] (the markers
    as solved), "verts" [F, V, 3], "hmr_verts" or None, "freq"}."""
    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.cli.test import DATASET_CAMERAS, _video_freq
    from uuo_mocap_tpu_torch.data.config import load_config
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import Markers
    from uuo_mocap_tpu_torch.data.markers_noise import (
        markers_swap, markers_tracking_loss, randomly_drop_markers)
    from uuo_mocap_tpu_torch.data.pkl_io import load_pkl
    from uuo_mocap_tpu_torch.pipeline.journal import IterationJournal
    from uuo_mocap_tpu_torch.pipeline.multimodal import multimodal_video_mocap
    from uuo_mocap_tpu_torch.pipeline.segmentation import (
        shuffle_markers, trim_trailing_zero_frames)

    config = load_config(args.config)
    camera = args.camera or DATASET_CAMERAS.get(args.dataset)
    base = os.path.join(args.input_dir, args.dataset)
    seq_video = args.sequence + ("." + camera if camera else "")

    markers = Markers(os.path.join(base, "mocap", args.subject, args.sequence + ".c3d"))
    pts = np.nan_to_num(markers.get_points(), nan=0.0)
    pts = trim_trailing_zero_frames(pts)
    rng = np.random.RandomState(args.seed)
    if args.shuffle:
        pts = shuffle_markers(pts, rng)
    if args.marker_swap > 0:
        pts = markers_swap(pts, swap_probability=args.marker_swap, rng=rng)
    if args.marker_tracking_loss > 0:
        pts = markers_tracking_loss(pts, probability=args.marker_tracking_loss, rng=rng)
    if args.marker_drop > 0:
        pts = randomly_drop_markers(pts, markers.get_frequency(), num_drop=args.marker_drop,
                                    rng=rng)
    markers.set_points(pts)

    pkl = os.path.join(base, "comparisons", "4d_humans", args.subject, seq_video, "results",
                       "demo_" + args.sequence + ".pkl")
    video_file = os.path.join(base, "videos", args.subject, seq_video + ".avi")
    img_smpl = ImgSmpl(load_pkl(pkl), _video_freq(video_file))

    journal = IterationJournal() if args.save_iterations else None
    result = multimodal_video_mocap(
        img_smpl, markers, config, model, offset=0, print_options=["progress"],
        save_stages=True, iter_journal=journal, device=model.device)
    if journal is not None:
        journal.save(args.save_iterations)
        print("journal ->", args.save_iterations)

    dev = model.device

    def put(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    F = result["trans"].shape[0]
    with torch.no_grad():
        verts = lbs_forward(model, put(result["pose_body"]), put(result["betas"]),
                            put(result["root_orient"]), put(result["trans"]))["vertices"]
        hmr_verts = None
        if args.show_hmr:
            hmr_verts = lbs_forward(
                model, put(img_smpl.pose_body[:F]),
                put(np.broadcast_to(img_smpl.betas[:1], (F, 10))),
                put(img_smpl.root_orient[:F]), put(img_smpl.trans[:F]))["vertices"]
    return {"result": result, "points": pts, "verts": verts.cpu().numpy(),
            "hmr_verts": None if hmr_verts is None else hmr_verts.cpu().numpy(),
            "freq": markers.get_frequency()}


def render_solution(model, solved: Dict[str, Any], video_path=None, cull=None,
                    viewer: bool = False):
    """The host half: the solved body (faces of the parts ``cull`` keeps),
    the prior body if posed, and the labelled markers, as
    ``solve_sequence`` hands them over."""
    from uuo_mocap_tpu_torch.utils.mesh import cull_parts
    from uuo_mocap_tpu_torch.vis.renderer import VideoMocapRenderer
    from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene

    verts, hmr_verts, pts = solved["verts"], solved["hmr_verts"], solved["points"]
    faces = model.faces
    if cull:
        faces = cull_parts(faces, model.vertex_part_labels().cpu().numpy(), cull)

    labels_m = solved["result"]["markers_labels"]
    scene = VideoMocapScene()

    def render_frame(s, frame):
        s.add_mesh(verts[frame], faces)
        if hmr_verts is not None:
            s.add_mesh(hmr_verts[frame], model.faces, color=(0.9, 0.7, 0.4), name="hmr")
        s.add_markers(pts[frame], labels=labels_m[min(frame, labels_m.shape[0] - 1)])

    return VideoMocapRenderer(scene, render_frame, verts.shape[0], video_path,
                              solved["freq"]).run(interactive=viewer)


def main(argv=None):
    from uuo_mocap_tpu_torch.cli.test import device_from_args
    from uuo_mocap_tpu_torch.eval.comparisons import default_model_provider

    args = build_parser().parse_args(argv)
    model = default_model_provider(args.body_models, device=device_from_args(args))("neutral")
    solved = solve_sequence(args, model)
    path = render_solution(model, solved, args.video, args.cull_parts, args.viewer)
    print("wrote", path)
    return dict(solved, path=path)


if __name__ == "__main__":
    main()
