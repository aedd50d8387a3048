"""Replay a saved solve journal: per-stage parameter snapshots -> renders
(counterpart of ``uuo_mocap_tpu/vis/visualize_iterations.py``).

``replay_vertices`` is the device half (each snapshot's LBS forward, on the
model's device: the card unless ``--cpu_only``); ``main`` renders each
snapshot on the host (matplotlib), assembles per-stage gifs (PIL) and plots
the recorded hypothesis scores.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward


def replay_vertices(entries: Dict[str, List[dict]], model: BodyModel, lane: int = 0
                    ) -> List[Tuple[float, str, int, np.ndarray]]:
    """The journal's snapshots in time order, each posed: [(t, stage, record
    index, vertices [F, V, 3])].  A per-segment record follows ``lane`` (a
    record where the lane had already retired is skipped)."""
    timeline = []
    for stage, records in entries.items():
        for ri, rec in enumerate(records):
            timeline.append((rec.get("t", 0.0), stage, ri, rec))
    timeline.sort(key=lambda e: e[:3])

    dev = model.device
    out = []
    for t, stage, ri, rec in timeline:
        params = rec.get("params")
        if params is None:
            continue
        if "lanes" in rec:  # per-segment snapshot: pick the requested lane
            pos = np.where(np.asarray(rec["lanes"]) == lane)[0]
            if pos.size == 0:
                continue
            params = {k: np.asarray(v)[int(pos[0])] for k, v in params.items()}

        def put(k):
            return torch.as_tensor(np.array(params[k], np.float32), device=dev)

        pose = put("pose_body")
        F = pose.shape[0]
        with torch.no_grad():
            verts = lbs_forward(model, pose, put("betas").expand(F, 10), put("root_orient"),
                                put("trans"))["vertices"]
        out.append((t, stage, ri, verts.cpu().numpy()))
    return out


def main(argv=None):
    from uuo_mocap_tpu_torch.cli.test import device_from_args
    from uuo_mocap_tpu_torch.eval.comparisons import default_model_provider

    parser = argparse.ArgumentParser()
    parser.add_argument("--journal", required=True, help="pkl from --save_iterations")
    parser.add_argument("--markers", type=str, default=None, help=".c3d for context")
    parser.add_argument("--out_dir", type=str, default="render_iterations")
    parser.add_argument("--frame", type=int, default=0, help="frame to render per stage")
    parser.add_argument("--lane", type=int, default=0,
                        help="hypothesis lane to follow through __segments entries")
    parser.add_argument("--gif", action="store_true",
                        help="assemble per-stage replay gifs from the segment snapshots")
    parser.add_argument("--body_models", type=str, default="./body_models")
    parser.add_argument("--cpu_only", action="store_true", help="run the forwards on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from uuo_mocap_tpu_torch.pipeline.journal import IterationJournal
    from uuo_mocap_tpu_torch.vis.renderer import VideoMocapRenderer
    from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene

    model = default_model_provider(args.body_models, device=device_from_args(args))("neutral")
    entries = IterationJournal.load(args.journal)
    os.makedirs(args.out_dir, exist_ok=True)

    markers = None
    if args.markers:
        from uuo_mocap_tpu_torch.data.markers import Markers

        markers = np.nan_to_num(Markers(args.markers).get_points(), nan=0.0)

    stage_pngs: Dict[str, List[str]] = {}
    for t, stage, ri, verts in replay_vertices(entries, model, args.lane):
        frame = min(args.frame, verts.shape[0] - 1)
        scene = VideoMocapScene()

        def render_frame(s, _f, verts=verts, frame=frame):
            s.add_mesh(verts[frame], model.faces)
            if markers is not None:
                s.add_markers(markers[min(frame, markers.shape[0] - 1)])

        path = os.path.join(args.out_dir, f"{t:08.2f}_{stage}_{ri}.png")
        VideoMocapRenderer(scene, render_frame, 1, None).run()
        os.replace(os.path.join(os.getcwd(), "render_preview.png"), path)
        stage_pngs.setdefault(stage, []).append(path)
        print("wrote", path)

    if args.gif:
        # the within-stage evolution as replay gifs of the segment snapshots
        from PIL import Image

        for stage, paths in stage_pngs.items():
            if len(paths) < 2:
                continue
            frames = [Image.open(p) for p in paths]
            gif_path = os.path.join(args.out_dir, f"replay_{stage}.gif")
            frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                           duration=350, loop=0)
            print("wrote", gif_path)

    for stage, records in entries.items():  # hypothesis scores, where recorded
        for rec in records:
            if "scores" in rec:
                fig, ax = plt.subplots()
                ax.bar(range(len(rec["scores"])), rec["scores"])
                ax.set_xlabel("yaw hypothesis")
                ax.set_ylabel("chamfer score")
                fig.savefig(os.path.join(args.out_dir, f"scores_{stage}.png"))
                plt.close(fig)
    return stage_pngs


if __name__ == "__main__":
    main()
