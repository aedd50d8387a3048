"""Dataset viewer and synthetic-marker viewer (counterpart of
``uuo_mocap_tpu/vis/visualize_dataset.py``): render a dataset sample's body
and its generated virtual markers.

``dataset_sample`` is the device half (the sample and its LBS forward on
the synthetic body, on the card unless ``--cpu_only``); ``main`` renders on
the host (matplotlib).
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch


def dataset_sample(body, amass_dir: Optional[str] = None, index: int = 0,
                   num_markers: int = 41, frames: int = 64, structured: bool = False):
    """-> (vertices [F, V, 3], markers [F', M, 3], marker labels [M]) as
    numpy: ``DatasetMocap``'s sample ``index`` with its virtual markers, or
    with ``structured`` the cmu_41 layout's markers on a procedural motion
    seeded by ``index``."""
    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.data.amass import DatasetMocap

    ds = DatasetMocap(body, amass_dir=amass_dir, sequence_length=frames, num_markers=num_markers)
    params = ds._load_params(index)
    if structured:
        from uuo_mocap_tpu_torch.data.markers_synthetic import MarkersSyntheticStructured

        mk = MarkersSyntheticStructured(body, num_frames=frames, seed=index)
        markers, labels = mk.get_points(), np.asarray(mk.marker_labels)
        params = mk.gt_params
    else:
        sample = ds.compute_markers(params)
        markers, labels = sample["markers"], sample["marker_labels"]

    F = params.trans.shape[0]
    with torch.no_grad():
        out = lbs_forward(body, params.pose_body, params.betas.expand(F, 10),
                          params.root_orient, params.trans)
    return out["vertices"].cpu().numpy(), np.asarray(markers), np.asarray(labels)


def main(argv=None):
    from uuo_mocap_tpu_torch.cli.test import device_from_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--amass_dir", type=str, default=None)
    parser.add_argument("--index", type=int, default=0)
    parser.add_argument("--num_markers", type=int, default=41)
    parser.add_argument("--frames", type=int, default=64)
    parser.add_argument("--structured", action="store_true", help="cmu_41 layout markers")
    parser.add_argument("--video", type=str, default=None)
    parser.add_argument("--cpu_only", action="store_true", help="run the forward on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    args = parser.parse_args(argv)

    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.vis.renderer import VideoMocapRenderer
    from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene

    body = synthetic_body_model(device=device_from_args(args))
    verts, markers, labels = dataset_sample(body, args.amass_dir, args.index, args.num_markers,
                                            args.frames, args.structured)
    F = min(verts.shape[0], markers.shape[0])

    scene = VideoMocapScene()

    def render_frame(s, frame):
        s.add_mesh(verts[frame], body.faces)
        s.add_markers(markers[frame], labels=labels)

    path = VideoMocapRenderer(scene, render_frame, F, args.video).run()
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
