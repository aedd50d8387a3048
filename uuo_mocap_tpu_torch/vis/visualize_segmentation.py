"""Run the neural part segmenter on synthetic markers and render predicted
part colors and a confusion matrix (counterpart of
``uuo_mocap_tpu/vis/visualize_segmentation.py``): train-or-load, then
visualize.

``load_or_train`` and ``predict_parts`` are the device half (the segmenter
read from ``--checkpoints`` through ``models/checkpoints.py``, or trained
there by ``models/train.py`` when absent; its forward on a synthetic
sequence; on the card unless ``--cpu_only``); ``main`` renders on the host
(matplotlib).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def load_or_train(body, checkpoints: str, multimodal: bool = False, train_steps: int = 200,
                  num_markers: int = 41):
    """The segmenter on ``body``'s device: read from ``checkpoints``, or
    trained for ``train_steps`` and written there when its file is absent.
    -> (net, training losses or None)."""
    from uuo_mocap_tpu_torch import convert
    from uuo_mocap_tpu_torch.models import train as T
    from uuo_mocap_tpu_torch.models.checkpoints import checkpoint_path, load_params, save_params

    name = "marker_segmenter_multimodal" if multimodal else "marker_segmenter"
    build = (convert.marker_segmenter_multimodal_from_flax if multimodal
             else convert.marker_segmenter_from_flax)
    if os.path.exists(checkpoint_path(checkpoints, name)):
        return build(load_params(checkpoints, name), body.device), None
    train_fn = T.train_marker_segmenter_multimodal if multimodal else T.train_marker_segmenter
    net, hist = train_fn(body, steps=train_steps, num_markers=num_markers)
    save_params(convert.to_flax(net), checkpoints, name)
    print(f"trained {name}: loss {hist[0]:.3f} -> {hist[-1]:.3f}")
    return build(load_params(checkpoints, name), body.device), hist


def predict_parts(body, net, multimodal: bool = False, num_markers: int = 41,
                  frames: int = 64, seed: int = 0):
    """A synthetic sequence's markers (``num_markers`` random vertices) and
    the segmenter's part per marker and frame -> numpy (markers [F, M, 3],
    predicted parts [F, M], true parts [M])."""
    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.data.synthetic import random_pose_sequence

    F = frames
    gt = random_pose_sequence(F, seed=seed, device=body.device)
    with torch.no_grad():
        out = lbs_forward(body, gt.pose_body, gt.betas.expand(F, 10), gt.root_orient, gt.trans)
        rng = np.random.RandomState(seed)
        vid = rng.choice(body.num_vertices, num_markers, replace=False)
        markers = out["vertices"][:, torch.as_tensor(vid, device=body.device)]
        true_labels = body.vertex_part_labels().cpu().numpy()[vid]
        if multimodal:
            probs = net.forward_sequence(markers, out["joints"][:, :22])
        else:
            probs = net.forward_sequence(markers)
    return markers.cpu().numpy(), probs.argmax(dim=-1).cpu().numpy(), true_labels


def main(argv=None):
    from uuo_mocap_tpu_torch.cli.test import device_from_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoints", type=str, default="./checkpoints")
    parser.add_argument("--multimodal", action="store_true")
    parser.add_argument("--train_steps", type=int, default=200, help="train if no checkpoint")
    parser.add_argument("--num_markers", type=int, default=41)
    parser.add_argument("--frames", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--video", type=str, default=None)
    parser.add_argument("--confusion", type=str, default=None, help="confusion matrix png")
    parser.add_argument("--cpu_only", action="store_true", help="run the network on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    args = parser.parse_args(argv)

    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.vis.plots import plot_confusion_matrix
    from uuo_mocap_tpu_torch.vis.renderer import VideoMocapRenderer
    from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene

    body = synthetic_body_model(device=device_from_args(args))
    net, _ = load_or_train(body, args.checkpoints, args.multimodal, args.train_steps,
                           args.num_markers)
    markers, pred, true_labels = predict_parts(body, net, args.multimodal, args.num_markers,
                                               args.frames, args.seed)
    F = args.frames
    acc = float((pred == true_labels[None]).mean())
    print(f"per-marker part accuracy: {acc:.3f}")

    if args.confusion:
        plot_confusion_matrix(args.confusion, np.tile(true_labels, (F, 1)), pred)
        print("wrote", args.confusion)

    scene = VideoMocapScene()

    def render_frame(s, frame):
        s.add_markers(markers[frame], labels=pred[frame])

    path = VideoMocapRenderer(scene, render_frame, F, args.video).run()
    print("wrote", path)
    return {"accuracy": acc, "pred": pred, "true_labels": true_labels, "path": path}


if __name__ == "__main__":
    main()
