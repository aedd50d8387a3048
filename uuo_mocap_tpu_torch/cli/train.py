"""Train the neural model families and write their checkpoints (counterpart
of ``uuo_mocap_tpu/cli/train.py``, with the same flags and names).

Every model trains on synthetic motions of the body model
(``models/train.py``) and is written as a flax msgpack checkpoint under
``--checkpoints``, where the pipeline and the JAX package read it
(``marker_segmenter/final/model.msgpack``, ``barycentric_coords/pos2bc/...``
and so on).  Training runs on the card unless ``--cpu_only``.  The default
``./checkpoints`` is where the shipped weights lie: training there replaces
them.

Usage:
    python -m uuo_mocap_tpu_torch.cli.train --models marker_segmenter pos2bc \
        --steps 500 --checkpoints ./my_checkpoints
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List

MODELS = (
    "marker_segmenter",
    "marker_segmenter_multimodal",
    "pos2bc",
    "pos_diff",
    "motion_embedding",
    "foot_contact",
)


def main(argv=None) -> Dict[str, List[float]]:
    """Train ``--models`` in order; returns each one's loss history."""
    parser = argparse.ArgumentParser(description="train the uuo_mocap_tpu_torch models")
    parser.add_argument("--models", nargs="+", default=list(MODELS), choices=list(MODELS))
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--num_markers", type=int, default=41)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoints", type=str, default="./checkpoints")
    parser.add_argument("--body_models", type=str, default="./body_models",
                        help="SMPL asset dir; synthetic test model if missing")
    parser.add_argument("--cpu_only", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    from uuo_mocap_tpu_torch.convert import to_flax
    from uuo_mocap_tpu_torch.device import resolve_device
    from uuo_mocap_tpu_torch.models import train as T
    from uuo_mocap_tpu_torch.models.checkpoints import save_params

    device = resolve_device("cpu" if args.cpu_only else None)
    if os.path.exists(args.body_models):
        from uuo_mocap_tpu_torch.body.model import load_body_model

        body = load_body_model(args.body_models, "neutral", device=device)
    else:
        from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model

        body = synthetic_body_model(device=device)

    common = dict(steps=args.steps, lr=args.lr, seed=args.seed)
    histories = {}
    for name in args.models:
        print(f"=== training {name} ({args.steps} steps) ===", flush=True)
        if name in ("marker_segmenter", "marker_segmenter_multimodal"):
            train = (T.train_marker_segmenter if name == "marker_segmenter"
                     else T.train_marker_segmenter_multimodal)
            net, hist = train(body, batch=args.batch, num_markers=args.num_markers, **common)
            save_params(to_flax(net), args.checkpoints, name)
        elif name == "pos2bc":
            net, hist = T.train_pos2bc(body, **common)
            save_params(to_flax(net), args.checkpoints, "barycentric_coords/pos2bc")
        elif name == "pos_diff":
            net, hist = T.train_pos_diff(body, **common)
            save_params(to_flax(net), args.checkpoints, "barycentric_coords/pos_diff")
        elif name == "motion_embedding":
            (m_net, j_net), hist = T.train_motion_embedding(body, batch=args.batch, **common)
            save_params(to_flax(m_net), args.checkpoints, "motion_embedding/markers")
            save_params(to_flax(j_net), args.checkpoints, "motion_embedding/joints")
        else:
            net, hist = T.train_foot_contact(body, batch=args.batch, **common)
            save_params(to_flax(net), args.checkpoints, "foot_contact")
        print(f"  loss {hist[0]:.4f} -> {hist[-1]:.4f}", flush=True)
        histories[name] = hist
    return histories


if __name__ == "__main__":
    main()
