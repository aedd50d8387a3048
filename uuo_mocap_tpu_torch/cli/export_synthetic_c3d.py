"""Write a synthetic unstructured-marker c3d dataset with its ground truth
(counterpart of ``uuo_mocap_tpu/cli/export_synthetic_c3d.py``, with the same
flags and layout):

    <input_dir>/<dataset>/mocap_synthetic___<seed>_<M>/<subject>/<seq>.c3d
        (``mocap_parts___<parts>`` with ``--structured --parts``)
    <input_dir>/<dataset>/smpl/<subject>/<seq>_stageii.npz   (ground truth)
    <input_dir>/<dataset>/comparisons/4d_humans/<subject>/<seq>/results/demo_<seq>.pkl
        (a 4D-Humans-style prior, perturbed from the ground truth by default)

Sequence i (in subject-major order) uses seed ``--seed`` + i.  Motion is
procedural; markers sit at random surface vertices (or a named layout's
with ``--structured``).  The prior pkl is a plain pickle, readable by the
port's ``load_pkl`` and by ``joblib.load``.  The model and the markers are
made on the card unless ``--cpu_only``.

Usage:
    python -m uuo_mocap_tpu_torch.cli.export_synthetic_c3d --input_dir ./data \
        --dataset synthetic_demo --subjects s1 --sequences walk_000 \
        --num_markers 41 --seed 0
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--subjects", nargs="+", default=["s1"])
    parser.add_argument("--sequences", nargs="+", default=["seq_000"])
    parser.add_argument("--num_markers", type=int, default=41)
    parser.add_argument("--num_frames", type=int, default=450)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--freq", type=float, default=30.0)
    parser.add_argument("--structured", action="store_true", help="use the --layout layout")
    parser.add_argument("--layout", type=str, default="cmu_41")
    parser.add_argument("--parts", nargs="+", default=None, help="limb subset for structured export")
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--prior", choices=["perturbed", "gt", "none"], default="perturbed",
                        help="also write a 4D-Humans-style demo pkl, so cli.test runs the "
                             "synthetic closed loop without video assets")
    parser.add_argument("--prior_pose_noise", type=float, default=0.05)
    parser.add_argument("--prior_trans_noise", type=float, default=0.08)
    parser.add_argument("--cpu_only", action="store_true", help="run on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    args = parser.parse_args(argv)

    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.cli.test import device_from_args
    from uuo_mocap_tpu_torch.data.c3d import write_c3d
    from uuo_mocap_tpu_torch.data.markers_synthetic import (
        MarkersSynthetic, MarkersSyntheticStructured)
    from uuo_mocap_tpu_torch.ops import rotations as rot

    model = synthetic_body_model(device=device_from_args(args))
    if args.structured and args.parts:
        mocap_dirname = "mocap_parts___" + "_".join(args.parts)
    else:
        mocap_dirname = f"mocap_synthetic___{args.seed}_{args.num_markers}"

    base = os.path.join(args.input_dir, args.dataset)
    seed = args.seed
    for subject in args.subjects:
        for seq in args.sequences:
            if args.structured:
                mk = MarkersSyntheticStructured(
                    model, layout=args.layout, num_frames=args.num_frames, seed=seed,
                    freq=args.freq, parts=args.parts, shuffle=args.shuffle)
            else:
                mk = MarkersSynthetic(
                    model, num_frames=args.num_frames, num_markers=args.num_markers, seed=seed,
                    freq=args.freq, shuffle=args.shuffle)
            out_dir = os.path.join(base, mocap_dirname, subject)
            os.makedirs(out_dir, exist_ok=True)
            write_c3d(os.path.join(out_dir, seq + ".c3d"), mk.get_points(), rate=args.freq, units="m")

            # the ground truth in the MoSh++ npz schema, for the evaluation
            gt = mk.gt_params
            poses_aa = rot.matrix_to_axis_angle(torch.cat([gt.root_orient, gt.pose_body], dim=1))
            gt_dir = os.path.join(base, "smpl", subject)
            os.makedirs(gt_dir, exist_ok=True)
            np.savez(os.path.join(gt_dir, seq + "_stageii.npz"),
                     poses=poses_aa.reshape(poses_aa.shape[0], -1).cpu().numpy(),
                     betas=gt.betas[0].cpu().numpy(), trans=gt.trans.cpu().numpy(),
                     mocap_frame_rate=args.freq, gender="neutral")
            print(f"wrote {out_dir}/{seq}.c3d ({mk.get_num_markers()} markers, {len(mk)} frames)")

            if args.prior != "none":
                _write_prior_pkl(base, subject, seq, model, gt, args, seed)
            seed += 1


def _write_prior_pkl(base, subject, seq, model, gt, args, seed) -> str:
    """A PHALP/4D-Humans demo pkl (the schema ``ImgSmpl`` parses) of the
    ground truth, perturbed with seed ``seed + 77`` unless ``--prior gt``.
    The camera streams stay empty (the reprojection stages are off in the
    shipped config)."""
    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.data.img_smpl import CORRECTION_MATRIX
    from uuo_mocap_tpu_torch.data.pkl_io import dump_pkl
    from uuo_mocap_tpu_torch.data.synthetic import perturb_params
    from uuo_mocap_tpu_torch.utils.foot_contact import JOINTS_2D

    prior = gt if args.prior == "gt" else perturb_params(
        gt, seed=seed + 77, pose_noise=args.prior_pose_noise, trans_noise=args.prior_trans_noise)
    F = prior.trans.shape[0]
    with torch.no_grad():
        joints = lbs_forward(model, prior.pose_body, prior.betas, prior.root_orient,
                             prior.trans)["joints"].cpu().numpy()
    root = prior.root_orient.cpu().numpy()
    pose = prior.pose_body.cpu().numpy()
    betas = np.broadcast_to(prior.betas.cpu().numpy(), (F, 10))
    C_inv = CORRECTION_MATRIX.T  # orthogonal; the parser applies C @ global_orient
    data = {}
    for f in range(F):
        j3d = np.asarray(joints[f, :45], np.float32).copy()
        j3d[JOINTS_2D["pelvis_low"]] = joints[f, 0]  # the parser reads trans here
        data[f"frame_{f:06d}.jpg"] = {
            "tracked_ids": [0],
            "smpl": [{
                "global_orient": C_inv @ root[f, 0],
                "body_pose": pose[f],
                "betas": np.asarray(betas[f], np.float32),
            }],
            "3d_joints": [j3d],
            "2d_joints": [np.zeros(90, np.float32)],
            "camera_bbox": [],
            "center": [],
            "scale": [],
            "size": [],
        }
    pkl_dir = os.path.join(base, "comparisons", "4d_humans", subject, seq, "results")
    os.makedirs(pkl_dir, exist_ok=True)
    path = dump_pkl(data, os.path.join(pkl_dir, "demo_" + seq + ".pkl"))
    print(f"wrote {path} ({args.prior} prior)")
    return path


if __name__ == "__main__":
    main()
