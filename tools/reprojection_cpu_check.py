#!/usr/bin/env python3
"""Both packages on the CPU on chip_smoke.py's random batch with camera
streams and both reprojection stages on, the sequences cut to their first
frames and every stage capped: the JAX ``MultiSequenceSolver`` and the
port's, with chip_smoke's camera streams (centre (320, 240), scale 200, size
(480, 640)) under each crop camera asked for.  Prints each sequence's MPJPE
(mm) per package, and the prior's: whether an accuracy seen on the card is
the configuration's own or the port's.

    JAX_PLATFORMS=cpu python3 tools/reprojection_cpu_check.py \\
        [--frames 48] [--iters 20] [--reproj_iters N] [--seqs 0 1 2 3] [--bbox 0.04 1.0]
"""
from __future__ import annotations

import argparse
import copy
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import chip_smoke as C  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reproj_iters", type=int, default=None,
                    help="the reprojection stages' cap (default: --iters)")
    ap.add_argument("--seqs", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--bbox", type=float, nargs="+", default=[0.04, 1.0],
                    help="crop camera scales s: the depth is 2 x 5000 / (s x 51200 px)")
    args = ap.parse_args()
    import torch

    from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
    from uuo_mocap_tpu.data.config import load_config as jax_load_config
    from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
    from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
    from uuo_mocap_tpu.parallel.batch_solver import MultiSequenceSolver as JaxSolver
    from uuo_mocap_tpu.pipeline.multimodal import prepare_sequence as jax_prepare
    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
    from uuo_mocap_tpu_torch.data.synthetic import (
        generate_markers, perturb_params, random_pose_sequence)
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
    from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence

    jm = jax_synthetic_body_model()
    tm = body_model_from_numpy(body_model_arrays(jm), device="cpu")
    Fc = args.frames
    seqs = []
    for q in args.seqs:  # chip_smoke.make_batch's seeds, made at 450 frames, then cut
        s = C.BATCH_SEED0 + 3 * q
        gt = random_pose_sequence(C.F_FRAMES, seed=s, yaw=0.9, travel=0.5, device="cpu")
        mk = generate_markers(tm, gt, num_markers=C.N_MARKERS, seed=s + 1,
                              occlusion_rate=0.05).points
        prior = perturb_params(gt, seed=s + 2, pose_noise=0.05, trans_noise=0.08, betas_noise=0.2)

        def cut(p):
            return type(p)(*(np.ascontiguousarray(a.numpy()[:Fc]) if a.shape[0] == C.F_FRAMES
                             else a.numpy() for a in p))

        seqs.append((cut(gt), np.ascontiguousarray(mk.numpy()[:Fc]), cut(prior)))

    def mpjpe(out, gt):
        def joints(pose, betas, root, trans):
            with torch.no_grad():
                return lbs_forward(tm, *(torch.as_tensor(np.asarray(a, np.float32))
                                         for a in (pose, betas, root, trans)))["joints"][:, :22]

        betas = np.broadcast_to(np.asarray(out["betas"], np.float32).reshape(-1, 10)[:Fc], (Fc, 10))
        j = joints(out["pose_body"], betas, out["root_orient"], out["trans"])
        j_gt = joints(gt.pose_body, np.broadcast_to(gt.betas, (Fc, 10)), gt.root_orient, gt.trans)
        return round(float(torch.linalg.norm(j - j_gt, dim=-1).mean()) * 1e3, 2)

    def config():
        cfg = jax_load_config(os.path.join(HERE, "configs", "video_mocap.yaml"))
        cfg["parallel"] = {"lane_width": 16, "part_lane_width": 16, "pad_width": True,
                           "hypothesis_prune": {"enabled": True, "at_iters": [5, 10],
                                                "keep": [2, 1], "frame_stride": 1},
                           "part_prune": {"enabled": True, "at_iters": 5, "keep": 2}}
        for stage in ("part", "chamfer", "marker"):
            cfg["stages"][stage]["num_iters"] = args.iters
        for key in ("reprojection_part", "reprojection_full"):
            cfg["stages"][key].update(num_iters=args.reproj_iters or args.iters,
                                      num_angles=C.REPROJ_ANGLES)
        return cfg

    def with_camera(img, bbox):
        camera = dict(C.REPROJ_CAMERA, camera_bbox=(bbox, 0.0, 0.0))
        for name, value in camera.items():
            setattr(img, name, np.tile(np.array(value, np.float32), (Fc, 1)))
        return img

    print(f"prior MPJPE {[mpjpe(p._asdict(), g) for g, _, p in seqs]} mm", flush=True)
    for bbox in args.bbox:
        t0 = time.time()
        ours = MultiSequenceSolver(tm, copy.deepcopy(config()), device="cpu").solve_prepared(
            [prepare_sequence(with_camera(ImgSmpl.from_params(p), bbox), ArrayMarkers(m.copy()),
                              frame_bucket=None) for _, m, p in seqs])
        t1 = time.time()
        ref = JaxSolver(jm, config()).solve_prepared(
            [jax_prepare(with_camera(JaxImgSmpl.from_params(p), bbox),
                         JaxArrayMarkers(m.copy()), frame_bucket=None) for _, m, p in seqs])
        t2 = time.time()
        print(f"crop camera ({bbox}, 0, 0), depth {2 * 5000 / (bbox * 51200):.2f} m: F={Fc} "
              f"iters={args.iters} (reprojection {args.reproj_iters or args.iters}) sequences "
              f"{args.seqs}: MPJPE port "
              f"{[mpjpe(r, g) for r, (g, _, _) in zip(ours['results'], seqs)]} reference "
              f"{[mpjpe(r, g) for r, (g, _, _) in zip(ref['results'], seqs)]} mm "
              f"(port {t1 - t0:.0f} s, reference {t2 - t1:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
