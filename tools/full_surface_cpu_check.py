#!/usr/bin/env python3
"""Both packages on the CPU on sequences of chip_smoke.py's random batch, cut
to their first frames and with every stage capped: the JAX
``MultiSequenceSolver`` and the port's, under the shipped batch config and
under ``chip_smoke.FULL_SURFACE`` (and the same without the terms that
assume a z = 0 ground).  Prints each sequence's MPJPE (mm) per package and
variant: whether an accuracy seen on the card is the configuration's own or
the port's.

    JAX_PLATFORMS=cpu python3 tools/full_surface_cpu_check.py \\
        [--frames 48] [--iters 20] [--seqs 1 2] [--variants full_surface no_ground shipped]
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
    ap.add_argument("--seqs", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--variants", nargs="+", default=["full_surface", "no_ground", "shipped"])
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
    # the synthetic mesh's long faces (a barycentric attachment on one
    # follows distant vertices) and its vertical extent, in the first
    # sequence's first frame
    gt0 = random_pose_sequence(1, seed=C.BATCH_SEED0 + 3 * args.seqs[0], yaw=0.9, travel=0.5,
                               device="cpu")
    with torch.no_grad():
        v = lbs_forward(tm, gt0.pose_body, gt0.betas, gt0.root_orient, gt0.trans)["vertices"][0]
    v, f = v.numpy().astype(np.float64), np.asarray(tm.faces)
    edge = np.max([np.linalg.norm(v[f[:, i]] - v[f[:, (i + 1) % 3]], axis=-1) for i in range(3)],
                  axis=0)
    area = 0.5 * np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]), axis=-1)
    long = edge > 0.2
    print(f"mesh: {len(f)} faces, {int(long.sum())} with an edge over 20 cm (longest "
          f"{edge.max():.3f} m), {area[long].sum() / area.sum():.3f} of the area; vertex z "
          f"{v[:, 2].min():.3f} to {v[:, 2].max():.3f} m", flush=True)
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

        j = joints(out["pose_body"], out["betas"], out["root_orient"], out["trans"])
        j_gt = joints(gt.pose_body, np.broadcast_to(gt.betas, (Fc, 10)), gt.root_orient, gt.trans)
        return round(float(torch.linalg.norm(j - j_gt, dim=-1).mean()) * 1e3, 2)

    def config(variant):
        cfg = jax_load_config(os.path.join(HERE, "configs", "video_mocap.yaml"))
        cfg["parallel"] = {"lane_width": 16, "part_lane_width": 16, "pad_width": True,
                           "hypothesis_prune": {"enabled": True, "at_iters": [5, 10],
                                                "keep": [2, 1], "frame_stride": 1},
                           "part_prune": {"enabled": True, "at_iters": 5, "keep": 2}}
        if variant != "shipped":
            C.merge_config(cfg, C.FULL_SURFACE)
        if variant == "no_ground":
            del cfg["stages"]["root"]["losses"]["ground"]
            for k in ("ground", "foot_contact", "foot_velocity"):
                del cfg["stages"]["part"]["losses"][k]
        for stage in ("root", "part", "chamfer", "marker"):
            if cfg["stages"][stage]["num_iters"] > 0:
                cfg["stages"][stage]["num_iters"] = args.iters
        return cfg

    for variant in args.variants:
        t0 = time.time()
        ours = MultiSequenceSolver(tm, copy.deepcopy(config(variant)), device="cpu").solve_prepared(
            [prepare_sequence(ImgSmpl.from_params(p), ArrayMarkers(m.copy()), frame_bucket=None)
             for _, m, p in seqs])
        t1 = time.time()
        ref = JaxSolver(jm, config(variant)).solve_prepared(
            [jax_prepare(JaxImgSmpl.from_params(p), JaxArrayMarkers(m.copy()), frame_bucket=None)
             for _, m, p in seqs])
        t2 = time.time()
        print(f"{variant}: F={Fc} iters={args.iters} sequences {args.seqs}: MPJPE port "
              f"{[mpjpe(r, g) for r, (g, _, _) in zip(ours['results'], seqs)]} reference "
              f"{[mpjpe(r, g) for r, (g, _, _) in zip(ref['results'], seqs)]} mm "
              f"(port {t1 - t0:.0f} s, reference {t2 - t1:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
