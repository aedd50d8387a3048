#!/usr/bin/env python3
"""How stable the reference's reprojection stage is, seed by seed, and how
far the port lands from it, on the CPU at ``tests/test_torch_reprojection.py``'s
size (F = 10 frames, M = 20 markers, V = 6890, 10 iterations).

For each yaw seed and each crop camera it prints the reference's metrics,
how far they move when the markers are scaled by 1 + 1e-6 (``--scale``;
relative), how far the port's land from them (relative), and the same two
numbers (absolute, largest entry) for each output.  A seed whose metrics move by more than the
parity bound under that scaling cannot be held to the reference; the test
keeps only seeds where they do not.

    JAX_PLATFORMS=cpu python3 tools/reprojection_seed_check.py [--bbox 0.04 1.0] [--scale S]
"""
from __future__ import annotations

import argparse
import copy
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

F, M, ITERS = 10, 20, 10
SEEDS = np.array([0, np.pi / 4, np.pi / 3, np.pi / 2, 2 * np.pi / 3, 3 * np.pi / 4, np.pi,
                  -3 * np.pi / 4, -2 * np.pi / 3, -np.pi / 2, -np.pi / 3, -np.pi / 4], np.float32)
OUTPUTS = ("betas", "root_orient", "trans", "cam_trans", "output_angle", "joints_2d")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bbox", type=float, nargs="+", default=[0.04, 1.0],
                    help="crop camera scales s: the depth is 2 x 5000 / (s x 51200 px)")
    ap.add_argument("--scale", type=float, default=1 + 1e-6,
                    help="the marker scaling that measures the reference's own move")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from uuo_mocap_tpu.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu.data.config import load_config
    from uuo_mocap_tpu.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params, random_pose_sequence
    from uuo_mocap_tpu.ops.geometry import get_marker_mask
    from uuo_mocap_tpu.pipeline.reprojection import ReprojectionStage as JaxReprojectionStage
    from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
    from uuo_mocap_tpu_torch.pipeline.reprojection import ReprojectionStage

    jm = synthetic_body_model()
    tm = body_model_from_numpy(body_model_arrays(jm), device="cpu")
    cfg = load_config(os.path.join(HERE, "configs", "video_mocap.yaml"))
    cfg["stages"]["reprojection_part"]["num_iters"] = ITERS
    gt = random_pose_sequence(F, seed=3)
    mk = np.array(generate_markers(jm, gt, num_markers=M, seed=4).points)
    prior = perturb_params(gt, seed=5)
    ref_stage = JaxReprojectionStage(jm, cfg)
    port_stage = ReprojectionStage(tm, copy.deepcopy(cfg))

    for s in args.bbox:
        img = ImgSmpl.from_params(prior)
        camera = {"camera_bbox": (s, 0.0, 0.0), "center": (320.0, 240.0), "scale": (200.0,),
                  "size": (480.0, 640.0)}
        for name, value in camera.items():
            setattr(img, name, np.tile(np.array(value, np.float32), (F, 1)))
        inputs = [mk, np.array(get_marker_mask(jnp.asarray(mk)))] + [
            np.array(a, np.float32) for a in (
                img.pose_body, img.betas[:1], img.betas, img.hmr_root_orient, img.trans,
                img.camera_bbox, img.center, img.size, img.scale, np.ones(F))]

        def reference(scale):
            args_ = [inputs[0] * np.float32(scale)] + inputs[1:]
            out = ref_stage(jnp.asarray(SEEDS), *(jnp.asarray(a) for a in args_))
            return jax.tree_util.tree_map(np.asarray, out)

        r, m = reference(1.0), reference(args.scale)
        o = port_stage(torch.as_tensor(SEEDS), *(torch.as_tensor(a) for a in inputs))
        o = {k: (v.numpy() if k != "metrics" else {q: x.numpy() for q, x in v.items()})
             for k, v in o.items()}
        print(f"crop camera ({s}, 0, 0): depth {2 * 5000 / (s * 51200):.2f} m", flush=True)
        for i, seed in enumerate(SEEDS):
            line = f"  seed {seed:+.4f}"
            for key in ("reproject", "chamfer"):
                rv, mv, ov = (float(x["metrics"][key][i]) for x in (r, m, o))
                line += (f" | {key} {rv:.6g}: moved {abs(mv - rv) / abs(rv):.2e},"
                         f" port {abs(ov - rv) / abs(rv):.2e}")
            line += " |"
            for k in OUTPUTS:
                line += (f" {k} {float(np.abs(m[k][i] - r[k][i]).max()):.1e}"
                         f"/{float(np.abs(o[k][i] - r[k][i]).max()):.1e}")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
