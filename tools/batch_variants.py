#!/usr/bin/env python3
"""Solve chip_smoke.py's batch (bench.py's random-layout batch: 4 x 450 x
41, seed0 = 2000, or other seeds) under variants of the hypothesis cascade,
on one GPU, and compare accuracy and work.

    python3 tools/batch_variants.py [--variants shared,per_frame,stride1] [--seed0 2000,...]

Variants (each a fresh ``MultiSequenceSolver`` in this process, the
kernels built once):
  * ``shared``: the port as it ships, with bench.py's settings (frame
    stride 2,1; betas shared by the frames of a lane);
  * ``per_frame``: the same, but the strided round hands its betas to the
    full-frame round broadcast to every frame, as the JAX reference's
    ``upsample_lane_params`` does (``uuo_mocap_tpu/parallel/batch_solver.py:
    68-81``), so the later stages fit per-frame betas;
  * ``stride1``: frame stride 1 in both rounds (no strided round), as
    chip_smoke.py's batch phase runs it.
Each prints one JSON line: per-sequence MPJPE (mm) and its mean, median and
max, the solve time, stage times, L-BFGS evaluations per stage, the winning
hypotheses, kernel launches and an output digest.  Prints the nvidia-smi
line first.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def per_frame_upsample(upsample):
    """The reference's betas handling: the lane's [Ln, 1, 10] betas
    broadcast to [Ln, F, 10] at the upsampling."""
    from uuo_mocap_tpu_torch.pipeline.stages import SmplParams

    def run(params, F_full, stride):
        up = upsample(params, F_full, stride)
        betas = params.betas
        if betas.shape[1] == 1:
            betas = betas.expand(betas.shape[0], F_full, betas.shape[2]).contiguous()
        return SmplParams(up.pose_body, betas, up.root_orient, up.trans)

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="shared,per_frame,stride1")
    ap.add_argument("--seed0", default=str(2000), help="comma list of batch seeds")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.parallel import batch_solver

    if not torch.cuda.is_available():
        print("batch_variants: no CUDA device available", file=sys.stderr)
        return 1
    print(f"gpu: {cs.gpu_line()}", flush=True)
    K.build()
    model = synthetic_body_model(device="cuda")
    upsample = batch_solver.upsample_lane_params
    runs = [(int(seed0), name) for seed0 in args.seed0.split(",")
            for name in args.variants.split(",")]
    batches = {}
    for seed0, name in runs:
        if seed0 not in batches:
            batches[seed0] = cs.make_batch(model, seed0)
        gts, preps = batches[seed0]
        if name not in ("shared", "per_frame", "stride1"):
            raise ValueError(f"unknown variant {name!r}")
        cfg = cs.bench_parallel_config()
        cfg["parallel"]["hypothesis_prune"]["frame_stride"] = 1 if name == "stride1" else [2, 1]
        batch_solver.upsample_lane_params = (
            per_frame_upsample(upsample) if name == "per_frame" else upsample)
        solver = batch_solver.MultiSequenceSolver(model, cfg, device="cuda")
        K.reset_launch_counts()
        t0 = time.time()
        out = solver.solve_prepared(preps)
        torch.cuda.synchronize()
        solve_s = time.time() - t0
        errs = [cs.mpjpe_mm(model, r, gt) for r, gt in zip(out["results"], gts)]
        keys = ("trans", "root_orient", "pose_body", "betas")
        print(json.dumps({
            "seed0": seed0, "variant": name, "mpjpe_mm": errs, "mean": float(np.mean(errs)),
            "median": float(np.median(errs)), "max": float(np.max(errs)),
            "solve_s": solve_s, "frames_per_s": cs.BATCH * cs.F_FRAMES / solve_s,
            "stage_times_s": out["stage_times_s"],
            "lane_evals": {k: v["lane_evals"] for k, v in out["eval_stats"].items()},
            "best_hypothesis": out["best_hypothesis"].tolist(),
            "launches": K.launch_counts(),
            "betas_vary_by_frame": bool(any((r["betas"] != r["betas"][:1]).any()
                                            for r in out["results"])),
            "digest": cs.digest(*(r[k] for r in out["results"] for k in keys)),
        }), flush=True)
    batch_solver.upsample_lane_params = upsample
    return 0


if __name__ == "__main__":
    sys.exit(main())
