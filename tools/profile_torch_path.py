#!/usr/bin/env python3
"""Where the PyTorch port's solves spend their time on one GPU, and
whether they repeat bit for bit.

    python3 tools/profile_torch_path.py [--out torch_path_profile.json]

Uses chip_smoke.py's sequence (450 frames x 41 markers, V = 6890, the
shipped configs/video_mocap.yaml, 4 yaw hypotheses) and its batch (the main
path: 4 such sequences through ``MultiSequenceSolver`` with chip_smoke.py's
parallel settings), every stage capped at ``TRACE_ITER_CAP`` L-BFGS
iterations:
  1. repeatability: the markers generated twice, and the capped solve run
     twice on one marker tensor, compared bitwise;
  2. the single-sequence solve under torch.profiler, then the batch solve
     (after an untraced one): device time by kernel, the device's busy share
     of the traced wall time, and the number of kernel launches.
Prints a summary and writes the full record as JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# L-BFGS iterations per stage in the capped solves: enough for every stage
# and closure kind to run, short enough to trace
TRACE_ITER_CAP = 20
_OUT_KEYS = ("trans", "root_orient", "pose_body", "betas", "markers_labels")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="torch_path_profile.json", help="JSON record path")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_path: no CUDA device available", file=sys.stderr)
        return 1
    from chip_smoke import bench_parallel_config, digest, gpu_line, make_batch, make_sequence
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.data.config import load_config
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
    from uuo_mocap_tpu_torch.pipeline.multimodal import multimodal_video_mocap

    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    model = synthetic_body_model(device="cuda")
    gt, markers, prior = make_sequence(model)
    cfg = copy.deepcopy(load_config(os.path.join(HERE, "configs", "video_mocap.yaml")))
    for stage in ("part", "chamfer", "marker"):
        cfg["stages"][stage]["num_iters"] = TRACE_ITER_CAP

    def solve(mk):
        torch.cuda.synchronize()
        t0 = time.time()
        out = multimodal_video_mocap(ImgSmpl.from_params(prior), ArrayMarkers(mk.cpu().numpy()),
                                     cfg, model, frame_bucket=None, device="cuda")
        torch.cuda.synchronize()
        return out, time.time() - t0

    # ---- 1. repeatability
    markers_again = make_sequence(model)[1]
    same_markers = bool(torch.equal(markers, markers_again))
    diff_markers = float((markers - markers_again).abs().max())
    a, _ = solve(markers)
    b, _ = solve(markers)
    same_solve = all(np.array_equal(a[k], b[k]) for k in _OUT_KEYS) and \
        a["lbfgs_evals"] == b["lbfgs_evals"]
    print(f"markers generated twice: bitwise equal {same_markers} (max diff {diff_markers:.3g} m)")
    print(f"capped solve twice on one marker tensor: bitwise equal {same_solve}, lane evaluations "
          f"{a['lbfgs_evals']} / {b['lbfgs_evals']}, digests {digest(*(a[k] for k in _OUT_KEYS))} / "
          f"{digest(*(b[k] for k in _OUT_KEYS))}", flush=True)

    def traced(name, run):
        """Run ``run()`` under the profiler and summarize its device time."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out, wall_s = run()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy_us = sum(e.self_device_time_total for e in events)
        launches = sum(e.count for e in events)
        rows = sorted(({"name": e.key, "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
                       for e in events), key=lambda r: -r["device_ms"])
        print(f"traced {name} ({TRACE_ITER_CAP}-iteration cap) {wall_s:.2f} s, stages "
              f"{out['stage_times_s']}, lane evaluations {out['lbfgs_evals']}")
        print(f"device busy {busy_us / 1e6:.3f} s of {wall_s:.3f} s "
              f"({100 * busy_us / 1e6 / wall_s:.1f}%), {launches} kernel launches")
        for r in rows[:25]:
            print(f"  {r['device_ms']:10.2f} ms {r['calls']:8d}  {r['name'][:100]}")
        return {"traced_solve_s": wall_s, "traced_stage_times_s": out["stage_times_s"],
                "traced_lbfgs_evals": out["lbfgs_evals"], "device_busy_s": busy_us / 1e6,
                "kernel_launches": launches, "kernels": rows}

    # ---- 2. traced solves (the solves above warmed the allocator and kernels)
    single = traced("single-sequence solve", lambda: solve(markers))
    _, preps = make_batch(model)
    bcfg = bench_parallel_config()
    for stage in ("part", "chamfer", "marker"):
        bcfg["stages"][stage]["num_iters"] = TRACE_ITER_CAP
    solver = MultiSequenceSolver(model, bcfg, device="cuda")

    def solve_batch():
        torch.cuda.synchronize()
        t0 = time.time()
        out = solver.solve_prepared(preps)
        torch.cuda.synchronize()
        return out, time.time() - t0

    solve_batch()
    batch = traced("batch solve", solve_batch)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": gpu, "iters_cap": TRACE_ITER_CAP, "markers_repeat": same_markers,
                   "markers_max_diff_m": diff_markers, "capped_solve_repeats": same_solve,
                   **single, "batch": batch}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
