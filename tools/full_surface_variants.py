#!/usr/bin/env python3
"""Solve chip_smoke.py's random batch (4 x 450 x 41) on the GPU under the
shipped batch config and under variants of chip_smoke's ``FULL_SURFACE``
overrides, to attribute the full-surface configuration's accuracy to its
parts: per variant the solve time, stage times, evaluations and the
per-sequence MPJPE (mm) against the generating ground truth, of the output
and of each stage's snapshot; and the prior's MPJPE.

    python3 tools/full_surface_variants.py [--variants full_surface no_ground ...]
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

import chip_smoke as C  # noqa: E402

FS = C.FULL_SURFACE["stages"]
VARIANTS = {
    "shipped": {},
    "full_surface": C.FULL_SURFACE,
    # FULL_SURFACE without the terms that assume a z = 0 ground plane
    "no_ground": {"stages": {
        "root": dict(FS["root"], losses={k: v for k, v in FS["root"]["losses"].items()
                                         if k != "ground"}),
        "part": {"losses": {"velocity": 1.0}},
        "compute_locations": FS["compute_locations"], "segment": FS["segment"]}},
    "root_only": {"stages": {"root": FS["root"]}},
    "root_no_ground": {"stages": {"root": dict(FS["root"], losses={
        k: v for k, v in FS["root"]["losses"].items() if k != "ground"})}},
    "part_losses_only": {"stages": {"part": FS["part"]}},
    "barycentric_part_only": {"stages": {"compute_locations": FS["compute_locations"],
                                         "segment": FS["segment"]}},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = ap.parse_args()
    import torch

    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print("gpu:", C.gpu_line(), flush=True)
    model = synthetic_body_model(device="cuda")
    gts, preps = C.make_batch(model)
    prior = []
    for gt, p in zip(gts, preps):
        out = {"pose_body": p.o_pose_body, "betas": p.o_betas.repeat(p.F, 0),
               "root_orient": p.o_root_orient, "trans": p.o_trans}
        prior.append(round(C.mpjpe_mm(model, out, gt), 3))
    print(f"prior MPJPE per sequence (mm): {prior}", flush=True)
    for name in args.variants:
        cfg = C.merge_config(C.bench_parallel_config(), copy.deepcopy(VARIANTS[name]))
        solver = MultiSequenceSolver(model, cfg, device="cuda")
        t0 = time.time()
        out = solver.solve_prepared(preps, save_stages=True)
        torch.cuda.synchronize()
        solve_s = round(time.time() - t0, 2)
        errs = [round(C.mpjpe_mm(model, r, gt), 3) for r, gt in zip(out["results"], gts)]
        per_stage = {}
        for r, gt in zip(out["results"], gts):
            for stage, sd in r["stages"].items():
                sd = dict(sd, betas=sd["betas"][None].repeat(sd["trans"].shape[0], 0))
                per_stage.setdefault(stage, []).append(round(C.mpjpe_mm(model, sd, gt), 3))
        print(json.dumps({"variant": name, "solve_s": solve_s, "mpjpe_mm": errs,
                          "stage_mpjpe_mm": per_stage, "stage_times_s": out["stage_times_s"],
                          "lbfgs_evals": out["lbfgs_evals"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
