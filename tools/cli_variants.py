#!/usr/bin/env python3
"""Solve chip_smoke.py's CLI-phase dataset under input variants, on the card.

    python3 tools/cli_variants.py [--seeds 0 1 2 3] [--frames 450]

Exports the synthetic dataset the CLI phase solves (``export_synthetic_c3d``,
41 random-vertex markers, the perturbed prior pkl) into a temporary
directory, loads each sequence as ``cli.test`` loads it, and solves the
batch with ``MultiSequenceSolver`` (chip_smoke's parallel settings) two
ways:
  * ``cli``: as ``cli.test --batch`` prepares it, the frames padded to the
    64-frame bucket (450 -> 512; the padded frames carry no markers);
  * ``no_bucket``: the same without the frame bucket.
Prints, per variant and sequence, the MPJPE (mm, 22 joints) of the final
output and of each stage, the winning hypothesis, the hypothesis scores,
the part fit's chain and the rigid groups found, and per variant the stage times and L-BFGS
evaluations per stage.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--frames", type=int, default=450)
    args = parser.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.cli import export_synthetic_c3d
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import Markers
    from uuo_mocap_tpu_torch.data.markers_synthetic import MarkersSynthetic
    from uuo_mocap_tpu_torch.data.pkl_io import load_pkl
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
    from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence
    from uuo_mocap_tpu_torch.pipeline.segmentation import segment_rigid

    if not torch.cuda.is_available():
        print("cli_variants: no CUDA device available", file=sys.stderr)
        return 1
    print(f"gpu: {cs.gpu_line()}", flush=True)
    model = synthetic_body_model(device="cuda")
    seqs = []
    with tempfile.TemporaryDirectory(prefix="cli_variants_") as d:
        for seed in args.seeds:  # one dataset per seed, so each sequence keeps its seed
            ds = f"s{seed}"
            export_synthetic_c3d.main(["--input_dir", d, "--dataset", ds, "--sequences", "seq",
                                       "--num_frames", str(args.frames), "--seed", str(seed)])
            base = os.path.join(d, ds)
            markers = Markers(os.path.join(base, f"mocap_synthetic___{seed}_41", "s1", "seq.c3d"))
            img = ImgSmpl(load_pkl(os.path.join(base, "comparisons", "4d_humans", "s1", "seq",
                                                "results", "demo_seq.pkl")), 30.0)
            gt = MarkersSynthetic(model, num_frames=args.frames, num_markers=41, seed=seed).gt_params
            seqs.append((markers, img, gt))

    F = max(len(m) for m, _, _ in seqs)
    variants = {
        "cli": [prepare_sequence(img, m, offset=0, pad_to_frames=-(-F // 64) * 64)
                for m, img, _ in seqs],
        "no_bucket": [prepare_sequence(img, m, offset=0, frame_bucket=None) for m, img, _ in seqs],
    }
    for name, preps in variants.items():
        solver = MultiSequenceSolver(model, cs.bench_parallel_config(), device="cuda")
        t0 = time.time()
        out = solver.solve_prepared(preps, save_stages=True)
        torch.cuda.synchronize()
        solve_s = time.time() - t0
        rows = []
        for q, (r, (_, _, gt)) in enumerate(zip(out["results"], seqs)):
            stages = {k: round(cs.mpjpe_mm(model, {**v, "betas": np.broadcast_to(
                v["betas"], (len(v["trans"]), 10))}, gt), 3) for k, v in r["stages"].items()}
            rows.append({"seed": args.seeds[q], "mpjpe_mm": round(cs.mpjpe_mm(model, r, gt), 3),
                         "stages_mm": stages, "best_hypothesis": r["best_hypothesis"],
                         "scores": np.round(np.asarray(out["scores"][q], np.float64), 6).tolist(),
                         "chain": [int(c) for c in r.get("chain", [])],
                         "rigid_groups": len(segment_rigid(preps[q].markers[: preps[q].F_real]))})
        print(json.dumps({"variant": name, "frames": preps[0].F, "solve_s": round(solve_s, 2),
                          "stage_times_s": out["stage_times_s"], "eval_stats": out["eval_stats"],
                          "sequences": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
