"""Stage ablations: score the saved per-stage solver outputs (counterpart of
``uuo_mocap_tpu/eval/ablations.py``).

``cli.test`` writes ``*_stageii.<stage>.npz`` beside each result for the
stages {part, root, chamfer, marker, marker_final} that ran; this harness
scores each stage's snapshots with the full metric suite of
``eval.comparisons``, which shows what every stage contributes without
solving again.  Statistics go to ``<dataset>/results/stats/<dataset>/
<method>.<stage>.{yaml,csv}``.

Usage:
    python -m uuo_mocap_tpu_torch.eval.ablations --input_dir ./data \
        --dataset demo --method video_mocap
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from uuo_mocap_tpu_torch.body.model import BodyModel
from uuo_mocap_tpu_torch.eval.comparisons import aggregate, evaluate_sequence, save_stats

STAGES = ["part", "root", "chamfer", "marker", "marker_final"]


def run_stage_ablations(model: BodyModel, input_dir: str, dataset: str, method: str,
                        subjects: Optional[List[str]] = None, stages: List[str] = STAGES,
                        gt_method: str = "smpl") -> Dict[str, Dict]:
    """Score every ``<subject>/<seq>_stageii.<stage>.npz`` of ``method``
    against ``<gt_method>/<subject>/<seq>_stageii.npz`` (markers from
    ``mocap/<subject>/<seq>.c3d`` where it exists).  -> {stage: stats}."""
    base = os.path.join(input_dir, dataset)
    method_dir = os.path.join(base, "results", method)
    gt_dir = os.path.join(base, gt_method)
    mocap_dir = os.path.join(base, "mocap")
    stats_dir = os.path.join(base, "results", "stats", dataset)

    all_stats = {}
    for stage in stages:
        per_seq = {}
        subj_list = subjects or (sorted(os.listdir(method_dir)) if os.path.isdir(method_dir) else [])
        for subject in subj_list:
            sdir = os.path.join(method_dir, subject)
            if not os.path.isdir(sdir):
                continue
            suffix = f"_stageii.{stage}.npz"
            for fname in sorted(os.listdir(sdir)):
                if not fname.endswith(suffix):
                    continue
                seq = fname[: -len(suffix)]
                gt_path = os.path.join(gt_dir, subject, seq + "_stageii.npz")
                if not os.path.exists(gt_path):
                    continue
                c3d = os.path.join(mocap_dir, subject, seq + ".c3d")
                per_seq[f"{subject}/{seq}"] = evaluate_sequence(
                    model, os.path.join(sdir, fname), gt_path, c3d if os.path.exists(c3d) else None)
        if per_seq:
            stats = aggregate(per_seq)
            save_stats(stats, per_seq, stats_dir, f"{method}.{stage}")
            all_stats[stage] = stats
            print(f"[{method}.{stage}] mpjpe {stats['mpjpe']['mean']:.2f} mm over {len(per_seq)} seqs")
    return all_stats


def main(argv=None):
    import argparse

    from uuo_mocap_tpu_torch.cli.test import device_from_args
    from uuo_mocap_tpu_torch.eval.comparisons import default_model_provider

    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--method", required=True)
    parser.add_argument("--subjects", nargs="+", default=None)
    parser.add_argument("--stages", nargs="+", default=STAGES)
    parser.add_argument("--body_models", type=str, default="./body_models")
    parser.add_argument("--cpu_only", action="store_true", help="run on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    args = parser.parse_args(argv)

    model = default_model_provider(args.body_models, device=device_from_args(args))("neutral")
    return run_stage_ablations(model, args.input_dir, args.dataset, args.method, args.subjects,
                               args.stages)


if __name__ == "__main__":
    main()
