"""Evaluation harness: solved sequences against MoSh++-style ground truth
(counterpart of ``uuo_mocap_tpu/eval/comparisons.py``).

For each method: load the predicted SMPL npz (per-method paths below), the
ground-truth npz and the marker c3d; run the SMPL forward of each file's own
gender with the hand joints zeroed; compute m2s / MPJPE / PA-MPJPE / MPJVE /
PA-MPJVE / V2V in mm and their per-part variants; write mean / std /
median per metric to ``<method>.yaml`` and the per-sequence values to
``<method>.csv``.

Method paths:
    moshpp       <dataset>/smpl/<subject>/<seq>_stageii.npz   (the ground truth)
    vposer|humor|vposer_vid|humor_vid
                 <dataset>/comparisons/<method>/<subject>/<seq>_stageii.npz
    hmr          <dataset>/comparisons/4d_humans/<subject>/<seq>.<camera>/
                     results/demo_<seq>.pkl  (4D-Humans pkl -> ImgSmpl.get_smpl)
    hmr_rr       <dataset>/results/hmr/<subject>[/<part>|/synthetic_<s>]/...
    soma         <dataset>/comparisons/soma/smpl/<subject>[...]/...
    video_mocap* <dataset>/results/<method>/<subject>[...]/...

Markers come from the sequence's c3d, else from the npz's embedded
``mocap_markers``; with neither, m2s is NaN and left out of the aggregates.
The SMPL forwards and metrics run on ``device`` (default: the card).

Usage:
    python -m uuo_mocap_tpu_torch.eval.comparisons --input_dir ./data \
        --dataset synthetic_demo --synthetic 0_41 --methods moshpp hmr video_mocap
"""
from __future__ import annotations

import csv
import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward
from uuo_mocap_tpu_torch.eval.metrics import compute_all_metrics, compute_part_metrics
from uuo_mocap_tpu_torch.ops import rotations as rot

POSE_METHODS = ("vposer", "humor", "vposer_vid", "humor_vid")


def load_smpl_npz(path: str) -> Dict:
    """npz {poses, betas, trans, mocap_frame_rate, gender[, mocap_markers]}
    -> {"pose_aa" [F, 24, 3], "betas" [10], "trans", "freq", "gender"
    [, "mocap_markers"]}."""
    data = np.load(path, allow_pickle=True)
    poses = np.asarray(data["poses"], np.float32)
    F = poses.shape[0]
    out = {
        "pose_aa": poses[:, : 24 * 3].reshape(F, 24, 3),
        "betas": np.asarray(data["betas"], np.float32)[:10],
        "trans": np.asarray(data["trans"], np.float32),
        "freq": float(data["mocap_frame_rate"]) if "mocap_frame_rate" in data else 30.0,
        "gender": str(np.asarray(data["gender"]).item()) if "gender" in data else "neutral",
    }
    if "mocap_markers" in data:
        out["mocap_markers"] = np.asarray(data["mocap_markers"], np.float32)
    return out


def default_model_provider(body_models_dir: str = "./body_models",
                           device=None) -> Callable[[str], BodyModel]:
    """Gendered SMPL models on ``device``, loaded once per gender; the
    synthetic test model when ``body_models_dir`` does not exist."""
    cache: Dict[str, BodyModel] = {}

    def provider(gender: str) -> BodyModel:
        gender = gender if gender in ("male", "female", "neutral") else "neutral"
        if gender not in cache:
            if os.path.exists(body_models_dir):
                from uuo_mocap_tpu_torch.body.model import load_body_model

                try:
                    cache[gender] = load_body_model(body_models_dir, gender, device=device)
                except FileNotFoundError:
                    cache[gender] = load_body_model(body_models_dir, "neutral", device=device)
            else:
                from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model

                cache[gender] = synthetic_body_model(device=device, gender=gender)
        return cache[gender]

    return provider


def smpl_forward_zeroed_hands(model: BodyModel, smpl: Dict[str, np.ndarray]):
    """The SMPL forward of ``smpl`` with the hand joints (22, 23) zeroed."""
    aa = smpl["pose_aa"].copy()
    aa[:, 22:24] = 0.0
    mats = rot.axis_angle_to_matrix(torch.as_tensor(aa, device=model.device))
    betas = torch.as_tensor(smpl["betas"], device=model.device)[None]
    with torch.no_grad():
        return lbs_forward(model, mats[:, 1:], betas, mats[:, :1],
                           torch.as_tensor(smpl["trans"], device=model.device))


def evaluate_pair(pred: Dict[str, np.ndarray], gt: Dict[str, np.ndarray],
                  model_provider: Callable[[str], BodyModel], markers: Optional[np.ndarray],
                  strict_markers: bool = False) -> Dict[str, float]:
    """Metrics of one (prediction, ground truth) pair, each side through the
    SMPL of its own gender."""
    F = min(pred["pose_aa"].shape[0], gt["pose_aa"].shape[0])
    for d in (pred, gt):
        d["pose_aa"] = d["pose_aa"][:F]
        d["trans"] = d["trans"][:F]

    model_p = model_provider(pred.get("gender", "neutral"))
    model_g = model_provider(gt.get("gender", "neutral"))
    out_p = smpl_forward_zeroed_hands(model_p, pred)
    out_g = smpl_forward_zeroed_hands(model_g, gt)

    dev = out_p["vertices"].device
    if markers is None:
        if strict_markers:
            raise FileNotFoundError("no marker source (c3d or embedded mocap_markers)")
        markers_t = torch.zeros((F, 1, 3), device=dev)  # its m2s is replaced by NaN
    else:
        markers_t = torch.as_tensor(np.nan_to_num(markers[:F], nan=0.0), dtype=torch.float32,
                                    device=dev)

    metrics = compute_all_metrics(out_p["joints"][:, :24], out_g["joints"][:, :24],
                                  out_p["vertices"], out_g["vertices"], markers_t,
                                  model_p.faces, freq=gt["freq"])
    if markers is None:
        metrics["m2s"] = float("nan")
    parts = compute_part_metrics(out_p["joints"][:, :24], out_g["joints"][:, :24], gt["freq"])
    for part, vals in parts.items():
        for k, v in vals.items():
            metrics[f"{part}__{k}"] = v
    return metrics


def evaluate_sequence(model: BodyModel, pred_npz: str, gt_npz: str,
                      markers_c3d: Optional[str] = None) -> Dict[str, float]:
    """One pair with one model for both sides."""
    pred = load_smpl_npz(pred_npz)
    gt = load_smpl_npz(gt_npz)
    return evaluate_pair(pred, gt, lambda g: model, _load_markers(markers_c3d, pred))


def _load_markers(markers_c3d: Optional[str], pred: Dict) -> Optional[np.ndarray]:
    if markers_c3d is not None and os.path.exists(markers_c3d):
        from uuo_mocap_tpu_torch.data.markers import Markers

        return Markers(markers_c3d).get_points()
    return pred.get("mocap_markers")


def aggregate(per_sequence: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """mean / std / median per metric over the sequences, NaNs left out."""
    if not per_sequence:
        return {}
    out = {}
    for k in next(iter(per_sequence.values())).keys():
        vals = np.asarray([m[k] for m in per_sequence.values()], np.float64)
        vals = vals[np.isfinite(vals)]
        if vals.size:
            out[k] = {"mean": float(vals.mean()), "std": float(vals.std()),
                      "median": float(np.median(vals))}
    return out


def _yaml_float(x: float) -> str:
    """A float as YAML 1.1 reads it back as a float (with a dot before any
    exponent; .nan, .inf)."""
    if math.isnan(x):
        return ".nan"
    if math.isinf(x):
        return ".inf" if x > 0 else "-.inf"
    s = repr(float(x))
    mant, _, exp = s.partition("e")
    if "." not in mant:
        mant += ".0"
    return mant + ("e" + exp if exp else "")


def save_stats(stats: Dict[str, Dict[str, float]], per_sequence: Dict[str, Dict[str, float]],
               out_dir: str, method: str) -> None:
    """``<out_dir>/<method>.yaml`` (metric -> mean / std / median, keys
    sorted, as PyYAML's ``safe_dump`` writes them) and ``<method>.csv``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, method + ".yaml"), "w") as f:
        if not stats:
            f.write("{}\n")
        for metric in sorted(stats):
            f.write(f"{metric}:\n")
            for k in sorted(stats[metric]):
                f.write(f"  {k}: {_yaml_float(stats[metric][k])}\n")
    if per_sequence:
        keys = list(next(iter(per_sequence.values())).keys())
        with open(os.path.join(out_dir, method + ".csv"), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["sequence"] + keys)
            for seq, m in sorted(per_sequence.items()):
                writer.writerow([seq] + [f"{m[k]:.4f}" for k in keys])


def _variant_subdir(part: Optional[str], synthetic: Optional[str]) -> str:
    if part is not None:
        return part
    if synthetic is not None:
        return "synthetic_" + synthetic
    return ""


def resolve_pred(base: str, method: str, subject: str, seq: str, camera: Optional[str],
                 part: Optional[str], synthetic: Optional[str],
                 mocap_freq: float) -> Optional[Dict]:
    """One method's prediction for (subject, seq) by the method's path
    convention (``comparisons.py:204-260``); None when absent."""
    sub = _variant_subdir(part, synthetic)

    def npz_at(root):
        path = (os.path.join(root, subject, sub, seq + "_stageii.npz") if sub
                else os.path.join(root, subject, seq + "_stageii.npz"))
        return load_smpl_npz(path) if os.path.exists(path) else None

    if method == "moshpp":
        # the ground truth: variants never fork the GT directory
        path = os.path.join(base, "smpl", subject, seq + "_stageii.npz")
        return load_smpl_npz(path) if os.path.exists(path) else None
    if method in POSE_METHODS:
        path = os.path.join(base, "comparisons", method, subject, seq + "_stageii.npz")
        return load_smpl_npz(path) if os.path.exists(path) else None
    if method == "hmr":
        video_seq = seq + ("." + camera if camera else "")
        path = os.path.join(base, "comparisons", "4d_humans", subject, video_seq, "results",
                            "demo_" + seq + ".pkl")
        if not os.path.exists(path):
            return None
        from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
        from uuo_mocap_tpu_torch.data.pkl_io import load_pkl

        smpl = ImgSmpl(load_pkl(path), mocap_freq).get_smpl()
        F = smpl["poses"].shape[0]
        return {
            "pose_aa": smpl["poses"][:, : 24 * 3].reshape(F, 24, 3).astype(np.float32),
            "betas": np.asarray(smpl["betas"], np.float32)[:10],
            "trans": np.asarray(smpl["trans"], np.float32),
            "freq": mocap_freq,
            "gender": str(np.asarray(smpl["gender"]).item()),
        }
    if method == "hmr_rr":
        return npz_at(os.path.join(base, "results", "hmr"))
    if method == "soma":
        return npz_at(os.path.join(base, "comparisons", "soma", "smpl"))
    if method.startswith("video_mocap"):
        return npz_at(os.path.join(base, "results", method))
    raise ValueError(f"unknown method {method!r}")


def run_comparisons(model: Optional[BodyModel], input_dir: str, dataset: str, methods: List[str],
                    subjects: Optional[List[str]] = None, camera: Optional[str] = None,
                    part: Optional[str] = None, synthetic: Optional[str] = None,
                    body_models_dir: str = "./body_models", output_root: Optional[str] = None,
                    mocap_freq: float = 30.0, device=None) -> Dict[str, Dict]:
    """Evaluate every requested method.  The sequence list comes from the
    first ``video_mocap*`` method's results directory when one is asked
    for, else from the ground-truth directory; sequences without ground
    truth are skipped.  ``model`` serves the neutral files; the gendered
    ones load through ``default_model_provider`` on ``device`` (default:
    the model's device, else the card).  Writes
    ``results/stats/<dataset>[/<variant>]/``."""
    base = os.path.join(input_dir, dataset)
    gt_dir = os.path.join(base, "smpl")
    sub = _variant_subdir(part, synthetic)
    mocap_sub = ("mocap_parts___" + part if part else
                 ("mocap_synthetic___" + synthetic if synthetic else "mocap"))
    mocap_dir = os.path.join(base, mocap_sub)
    stats_dir = output_root or os.path.join(base, "results", "stats", dataset)
    if sub:
        stats_dir = os.path.join(stats_dir, sub)

    if device is None and model is not None:
        device = model.device
    base_provider = default_model_provider(body_models_dir, device=device)

    def provider(gender: str) -> BodyModel:
        if model is not None and gender in (None, "", "neutral"):
            return model
        return base_provider(gender)

    vm_methods = [m for m in methods if m.startswith("video_mocap")]
    list_dir = os.path.join(base, "results", vm_methods[0]) if vm_methods else gt_dir
    files = []
    subj_list = subjects or (sorted(os.listdir(list_dir)) if os.path.isdir(list_dir) else [])
    for subject in subj_list:
        # variant subdirectories exist under the method results, not the GT
        use_sub = sub if (vm_methods and sub) else ""
        sdir = os.path.join(list_dir, subject, use_sub) if use_sub else os.path.join(list_dir, subject)
        if not os.path.isdir(sdir):
            continue
        for fname in sorted(os.listdir(sdir)):
            if fname.endswith("_stageii.npz") and os.path.exists(os.path.join(gt_dir, subject, fname)):
                files.append((subject, fname[: -len("_stageii.npz")]))

    all_stats = {}
    for method in methods:
        per_seq = {}
        for subject, seq in files:
            pred = resolve_pred(base, method, subject, seq, camera, part, synthetic, mocap_freq)
            if pred is None:
                print(f"skip ({method} missing): {subject}/{seq}")
                continue
            gt = load_smpl_npz(os.path.join(gt_dir, subject, seq + "_stageii.npz"))
            markers = _load_markers(os.path.join(mocap_dir, subject, seq + ".c3d"), pred)
            if markers is None:
                print(f"warn: no markers for {subject}/{seq}; m2s reported as NaN")
            per_seq[f"{subject}/{seq}"] = evaluate_pair(pred, gt, provider, markers)
        stats = aggregate(per_seq)
        save_stats(stats, per_seq, stats_dir, method)
        all_stats[method] = stats
        if stats:
            m2s = stats.get("m2s", {}).get("mean", float("nan"))
            print(f"[{method}] mpjpe mean {stats['mpjpe']['mean']:.2f} mm, "
                  f"m2s mean {m2s:.2f} mm over {len(per_seq)} seqs")
    return all_stats


def main(argv=None):
    import argparse

    from uuo_mocap_tpu_torch.cli.test import DATASET_CAMERAS, device_from_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--methods", nargs="+", required=True,
                        help="moshpp vposer humor vposer_vid humor_vid hmr hmr_rr soma video_mocap*")
    parser.add_argument("--subjects", nargs="+", default=None)
    parser.add_argument("--part", type=str, default=None)
    parser.add_argument("--synthetic", type=str, default=None)
    parser.add_argument("--body_models", type=str, default="./body_models")
    parser.add_argument("--cpu_only", action="store_true", help="run on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    args = parser.parse_args(argv)

    device = device_from_args(args)
    provider = default_model_provider(args.body_models, device=device)
    return run_comparisons(
        provider("neutral"), args.input_dir, args.dataset, args.methods, args.subjects,
        camera=DATASET_CAMERAS.get(args.dataset), part=args.part, synthetic=args.synthetic,
        body_models_dir=args.body_models, device=device)


if __name__ == "__main__":
    main()
