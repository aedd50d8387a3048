"""Qualitative comparison renders: every method's output side by side
(counterpart of ``uuo_mocap_tpu/eval/qualitative.py``).

For each sequence, each method's solved body (and the marker cloud) is
rendered to ``results/qual/<method>/<subject>[/<part>|/synthetic_<s>]/
<seq>.<ext>``.  Methods resolve through the metrics harness's loaders
(``eval/comparisons.py:resolve_pred``): moshpp, vposer/humor(_vid), hmr,
hmr_rr, soma, video_mocap*, with the --part / --synthetic variants and the
SMPL of each file's gender.

The work is split in two halves: ``posed_vertices`` is the device half (the
LBS forward of a resolved prediction, on the model's device: the card unless
``--cpu_only``), ``render_vertices`` the host half (matplotlib, which the
host must have; the card's machine need not).

Usage:
    python -m uuo_mocap_tpu_torch.eval.qualitative --input_dir ./data \
        --dataset synthetic_demo --methods moshpp video_mocap [--cpu_only]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward
from uuo_mocap_tpu_torch.ops import rotations as rot


def posed_vertices(pred: Dict, model: BodyModel, max_frames: Optional[int] = None) -> torch.Tensor:
    """The posed SMPL vertices [F, V, 3] of a resolved prediction dict
    (comparisons schema), on the model's device; ``max_frames`` caps F."""
    F = pred["trans"].shape[0]
    if max_frames:
        F = min(F, max_frames)
    dev = model.device
    mats = rot.axis_angle_to_matrix(torch.as_tensor(pred["pose_aa"][:F], device=dev))
    betas = torch.as_tensor(pred["betas"], device=dev)[None].expand(F, 10)
    with torch.no_grad():
        out = lbs_forward(model, mats[:, 1:], betas, mats[:, :1],
                          torch.as_tensor(pred["trans"][:F], device=dev))
    return out["vertices"]


def render_vertices(verts: np.ndarray, faces: np.ndarray, out_path: str,
                    markers: Optional[np.ndarray] = None, angle: float = 0.0,
                    fps: float = 30.0) -> str:
    """Render host vertices [F, V, 3] (and markers [F', M, 3]) to a video;
    needs matplotlib."""
    from uuo_mocap_tpu_torch.vis.renderer import VideoMocapRenderer
    from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene

    scene = VideoMocapScene()

    def render_frame(s, f):
        s.add_mesh(verts[f], faces)
        if markers is not None:
            s.add_markers(markers[min(f, markers.shape[0] - 1)])

    return VideoMocapRenderer(
        scene, render_frame, verts.shape[0], out_path, video_fps=fps, azim=-60.0 + angle,
    ).run()


def render_pred(
    pred: dict,
    model: BodyModel,
    out_path: str,
    markers: Optional[np.ndarray] = None,
    angle: float = 0.0,
    max_frames: Optional[int] = None,
    fps: float = 30.0,
) -> str:
    """Render a resolved prediction dict (comparisons schema) to a video:
    ``posed_vertices`` on the model's device, then ``render_vertices``."""
    verts = posed_vertices(pred, model, max_frames).cpu().numpy()
    return render_vertices(verts, model.faces, out_path, markers, angle, fps)


def qualitative_items(
    input_dir: str,
    dataset: str,
    methods: List[str],
    subjects: Optional[List[str]] = None,
    sequences: Optional[List[str]] = None,
    part: Optional[str] = None,
    synthetic: Optional[str] = None,
    camera: Optional[str] = None,
    out_root: Optional[str] = None,
) -> Iterator[Tuple[str, str, str, Dict, Optional[np.ndarray], str]]:
    """(method, subject, seq, pred, markers, out_dir) for every method and
    sequence to render.  The sequence list is the metrics harness's: the
    first ``video_mocap*`` method's results, else the ground truth, keeping
    sequences that have ground truth; a method without the sequence is
    skipped with a notice."""
    from uuo_mocap_tpu_torch.eval.comparisons import _load_markers, _variant_subdir, resolve_pred

    base = os.path.join(input_dir, dataset)
    gt_dir = os.path.join(base, "smpl")
    sub = _variant_subdir(part, synthetic)
    mocap_sub = (
        "mocap_parts___" + part if part else
        ("mocap_synthetic___" + synthetic if synthetic else "mocap")
    )
    mocap_dir = os.path.join(base, mocap_sub)
    out_root = out_root or os.path.join(base, "results", "qual")

    vm_methods = [m for m in methods if m.startswith("video_mocap")]
    list_dir = os.path.join(base, "results", vm_methods[0]) if vm_methods else gt_dir
    files = []
    subj_list = subjects or (sorted(os.listdir(list_dir)) if os.path.isdir(list_dir) else [])
    for subject in subj_list:
        use_sub = sub if (vm_methods and sub) else ""
        sdir = os.path.join(list_dir, subject, use_sub) if use_sub else os.path.join(list_dir, subject)
        if not os.path.isdir(sdir):
            continue
        for fname in sorted(os.listdir(sdir)):
            if not fname.endswith("_stageii.npz"):
                continue
            seq = fname[: -len("_stageii.npz")]
            if sequences is not None and seq not in sequences:
                continue
            if os.path.exists(os.path.join(gt_dir, subject, fname)):
                files.append((subject, seq))

    for method in methods:
        for subject, seq in files:
            pred = resolve_pred(base, method, subject, seq, camera, part, synthetic, 30.0)
            if pred is None:
                print(f"skip ({method} missing): {subject}/{seq}")
                continue
            markers = _load_markers(os.path.join(mocap_dir, subject, seq + ".c3d"), pred)
            out_dir = os.path.join(out_root, method, subject, sub) if sub else \
                os.path.join(out_root, method, subject)
            yield method, subject, seq, pred, markers, out_dir


def run_qualitative(
    model: Optional[BodyModel],
    input_dir: str,
    dataset: str,
    methods: List[str],
    subjects: Optional[List[str]] = None,
    sequences: Optional[List[str]] = None,
    fmt: str = "gif",
    part: Optional[str] = None,
    synthetic: Optional[str] = None,
    angle: float = 0.0,
    max_frames: Optional[int] = 90,
    camera: Optional[str] = None,
    out_root: Optional[str] = None,
    body_models_dir: str = "./body_models",
    device=None,
) -> List[str]:
    """Render every (method, sequence) of ``qualitative_items``.  ``model``
    serves the neutral files; the gendered ones load on ``device`` (default:
    the model's device, else the card).  -> the written paths."""
    from uuo_mocap_tpu_torch.eval.comparisons import default_model_provider

    if device is None and model is not None:
        device = model.device
    base_provider = default_model_provider(body_models_dir, device=device)

    def provider(gender):
        if model is not None and gender in (None, "", "neutral"):
            return model
        return base_provider(gender)

    written = []
    for method, subject, seq, pred, markers, out_dir in qualitative_items(
            input_dir, dataset, methods, subjects, sequences, part, synthetic, camera, out_root):
        os.makedirs(out_dir, exist_ok=True)
        out = render_pred(
            pred, provider(pred.get("gender", "neutral")),
            os.path.join(out_dir, f"{seq}.{fmt}"),
            markers=markers, angle=angle, max_frames=max_frames,
        )
        written.append(out)
        print("wrote", out)
    return written


def main(argv=None):
    from uuo_mocap_tpu_torch.cli.test import DATASET_CAMERAS, device_from_args
    from uuo_mocap_tpu_torch.eval.comparisons import default_model_provider

    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--methods", nargs="+", required=True,
                        help="moshpp vposer humor vposer_vid humor_vid hmr hmr_rr soma video_mocap*")
    parser.add_argument("--subjects", nargs="+", default=None)
    parser.add_argument("--sequences", nargs="+", default=None)
    parser.add_argument("--part", type=str, default=None)
    parser.add_argument("--synthetic", type=str, default=None)
    parser.add_argument("--angle", type=float, default=0.0)
    parser.add_argument("--extension", type=str, default="gif")
    parser.add_argument("--max_frames", type=int, default=90)
    parser.add_argument("--body_models", type=str, default="./body_models")
    parser.add_argument("--cpu_only", action="store_true", help="run on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    args = parser.parse_args(argv)

    device = device_from_args(args)
    model = default_model_provider(args.body_models, device=device)("neutral")
    return run_qualitative(
        model, args.input_dir, args.dataset, args.methods, args.subjects,
        args.sequences, args.extension.lstrip("."), args.part, args.synthetic,
        args.angle, args.max_frames, camera=DATASET_CAMERAS.get(args.dataset),
        body_models_dir=args.body_models, device=device,
    )


if __name__ == "__main__":
    main()
