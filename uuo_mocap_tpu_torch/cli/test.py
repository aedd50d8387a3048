"""Solve a dataset of c3d files and write SMPL results (counterpart of
``uuo_mocap_tpu/cli/test.py``, with the same flags and layout).

Dataset layout:
    <input_dir>/<dataset>/mocap[ _parts___P | _synthetic___S ]/<subject>/<seq>.c3d
    <input_dir>/<dataset>/videos/<subject>/<seq>[.<camera>].avi
    <input_dir>/<dataset>/comparisons/4d_humans/<subject>/<videoseq>/results/demo_<seq>.pkl
Outputs:
    <input_dir>/<dataset>/results/<config name>/<subject>[/synthetic_S]/<seq>_stageii.npz
    and one ``<seq>_stageii.<stage>.npz`` per stage; a sequence whose output
    exists is skipped.

Sequences solve one at a time (``multimodal_video_mocap``) or, with
``--batch N``, N at a time as lanes of one ``MultiSequenceSolver``.  The
solve runs on the card (``--gpu N`` picks it) unless ``--cpu_only``.

Usage:
    python -m uuo_mocap_tpu_torch.cli.test --config configs/video_mocap.yaml \
        --dataset synthetic_demo --input_dir ./data --synthetic [--batch 4]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

DATASET_CAMERAS = {
    "umpm": "l",
    "cmu_kitchen_pilot": "7151062",
    "cmu_kitchen_pilot_rb": "7151062",
    "moyo_train": None,
    "moyo_val": None,
    "bmlmovi_train": None,
    "bmlmovi_val": None,
}


def device_from_args(args) -> torch.device:
    """``--cpu_only`` -> the CPU, ``--gpu N`` -> ``cuda:N``, else the card;
    raises when a CUDA device is asked for and there is none."""
    from uuo_mocap_tpu_torch.device import resolve_device

    if args.cpu_only:
        return resolve_device("cpu")
    return resolve_device("cuda" if args.gpu is None else f"cuda:{args.gpu}")


def _video_freq(path: str, default: float = 30.0) -> float:
    """The video's frame rate, read with OpenCV where it and the file exist."""
    if not os.path.exists(path):
        return default
    try:
        import cv2
    except ImportError:
        return default
    freq = cv2.VideoCapture(path).get(cv2.CAP_PROP_FPS)
    return float(freq) if freq and freq > 0 else default


def export_stageii(output_filename: str, result: Dict, stage: Optional[str] = None) -> str:
    """Write the ``*_stageii.npz`` schema: poses = axis-angle of (root,
    body) [F, 72], betas [10], trans [F, 3], mocap_frame_rate, mocap_markers
    [F, M, 3], gender.  ``stage`` writes that stage's parameters to
    ``*_stageii.<stage>.npz``."""
    from uuo_mocap_tpu_torch.ops import rotations as rot

    if stage is None:
        root, pose, trans = result["root_orient"], result["pose_body"], result["trans"]
        betas = result["betas"][0]
    else:
        sd = result["stages"][stage]
        root, pose, trans, betas = sd["root_orient"], sd["pose_body"], sd["trans"], sd["betas"]
    poses_mat = np.concatenate([root, pose], axis=1)  # [F, 24, 3, 3]
    poses_aa = rot.matrix_to_axis_angle(torch.as_tensor(poses_mat, dtype=torch.float32)).numpy()
    out = {
        "betas": betas,
        "trans": trans,
        "poses": poses_aa.reshape(poses_aa.shape[0], -1),
        "mocap_frame_rate": result["mocap_frame_rate"],
        "mocap_markers": result["mocap_markers"].get_points(),
        "gender": "neutral",
    }
    fname = output_filename if stage is None else output_filename.replace("_stageii", f"_stageii.{stage}")
    np.savez(fname, **out)
    return fname


def bucket_work_by_shape(work: List[Dict], frame_bucket: int = 64,
                         marker_bucket: int = 8) -> List[Dict]:
    """Stable-sort the work list by (frame bucket, marker bucket) read from
    each c3d's 512-byte header, so a batch groups sequences of like shape;
    unreadable files sort last (they fail with a real error when loaded)."""
    from uuo_mocap_tpu_torch.data.c3d import peek_c3d_shape

    def key(item):
        try:
            F0, M0 = peek_c3d_shape(item["markers_file"])
        except (OSError, ValueError):
            return (1 << 30, 1 << 30)
        return (-(-F0 // frame_bucket), -(-M0 // marker_bucket))

    return sorted(work, key=key)


def run_test(input_dir: str, output_dir: str, dataset: str, camera: Optional[str], config: Dict,
             model, part: Optional[str] = None, synthetic: Optional[str] = None,
             sequences: Optional[List[str]] = None, subjects: Optional[List[str]] = None,
             num_files: Optional[int] = None, print_options: List[str] = (),
             save_iterations: Optional[str] = None, batch: int = 1, device=None) -> int:
    """Solve every sequence of one mocap directory that has a prior pkl and
    no output yet; returns the number solved.  ``model`` lives on
    ``device``."""
    from uuo_mocap_tpu_torch.data.c3d_native import SequencePrefetcher
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import markers_from_c3d_dict
    from uuo_mocap_tpu_torch.data.pkl_io import load_pkl
    from uuo_mocap_tpu_torch.pipeline.segmentation import trim_trailing_zero_frames

    if part:
        mocap_dir = os.path.join(input_dir, dataset, "mocap_parts___" + part)
    elif synthetic:
        mocap_dir = os.path.join(input_dir, dataset, "mocap_synthetic___" + synthetic)
    else:
        mocap_dir = os.path.join(input_dir, dataset, "mocap")
    video_dir = os.path.join(input_dir, dataset, "videos")
    comparisons_dir = os.path.join(input_dir, dataset, "comparisons", "4d_humans")
    if subjects is None:
        subjects = sorted(os.listdir(mocap_dir))

    # the filtered work list first, so that only files to solve are parsed
    work: List[Dict] = []
    for subject in subjects:
        if sequences is None:
            seqs = sorted(os.listdir(os.path.join(mocap_dir, subject)))
        else:
            seqs = [s + ".c3d" for s in sequences]
        for seq in (s for s in seqs if s.endswith(".c3d")):
            seq_name = seq[: -len(".c3d")]
            video_seq_name = seq_name + ("." + camera if camera else "")
            if synthetic:
                out_file = os.path.join(output_dir, subject, "synthetic_" + synthetic,
                                        seq_name + "_stageii")
            else:
                out_file = os.path.join(output_dir, subject, seq_name + "_stageii")
            os.makedirs(os.path.dirname(out_file), exist_ok=True)
            if os.path.exists(out_file + ".npz"):
                print("Skipping", out_file)
                continue
            pkl_file = os.path.join(comparisons_dir, subject, video_seq_name, "results",
                                    "demo_" + seq_name + ".pkl")
            if not os.path.isfile(pkl_file):
                print("Skipping", pkl_file)
                continue
            work.append(dict(subject=subject, seq_name=seq_name, out_file=out_file,
                             markers_file=os.path.join(mocap_dir, subject, seq),
                             video_file=os.path.join(video_dir, subject, video_seq_name + ".avi"),
                             pkl_file=pkl_file))
    if num_files is not None:
        work = work[: num_files + 1]  # as the reference: num_files + 1 solves
    if batch > 1:
        work = bucket_work_by_shape(work, frame_bucket=64, marker_bucket=8)

    def load(item, prefetcher):
        markers = markers_from_c3d_dict(prefetcher.get(item["markers_file"]), item["markers_file"])
        markers.set_points(trim_trailing_zero_frames(
            np.nan_to_num(markers.get_points(), nan=0.0)))
        img_smpl = ImgSmpl(load_pkl(item["pkl_file"]), _video_freq(item["video_file"]))
        return img_smpl, markers

    def export_result(item, result):
        export_stageii(item["out_file"] + ".npz", result)
        for stage in result.get("stages", {}):
            export_stageii(item["out_file"] + ".npz", result, stage)

    file_count = 0
    # upcoming c3d files parse on the prefetcher's threads while the card solves
    with SequencePrefetcher(n_threads=2) as prefetcher:
        for item in work:
            prefetcher.enqueue(item["markers_file"])
        if batch > 1:
            from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
            from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence

            if save_iterations:
                print("[warn] --save_iterations is not supported with --batch > 1 (the "
                      "lane-batched sweep keeps no per-sequence iteration journal); run without "
                      "--batch to record iterations")
            solver = MultiSequenceSolver(model, config, device=device)
            for g0 in range(0, len(work), batch):
                group = work[g0: g0 + batch]
                loaded = [(item, *load(item, prefetcher)) for item in group]
                # one padded shape for the group (frames bucketed by 64)
                raw = [prepare_sequence(ims, mk, offset=0) for _, ims, mk in loaded]
                F_pad = max(p.F for p in raw)
                M_pad = max(p.markers.shape[1] for p in raw)
                preps = [prepare_sequence(ims, mk, offset=0, pad_to_frames=F_pad,
                                          pad_to_markers=M_pad) for _, ims, mk in loaded]
                out = solver.solve_prepared(preps, print_options=print_options, save_stages=True)
                for (item, _, mk), result in zip(loaded, out["results"]):
                    result = dict(result)
                    result["mocap_markers"] = mk
                    export_result(item, result)
                    print(f"Solved {item['subject']}/{item['seq_name']} (batch of {len(group)})")
                    file_count += 1
                print(f"Batch of {len(group)}: {out['solve_time_s']:.1f}s total, "
                      f"{out['lbfgs_evals']} evals, stages {out['stage_times_s']}")
                if num_files is not None and file_count > num_files:
                    break
            return file_count

        from uuo_mocap_tpu_torch.pipeline.journal import IterationJournal
        from uuo_mocap_tpu_torch.pipeline.multimodal import multimodal_video_mocap

        for item in work:
            img_smpl, markers = load(item, prefetcher)
            journal = IterationJournal() if save_iterations else None
            result = multimodal_video_mocap(img_smpl, markers, config, model, offset=0,
                                            print_options=print_options, save_stages=True,
                                            iter_journal=journal, device=device)
            if journal is not None:
                os.makedirs(save_iterations, exist_ok=True)
                journal.save(os.path.join(
                    save_iterations, f"{item['subject']}_{item['seq_name']}_iterations.pkl"))
            export_result(item, result)
            print(f"Solved {item['subject']}/{item['seq_name']} in {result['solve_time_s']:.1f}s, "
                  f"{result['lbfgs_evals']} evals, stages {result['stage_times_s']}")
            file_count += 1
            if num_files is not None and file_count > num_files:
                break
    return file_count


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="uuo_mocap_tpu_torch batch solver")
    parser.add_argument("--config", type=str, required=True, help="configuration file")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--body_models", type=str, default="./body_models",
                        help="SMPL asset dir; synthetic test model if missing")
    parser.add_argument("--cpu_only", action="store_true", help="run on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    parser.add_argument("--num_files", type=int, default=None)
    parser.add_argument("--sequences", nargs="+", type=str, default=None)
    parser.add_argument("--subjects", nargs="+", type=str, default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic_list", nargs="+", default=[])
    parser.add_argument("--parts", action="store_true")
    parser.add_argument("--parts_list", nargs="+", default=[])
    parser.add_argument("--print_options", type=str, nargs="*", default=["loss", "progress"])
    parser.add_argument("--profile", type=str, default=None,
                        help="write a torch.profiler Chrome trace (trace.json) to this dir; "
                             "it holds the port's spans: uuo.solve, uuo.stage.<stage>, "
                             "uuo.part_fit.<phase>, uuo.lbfgs.{init,direction,line_search,"
                             "eval,grad,refill} and uuo.sync (a host wait on the card)")
    parser.add_argument("--save_iterations", type=str, default=None,
                        help="write each sequence's iteration journal pkl to this directory "
                             "(sequential solves only)")
    parser.add_argument("--batch", type=int, default=1,
                        help="solve this many sequences as lanes of one batch solve "
                             "(1 = sequential)")
    args = parser.parse_args(argv)

    from uuo_mocap_tpu_torch.body.model import load_body_model
    from uuo_mocap_tpu_torch.data.config import load_config

    device = device_from_args(args)
    config = load_config(args.config)
    output_dir = os.path.join(args.input_dir, args.dataset, "results", config["name"])
    if os.path.exists(args.body_models):
        model = load_body_model(args.body_models, "neutral", device=device)
    else:
        print(f"[warn] {args.body_models} not found; using the synthetic test body model")
        from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model

        model = synthetic_body_model(device=device)

    common = dict(input_dir=args.input_dir, output_dir=output_dir, dataset=args.dataset,
                  camera=DATASET_CAMERAS.get(args.dataset), config=config, model=model,
                  sequences=args.sequences, subjects=args.subjects, num_files=args.num_files,
                  print_options=args.print_options, save_iterations=args.save_iterations,
                  batch=args.batch, device=device)

    def run_all() -> int:
        base = os.path.join(args.input_dir, args.dataset)
        if args.parts or args.synthetic:
            prefix = "mocap_parts___" if args.parts else "mocap_synthetic___"
            chosen = args.parts_list if args.parts else args.synthetic_list
            variants = [d[len(prefix):] for d in sorted(os.listdir(base)) if d.startswith(prefix)]
            variants = [v for v in variants if not chosen or v in chosen]
            key = "part" if args.parts else "synthetic"
            return sum(run_test(**{key: v}, **common) for v in variants)
        return run_test(**common)

    if not args.profile:
        return run_all()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        n = run_all()
    os.makedirs(args.profile, exist_ok=True)
    path = os.path.join(args.profile, "trace.json")
    prof.export_chrome_trace(path)
    print("profiler trace ->", path)
    return n


if __name__ == "__main__":
    main()
