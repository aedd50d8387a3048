"""Per-dataset preprocessing CLI (counterpart of
``uuo_mocap_tpu/cli/preprocess_datasets.py``, with the same flags and
output layout).

Thin entry points over ``data/preprocess.py``:

  * cmu_kitchen: 15 s windows, subject label prefixes, optional
    backpack-marker removal (the dataset name gains the ``_rb`` suffix),
    per-part exports;
  * umpm / umpm_parts: 15 s windows, multi-subject label prefixes, UMPM's
    label fixes, per-part subsets;
  * moyo: 3 s windows, per-session valid-marker whitelists;
  * bmlmovi: .mat-converted c3d (``convert_bmlmovi_mat``, scipy.io), 15 s
    windows.

Videos beside the captures are windowed with OpenCV when it is installed;
without cv2 the video step is skipped with a notice (a host-only optional
dependency; nothing here runs on the card).

Usage:
    python -m uuo_mocap_tpu_torch.cli.preprocess_datasets cmu_kitchen \
        --input <raw_dir> --output <data_dir> [--remove_backpack] [--parts ...]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from uuo_mocap_tpu_torch.data.dataset_tables import (
    CMU_KITCHEN_BACKPACK_LABELS,
    DATASET_PART_TABLES,
    MOYO_VALID_MARKERS,
    umpm_fix_label,
)
from uuo_mocap_tpu_torch.data.preprocess import preprocess_c3d_file

DATASET_DEFAULTS = {
    "cmu_kitchen": {"window_seconds": 15.0, "remove": (), "freq": 30.0},
    "umpm": {"window_seconds": 15.0, "remove": (), "freq": 30.0},
    "umpm_parts": {"window_seconds": 15.0, "remove": (), "freq": 30.0},
    "moyo": {"window_seconds": 3.0, "remove": (), "freq": 30.0},
    "bmlmovi": {"window_seconds": 15.0, "remove": (), "freq": 30.0},
}


def preprocess_videos(video_path: str, out_dir: str, sequence_name: str,
                      window_seconds: float, target_freq: float) -> List[str]:
    """Window + downsample a source video alongside the mocap windows
    (reference ``preprocess_utils.py:59-120``)."""
    try:
        import cv2
    except ImportError:
        print("[notice] OpenCV not installed; skipping video windowing")
        return []

    cap = cv2.VideoCapture(video_path)
    src_freq = cap.get(cv2.CAP_PROP_FPS) or target_freq
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    os.makedirs(out_dir, exist_ok=True)

    frames_per_window = int(window_seconds * target_freq)
    stride = max(int(round(src_freq / target_freq)), 1)
    fourcc = cv2.VideoWriter_fourcc(*"MJPG")

    written = []
    writer = None
    out_count = 0
    src_idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if src_idx % stride == 0:
            if out_count % frames_per_window == 0:
                if writer is not None:
                    writer.release()
                start = out_count
                path = os.path.join(out_dir, f"{sequence_name}_{start:08d}.avi")
                writer = cv2.VideoWriter(path, fourcc, target_freq, (w, h))
                written.append(path)
            writer.write(frame)
            out_count += 1
        src_idx += 1
    if writer is not None:
        writer.release()
    cap.release()
    return written


def run_dataset(
    kind: str,
    input_dir: str,
    output_dir: str,
    dataset_name: Optional[str] = None,
    subjects: Optional[List[str]] = None,
    parts: Optional[List[str]] = None,
    remove_backpack: bool = False,
    whitelist_file: Optional[str] = None,
    window_seconds: Optional[float] = None,
) -> int:
    defaults = DATASET_DEFAULTS[kind]
    window = window_seconds or defaults["window_seconds"]
    # vendored dataset tables (data/dataset_tables.py): exact backpack labels
    # for CMU, label canonicalization for UMPM, session whitelists for MOYO,
    # per-dataset part-name tables
    remove_labels = tuple(CMU_KITCHEN_BACKPACK_LABELS) if (
        remove_backpack and kind == "cmu_kitchen") else ()
    remove = ("BACKPACK",) if (remove_backpack and kind != "cmu_kitchen") else ()
    canonicalize = umpm_fix_label if kind.startswith("umpm") else None
    part_table = DATASET_PART_TABLES.get(kind)
    if dataset_name is None:
        dataset_name = {"cmu_kitchen": "cmu_kitchen_pilot", "umpm_parts": "umpm"}.get(kind, kind)
        if remove_backpack:
            dataset_name += "_rb"  # reference ``preprocess_cmu_kitchen.py:171-174``

    # vendored MOYO session keys match by substring of the subject/sequence
    # (reference preprocess_moyo.py:44-47); user-supplied whitelist files
    # keep EXACT sequence-name lookup: a short user key must not silently
    # filter an unrelated sequence it happens to be a substring of
    session_whitelists = dict(MOYO_VALID_MARKERS) if kind == "moyo" else {}
    exact_whitelists = {}
    if whitelist_file:
        with open(whitelist_file) as f:
            exact_whitelists = json.load(f)  # {sequence_name: [marker names]}

    def whitelist_for(subject: str, seq: str):
        if seq in exact_whitelists:
            return exact_whitelists[seq]
        for key, names in session_whitelists.items():
            if key in subject or key in seq:
                return names
        return None

    count = 0
    subjects = subjects or sorted(
        d for d in os.listdir(input_dir) if os.path.isdir(os.path.join(input_dir, d))
    )
    for subject in subjects:
        sdir = os.path.join(input_dir, subject)
        for fname in sorted(os.listdir(sdir)):
            if not fname.endswith(".c3d"):
                continue
            seq = fname[:-4]
            out_base = os.path.join(output_dir, dataset_name)
            if parts is None and part_table is not None and kind.endswith("_parts"):
                parts = list(part_table)
            written = preprocess_c3d_file(
                os.path.join(sdir, fname),
                os.path.join(out_base),
                sequence_name=seq,
                target_freq=defaults["freq"],
                window_seconds=window,
                subject_prefix=subject if kind in ("cmu_kitchen", "umpm", "umpm_parts") else None,
                remove_substrings=remove,
                keep_whitelist=whitelist_for(subject, seq),
                parts=parts,
                remove_labels=remove_labels,
                canonicalize=canonicalize,
                part_table=part_table,
            )
            # move per-subject: preprocess writes under out_base/<dirname>/; relocate into subject dirs
            for path in written:
                rel_dir = os.path.basename(os.path.dirname(path))
                subj_dir = os.path.join(out_base, rel_dir, subject)
                os.makedirs(subj_dir, exist_ok=True)
                os.replace(path, os.path.join(subj_dir, os.path.basename(path)))
            count += len(written)

            video_src = os.path.join(sdir, seq + ".avi")
            if os.path.exists(video_src):
                preprocess_videos(
                    video_src, os.path.join(out_base, "videos", subject), seq, window, defaults["freq"]
                )
    print(f"[{dataset_name}] wrote {count} windowed c3d files")
    return count


def convert_bmlmovi_mat(mat_path: str, out_c3d: str, rate: float = 120.0) -> str:
    """BMLmovi .mat mocap -> c3d (reference ``preprocess_bmlmovi.py:50-60``):
    finds the 3D marker array inside the Matlab struct (``move`` /
    ``markerLocation`` layouts) and writes our c3d."""
    from scipy.io import loadmat

    from uuo_mocap_tpu_torch.data.c3d import write_c3d

    data = loadmat(mat_path, squeeze_me=True, struct_as_record=False)

    def find_markers(obj, depth=0):
        if depth > 6 or obj is None:
            return None
        arr = np.asarray(obj) if not hasattr(obj, "_fieldnames") else None
        if arr is not None and arr.ndim == 3 and 3 in arr.shape:
            return arr
        if hasattr(obj, "_fieldnames"):
            for name in obj._fieldnames:
                found = find_markers(getattr(obj, name), depth + 1)
                if found is not None:
                    return found
        return None

    markers = None
    for key, value in data.items():
        if key.startswith("__"):
            continue
        markers = find_markers(value)
        if markers is not None:
            break
    if markers is None:
        raise ValueError(f"no [F, M, 3] marker array found in {mat_path}")
    # normalize axis order to [F, M, 3]
    if markers.shape[0] == 3:
        markers = np.moveaxis(markers, 0, -1)
    if markers.shape[1] == 3 and markers.shape[2] != 3:
        markers = np.swapaxes(markers, 1, 2)
    return write_c3d(out_c3d, np.asarray(markers, np.float32), rate=rate, units="mm")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("kind", choices=list(DATASET_DEFAULTS))
    parser.add_argument("--input", required=True, help="raw dataset dir: <subject>/<seq>.c3d")
    parser.add_argument("--output", required=True)
    parser.add_argument("--dataset_name", type=str, default=None)
    parser.add_argument("--subjects", nargs="+", default=None)
    parser.add_argument("--parts", nargs="+", default=None,
                        help="part names from the dataset's vendored table "
                             "(data/dataset_tables.py) or the generic table")
    parser.add_argument("--remove_backpack", action="store_true")
    parser.add_argument("--whitelists", type=str, default=None, help="json: sequence -> valid markers")
    parser.add_argument("--window_seconds", type=float, default=None)
    args = parser.parse_args(argv)

    run_dataset(
        args.kind, args.input, args.output, args.dataset_name, args.subjects,
        args.parts, args.remove_backpack, args.whitelists, args.window_seconds,
    )


if __name__ == "__main__":
    main()
