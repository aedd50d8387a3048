"""Dataset preprocessing: windowing, downsampling, label filtering, export
(counterpart of ``uuo_mocap_tpu/data/preprocess.py``).

Raw capture c3d -> 30 Hz windowed clips written as per-window c3d files,
per-part subsets and ``settings.json`` metadata, with dataset-specific
marker-label filtering.  Host code on numpy: the capture is parsed with the
port's native c3d parser and written with its c3d writer.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from uuo_mocap_tpu_torch.data.c3d import read_c3d, write_c3d

# per-part marker-name prefixes (reference ``preprocess_cmu_kitchen.py:23-29``
# style body-part tables; names follow the CMU/SOMA convention)
BODY_PARTS: Dict[str, List[str]] = {
    "left_arm": ["LSHO", "LUPA", "LELB", "LFRM", "LWR", "LIWR", "LOWR", "LFIN"],
    "right_arm": ["RSHO", "RUPA", "RELB", "RFRM", "RWR", "RIWR", "ROWR", "RFIN"],
    "left_leg": ["LTHI", "LKNE", "LSHN", "LANK", "LHEE", "LTOE", "LMT5"],
    "right_leg": ["RTHI", "RKNE", "RSHN", "RANK", "RHEE", "RTOE", "RMT5"],
    "torso": ["C7", "T10", "CLAV", "STRN", "RBAK", "LBWT", "RBWT", "LFWT", "RFWT"],
    "head": ["LFHD", "RFHD", "LBHD", "RBHD"],
}


def get_downsampled_indices(num_frames: int, src_freq: float, dst_freq: float) -> np.ndarray:
    """Frame indices resampling src -> dst rate (reference
    ``preprocess_utils.py:8-18``)."""
    n_out = int(num_frames * dst_freq / src_freq)
    return np.minimum((np.arange(n_out) * src_freq / dst_freq).astype(np.int64), num_frames - 1)


def shuffle_c3d(points: np.ndarray, rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Destroy marker identity with one global permutation (reference
    ``preprocess_utils.py:21-29``)."""
    rng = rng or np.random.RandomState(0)
    return points[:, rng.permutation(points.shape[1])]


def trim_trailing_zero_channels(points: np.ndarray) -> np.ndarray:
    """Trim trailing all-zero frames (reference
    ``preprocess_cmu_kitchen.py:32-39``)."""
    nonzero = np.abs(points).sum(axis=(1, 2)) != 0
    if not nonzero.any():
        return points
    return points[: np.max(np.where(nonzero)[0]) + 1]


def filter_labels(
    points: np.ndarray,
    labels: Sequence[str],
    subject_prefix: Optional[str] = None,
    remove_substrings: Sequence[str] = (),
    keep_whitelist: Optional[Sequence[str]] = None,
    remove_labels: Sequence[str] = (),
    canonicalize=None,
) -> tuple[np.ndarray, List[str]]:
    """Marker selection by label: subject prefix (multi-subject captures,
    reference ``preprocess_cmu_kitchen.py:81-89``), exact-label removal
    (backpack markers, ``:81-89,116``), substring removal, whitelists (MOYO
    valid-marker sessions, ``preprocess_moyo.py:44-47``), and per-dataset
    label canonicalization (umpm ``fix_label``, ``preprocess_umpm.py:34-38``).
    Canonicalization runs before the removal/whitelist checks so the vendored
    tables (``data/dataset_tables.py``) match."""
    keep = []
    out_labels = []
    for i, raw in enumerate(labels):
        label = raw.strip()
        if subject_prefix is not None:
            if not label.startswith(subject_prefix):
                continue
            label = label[len(subject_prefix):].lstrip(":_")
        if canonicalize is not None:
            label = canonicalize(label)
        if label in remove_labels:
            continue
        if any(s in label for s in remove_substrings):
            continue
        if keep_whitelist is not None and label not in keep_whitelist:
            continue
        keep.append(i)
        out_labels.append(label)
    return points[:, keep], out_labels


def select_part(
    points: np.ndarray, labels: Sequence[str], part: str,
    part_table: Optional[Dict[str, List[str]]] = None,
) -> tuple[np.ndarray, List[str]]:
    """Per-part marker subsets (reference ``preprocess_cmu_kitchen.py:23-29``,
    ``preprocess_umpm_parts.py:26-41``).

    With a vendored dataset table (``data/dataset_tables.py``) membership is
    by EXACT marker name, matching the reference; the generic prefix table
    is the fallback for unknown datasets."""
    if part_table is not None:
        names = set(part_table[part])
        keep = [i for i, l in enumerate(labels) if l.strip() in names]
    else:
        prefixes = BODY_PARTS[part]
        keep = [i for i, l in enumerate(labels) if any(l.strip().startswith(p) for p in prefixes)]
    return points[:, keep], [labels[i] for i in keep]


def window_sequence(
    points: np.ndarray, freq: float, window_seconds: float, pad_last: bool = True
) -> List[np.ndarray]:
    """Split into fixed-duration windows, padding the final one by repetition
    (reference windowing + ``pad``, ``preprocess_cmu_kitchen.py:102-149``)."""
    win = int(round(window_seconds * freq))
    out = []
    for start in range(0, points.shape[0], win):
        chunk = points[start : start + win]
        if chunk.shape[0] < win and pad_last:
            if chunk.shape[0] == 0:
                continue
            pad = np.repeat(chunk[-1:], win - chunk.shape[0], axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        out.append(chunk)
    return out


def preprocess_c3d_file(
    src: str,
    out_dir: str,
    sequence_name: str,
    target_freq: float = 30.0,
    window_seconds: float = 15.0,
    subject_prefix: Optional[str] = None,
    remove_substrings: Sequence[str] = (),
    keep_whitelist: Optional[Sequence[str]] = None,
    parts: Optional[Sequence[str]] = None,
    gender: str = "neutral",
    units_out: str = "m",
    remove_labels: Sequence[str] = (),
    canonicalize=None,
    part_table: Optional[Dict[str, List[str]]] = None,
) -> List[str]:
    """Full preprocessing of one capture: parse -> trim -> label filter ->
    30 Hz downsample -> window -> write per-window c3d (+ per-part subsets)
    + settings.json (reference ``preprocess_c3d_data``,
    ``preprocess_cmu_kitchen.py:54-152``).

    Window files are named ``<sequence>_<start_frame>.c3d`` so MoSh++ GT can
    be sliced to the same windows by filename suffix (reference
    ``preprocess_smplx.py:40-90``).
    """
    data = read_c3d(src)
    scale = {"m": 1.0, "cm": 100.0, "mm": 1000.0}.get(data.get("units", "mm"), 1.0)
    points = data["points"][:, :, :3] / scale
    labels = data.get("labels", [f"M{i}" for i in range(points.shape[1])])
    freq = data["rate"]

    points = trim_trailing_zero_channels(points)
    points, labels = filter_labels(
        points, labels, subject_prefix, remove_substrings, keep_whitelist,
        remove_labels=remove_labels, canonicalize=canonicalize,
    )

    idx = get_downsampled_indices(points.shape[0], freq, target_freq)
    points = points[idx]

    written = []
    variants = [("mocap", points, labels)]
    for part in parts or []:
        p_pts, p_labels = select_part(points, labels, part, part_table)
        variants.append((f"mocap_parts___{part}", p_pts, p_labels))

    for dirname, pts, labs in variants:
        if pts.shape[1] == 0:
            continue
        windows = window_sequence(pts, target_freq, window_seconds)
        d = os.path.join(out_dir, dirname)
        os.makedirs(d, exist_ok=True)
        for wi, wpts in enumerate(windows):
            start_frame = wi * int(round(window_seconds * target_freq))
            fname = os.path.join(d, f"{sequence_name}_{start_frame:08d}.c3d")
            write_c3d(fname, wpts, rate=target_freq, units=units_out, labels=labs)
            written.append(fname)

    with open(os.path.join(out_dir, "settings.json"), "w") as f:
        json.dump({"gender": gender}, f)
    return written


def slice_gt_to_windows(
    gt_npz: str, out_dir: str, sequence_name: str,
    window_seconds: float = 15.0, freq: float = 30.0,
) -> List[str]:
    """Slice a full-sequence MoSh++ GT npz into the same windows as the c3d
    files, matched by start-frame filename suffix (reference
    ``preprocess_smplx.py:40-90``)."""
    data = dict(np.load(gt_npz, allow_pickle=True))
    F = data["poses"].shape[0]
    win = int(round(window_seconds * freq))
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for start in range(0, F, win):
        end = min(start + win, F)
        out = dict(data)
        out["poses"] = data["poses"][start:end]
        out["trans"] = data["trans"][start:end]
        fname = os.path.join(out_dir, f"{sequence_name}_{start:08d}_stageii.npz")
        np.savez(fname, **out)
        written.append(fname)
    return written
