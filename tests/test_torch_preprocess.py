"""The port's dataset preprocessing against the JAX package's, on the CPU, on
the same raw captures made from a seed with numpy.

Both packages preprocess the same raw tree into their own output
directories; the expected result is the same relative paths, byte-identical
``.c3d`` window files and ``settings.json``, the same npz arrays and the
same videos.  Sizes: captures of 5-8 s at 120 Hz with 9-13 markers, windows
of 1-3 s at 30 Hz, an 8-frame 32 x 32 video.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import json

import numpy as np
import pytest
import scipy.io

from uuo_mocap_tpu.cli import preprocess_datasets as jcli
from uuo_mocap_tpu.data import dataset_tables as jtables
from uuo_mocap_tpu.data import preprocess as jpre
from uuo_mocap_tpu_torch.cli import preprocess_datasets as tcli
from uuo_mocap_tpu_torch.data import dataset_tables as ttables
from uuo_mocap_tpu_torch.data import preprocess as tpre
from uuo_mocap_tpu_torch.data.c3d import read_c3d, write_c3d


def _capture(path, labels, seconds, rng, rate=120.0, zero_frac=0.05, trailing_zeros=0):
    """A raw capture in mm: a random walk per marker, ``zero_frac`` of the
    (frame, marker) cells zero-filled, ``trailing_zeros`` all-zero frames."""
    F = int(seconds * rate)
    pts = (np.cumsum(rng.randn(F, len(labels), 3), axis=0) * 2.0 + rng.randn(1, len(labels), 3) * 500)
    pts[rng.rand(F, len(labels)) < zero_frac] = 0.0
    if trailing_zeros:
        pts = np.concatenate([pts, np.zeros((trailing_zeros, len(labels), 3))])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_c3d(path, pts.astype(np.float32), rate=rate, units="mm", labels=labels)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _same_tree(ours, ref):
    a, b = _tree(ours), _tree(ref)
    assert sorted(a) == sorted(b)
    for rel in b:
        assert a[rel] == b[rel], rel
    return a


def _cmu_raw(root, rng):
    for subject, seqs in (("S01", ("brownie", "salad")), ("S02", ("eggs",))):
        labels = ([f"{subject}:{l}" for l in jtables.CMU_KITCHEN_BACKPACK_LABELS]
                  + [f"{subject}:{l}" for l in ("RWRA", "RELB", "LKNE", "LANK", "LSHO", "C7")]
                  + ["OTHER:RWRA", "OTHER:C7"])
        for i, seq in enumerate(seqs):
            _capture(os.path.join(root, subject, seq + ".c3d"), labels, 5 + i, rng,
                     trailing_zeros=7 * i)


def _umpm_raw(root, rng):
    labels = ["p1:lknssbk", "p1:lwrext", "p1:lelbtop", "p1:rshld", "p1:bneck", "p1:fhead",
              "p1:rankfr", "p1:BACKPACK_1", "p2:lwrext"]
    _capture(os.path.join(root, "p1", "p1_grab_3.c3d"), labels, 6, rng)


def _moyo_raw(root, rng):
    session = jtables.MOYO_VALID_MARKERS["20221004_with_com"]
    labels = session[:8] + ["BROKEN1", "LIEL", "EXTRA"]
    _capture(os.path.join(root, "20221004_with_com", "pose_a.c3d"), labels, 8, rng)
    # a user whitelist file names this sequence exactly
    _capture(os.path.join(root, "user_session", "pose_b.c3d"), labels, 7, rng)
    _capture(os.path.join(root, "user_session", "pose_b_long.c3d"), labels, 5, rng)


CASES = {
    "cmu_kitchen": (_cmu_raw, dict(remove_backpack=True, window_seconds=2.0,
                                   parts=list(jtables.CMU_KITCHEN_BODY_PARTS))),
    "umpm_parts": (_umpm_raw, dict(window_seconds=3.0)),
    "moyo": (_moyo_raw, dict(subjects=["20221004_with_com", "user_session"], whitelist=True)),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_run_dataset_same_files(tmp_path, kind):
    make_raw, kw = CASES[kind]
    raw = str(tmp_path / "raw")
    make_raw(raw, np.random.RandomState(len(kind)))
    kw = dict(kw)
    if kw.pop("whitelist", False):
        wl = str(tmp_path / "whitelist.json")
        with open(wl, "w") as f:
            json.dump({"pose_b": ["CLAV", "LANK", "LIEL", "EXTRA"]}, f)
        kw["whitelist_file"] = wl
    n_ref = jcli.run_dataset(kind, raw, str(tmp_path / "ref"), **kw)
    n_ours = tcli.run_dataset(kind, raw, str(tmp_path / "ours"), **kw)
    assert n_ours == n_ref > 0
    files = _same_tree(str(tmp_path / "ours"), str(tmp_path / "ref"))
    if kind == "cmu_kitchen":
        assert "cmu_kitchen_pilot_rb/mocap/S01/brownie_00000000.c3d" in files
        labels = read_c3d(str(tmp_path / "ours" / "cmu_kitchen_pilot_rb" / "mocap" / "S02"
                              / "eggs_00000060.c3d"))["labels"]
        assert labels == ["RWRA", "RELB", "LKNE", "LANK", "LSHO", "C7"]
    if kind == "umpm_parts":
        labels = read_c3d(str(tmp_path / "ours" / "umpm" / "mocap" / "p1"
                              / "p1_grab_3_00000000.c3d"))["labels"]
        assert labels[0] == "UMPM_LKNEEBK"
    if kind == "moyo":
        labels = read_c3d(str(tmp_path / "ours" / "moyo" / "mocap" / "user_session"
                              / "pose_b_00000000.c3d"))["labels"]
        assert labels == ["CLAV", "LANK", "LIEL", "EXTRA"]
        labels = read_c3d(str(tmp_path / "ours" / "moyo" / "mocap" / "user_session"
                              / "pose_b_long_00000000.c3d"))["labels"]
        assert "BROKEN1" in labels  # an exact key: no substring match


def test_cli_main_same_files(tmp_path):
    raw = str(tmp_path / "raw")
    _cmu_raw(raw, np.random.RandomState(3))
    argv = ["cmu_kitchen", "--input", raw, "--subjects", "S01", "--parts", "right_arm",
            "--window_seconds", "1.5", "--dataset_name", "kitchen"]
    jcli.main(argv + ["--output", str(tmp_path / "ref")])
    tcli.main(argv + ["--output", str(tmp_path / "ours")])
    files = _same_tree(str(tmp_path / "ours"), str(tmp_path / "ref"))
    assert "kitchen/mocap_parts___right_arm/S01/salad_00000045.c3d" in files
    assert json.loads(files["kitchen/settings.json"]) == {"gender": "neutral"}


def test_preprocess_file_and_gt_slices(tmp_path):
    rng = np.random.RandomState(11)
    labels = ["S1:LSHO", "S1:LELB", "S1:RKNE", "S1:RANK", "S1:C7", "S1:LFHD", "S2:LSHO",
              "S1:BACKPACK1"]
    src = str(tmp_path / "raw.c3d")
    _capture(src, labels, 5, rng, trailing_zeros=30)
    kw = dict(target_freq=30.0, window_seconds=2.0, subject_prefix="S1",
              remove_substrings=("BACKPACK",), parts=["left_arm", "head", "right_leg"],
              keep_whitelist=["LSHO", "LELB", "RKNE", "RANK", "LFHD"],
              canonicalize=str.upper, units_out="mm", gender="female")
    ref = jpre.preprocess_c3d_file(src, str(tmp_path / "ref"), "seq", **kw)
    ours = tpre.preprocess_c3d_file(src, str(tmp_path / "ours"), "seq", **kw)
    assert [os.path.relpath(p, tmp_path / "ours") for p in ours] == \
        [os.path.relpath(p, tmp_path / "ref") for p in ref]
    _same_tree(str(tmp_path / "ours"), str(tmp_path / "ref"))

    gt = str(tmp_path / "gt.npz")
    np.savez(gt, poses=rng.randn(170, 72), trans=rng.randn(170, 3), betas=rng.randn(10),
             mocap_frame_rate=30.0, gender="female")
    ref = jpre.slice_gt_to_windows(gt, str(tmp_path / "gt_ref"), "seq", window_seconds=2.0)
    ours = tpre.slice_gt_to_windows(gt, str(tmp_path / "gt_ours"), "seq", window_seconds=2.0)
    assert len(ours) == 3 and [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in ref]
    for a, b in zip(ours, ref):
        za, zb = np.load(a), np.load(b)
        assert sorted(za.files) == sorted(zb.files)
        for k in zb.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("layout", ["FM3", "F3M", "3FM"])
def test_convert_bmlmovi_mat_same_bytes(tmp_path, layout):
    rng = np.random.RandomState(2)
    F, M = 50, 7
    pts = (rng.randn(F, M, 3) * 300).astype(np.float32)
    arr = {"FM3": pts, "F3M": pts.transpose(0, 2, 1), "3FM": pts.transpose(2, 0, 1)}[layout]
    mat = str(tmp_path / "subj.mat")
    scipy.io.savemat(mat, {"Subject_1": {"move": {"markerLocation": arr, "frameRate": 120.0},
                                         "name": "s1"}})
    a = tcli.convert_bmlmovi_mat(mat, str(tmp_path / "ours.c3d"))
    b = jcli.convert_bmlmovi_mat(mat, str(tmp_path / "ref.c3d"))
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(read_c3d(a)["points"][:, :, :3], pts)
    empty = str(tmp_path / "empty.mat")
    scipy.io.savemat(empty, {"x": np.zeros((4, 4))})
    with pytest.raises(ValueError, match="no \\[F, M, 3\\]"):
        tcli.convert_bmlmovi_mat(empty, str(tmp_path / "e.c3d"))


def test_small_helpers_equal():
    rng = np.random.RandomState(4)
    for n, src, dst in ((1200, 120.0, 30.0), (7, 100.0, 30.0), (451, 59.94, 30.0), (5, 30.0, 60.0)):
        np.testing.assert_array_equal(tpre.get_downsampled_indices(n, src, dst),
                                      jpre.get_downsampled_indices(n, src, dst))
    pts = rng.randn(12, 9, 3)
    np.testing.assert_array_equal(tpre.shuffle_c3d(pts), jpre.shuffle_c3d(pts))
    np.testing.assert_array_equal(tpre.shuffle_c3d(pts, np.random.RandomState(8)),
                                  jpre.shuffle_c3d(pts, np.random.RandomState(8)))
    padded = np.concatenate([pts, np.zeros((4, 9, 3))])
    for p in (padded, pts, np.zeros((3, 2, 3))):
        np.testing.assert_array_equal(tpre.trim_trailing_zero_channels(p),
                                      jpre.trim_trailing_zero_channels(p))
    labels = ["A:LSHO", "A:LELB ", "B:LSHO", "A_RKNE", "A:BACKPACK2", "A:lknssbk", "A:T10"]
    for kw in (dict(), dict(subject_prefix="A"), dict(subject_prefix="A", remove_labels=("T10",)),
               dict(subject_prefix="A", remove_substrings=("BACK",), keep_whitelist=["LSHO", "RKNE"]),
               dict(subject_prefix="A", canonicalize=ttables.umpm_fix_label)):
        a_pts, a_lab = tpre.filter_labels(pts[:, :7], labels, **kw)
        b_pts, b_lab = jpre.filter_labels(pts[:, :7], labels, **kw)
        assert a_lab == b_lab
        np.testing.assert_array_equal(a_pts, b_pts)
    labels = ["LSHO", "LUPA", "RWRA", "RELB", "LKNE", "LANK", "C7", "LFHD", "RTOE"]
    for part, table in (("left_arm", None), ("head", None), ("right_arm", ttables.CMU_KITCHEN_BODY_PARTS),
                        ("left_leg", ttables.CMU_KITCHEN_BODY_PARTS)):
        a_pts, a_lab = tpre.select_part(pts, labels, part, table)
        b_pts, b_lab = jpre.select_part(pts, labels, part, table)
        assert a_lab == b_lab
        np.testing.assert_array_equal(a_pts, b_pts)
    for freq, secs, pad in ((1.0, 4.0, True), (1.0, 4.0, False), (30.0, 0.2, True), (2.0, 3.0, True)):
        a = tpre.window_sequence(pts, freq, secs, pad)
        b = jpre.window_sequence(pts, freq, secs, pad)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for label in ("lknssbk", "LKNSSBK", "rshld", "LKNEEBK"):
        assert ttables.umpm_fix_label(label) == jtables.umpm_fix_label(label)
    for name in ("CMU_KITCHEN_BACKPACK_LABELS", "CMU_KITCHEN_BODY_PARTS", "UMPM_BODY_PARTS",
                 "UMPM_PARTS_BODY_PARTS", "MOYO_VALID_MARKERS", "MOYO_BODY_PARTS",
                 "DATASET_PART_TABLES"):
        assert getattr(ttables, name) == getattr(jtables, name), name
    assert tpre.BODY_PARTS == jpre.BODY_PARTS
    assert tcli.DATASET_DEFAULTS == jcli.DATASET_DEFAULTS


def test_preprocess_videos_same_files(tmp_path):
    cv2 = pytest.importorskip("cv2")
    src = str(tmp_path / "raw.avi")
    rng = np.random.RandomState(6)
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 60.0, (32, 32))
    for _ in range(8):
        writer.write(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8))
    writer.release()
    ref = jcli.preprocess_videos(src, str(tmp_path / "ref"), "seq", 0.1, 30.0)
    ours = tcli.preprocess_videos(src, str(tmp_path / "ours"), "seq", 0.1, 30.0)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref] == \
        ["seq_00000000.avi", "seq_00000003.avi"]
    _same_tree(str(tmp_path / "ours"), str(tmp_path / "ref"))

    def frames(path):
        cap, out = cv2.VideoCapture(path), []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            out.append(frame)
        cap.release()
        return out

    assert [len(frames(p)) for p in ours] == [3, 1]


def test_long_capture_reads_every_frame(tmp_path):
    """POINT:FRAMES is a signed 16-bit word: a capture of 5 min at 120 Hz
    (36,000 frames) is written with 32767 there, and both of the port's
    parsers read the header's count instead of stopping at 32,767 frames."""
    pts = np.random.RandomState(9).randn(36000, 2, 3).astype(np.float32)
    path = write_c3d(str(tmp_path / "long.c3d"), pts, rate=120.0, units="mm")
    for native in (True, False):
        got = read_c3d(path, use_native=native)["points"]
        assert got.shape == (36000, 2, 4), native
        np.testing.assert_array_equal(got[:, :, :3], pts)
