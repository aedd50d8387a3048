"""The port's file IO against the JAX package on the same inputs: the c3d
writer and readers (pure Python and native), the prefetcher, ``Markers``,
the joblib-free pkl reader, 4D-Humans pkl parsing (``ImgSmpl``) and the SMPL
asset loader.

Tolerances: the c3d writer is held byte for byte, the readers and the asset
loader exactly (they copy bytes); ``ImgSmpl``'s gap fill slerps in float32
on both sides and is held within 1e-6, its axis-angle export within 1e-5
rad; the loaded models' forwards within 1e-5 m.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import pickle
import struct
import sys
import types

import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import scipy.sparse
import torch

from uuo_mocap_tpu.body.model import PARENTS
from uuo_mocap_tpu.body.model import lbs_forward as jax_lbs_forward
from uuo_mocap_tpu.body.model import load_body_model as jax_load_body_model
from uuo_mocap_tpu.body.synthetic import _build_arrays, export_synthetic_npz
from uuo_mocap_tpu.data import c3d as jc3d
from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu_torch.body.model import lbs_forward, load_body_model
from uuo_mocap_tpu_torch.data import c3d as tc3d
from uuo_mocap_tpu_torch.data.c3d_native import SequencePrefetcher, read_c3d_native
from uuo_mocap_tpu_torch.data.img_smpl import CORRECTION_MATRIX, ImgSmpl
from uuo_mocap_tpu_torch.data.markers import Markers, markers_from_c3d_dict
from uuo_mocap_tpu_torch.data.pkl_io import dump_pkl, load_pkl

RNG = np.random.RandomState(5)


def _points(F=13, M=7, scale=1.0):
    return (RNG.randn(F, M, 3) * scale).astype(np.float32)


def _int_c3d(path, points_int, scale, rate=120.0, units="mm", labels=("A", "B", "C")):
    """An integer-format C3D (POINT:SCALE > 0) with analog-free int16 data,
    from the port's parameter encoders."""
    F, M, _ = points_int.shape
    pblob = struct.pack("<BBbb", 0, 0, 0, 84) + tc3d._group_bytes("POINT", 1)
    pblob += tc3d._param_bytes("USED", 1, 2, [], struct.pack("<h", M))
    pblob += tc3d._param_bytes("RATE", 1, 4, [], struct.pack("<f", rate))
    pblob += tc3d._param_bytes("SCALE", 1, 4, [], struct.pack("<f", scale))
    pblob += tc3d._param_bytes("UNITS", 1, -1, [len(units)], units.encode())
    pblob += tc3d._param_bytes("LABELS", 1, -1, [4, M],
                               b"".join(l.ljust(4).encode() for l in labels))
    pblob = (pblob + b"\x00\x00").ljust(512, b"\x00")
    header = bytearray(512)
    header[0], header[1] = 2, 0x50
    struct.pack_into("<4H", header, 2, M, 0, 1, F)
    struct.pack_into("<f", header, 12, scale)
    struct.pack_into("<H", header, 16, 3)
    struct.pack_into("<f", header, 20, rate)
    data = np.zeros((F, M, 4), np.int16)
    data[..., :3] = points_int
    with open(path, "wb") as f:
        f.write(bytes(header) + pblob + data.tobytes())
    return path


@pytest.mark.parametrize("units, labels", [("m", None), ("mm", ["LANK", "RANK", "C7", "T10",
                                                                  "CLAV", "STRN", "LONGLABEL"])])
def test_write_c3d_same_bytes(tmp_path, units, labels):
    pts = _points()
    a = jc3d.write_c3d(str(tmp_path / "j.c3d"), pts, rate=60.0, units=units, labels=labels)
    b = tc3d.write_c3d(str(tmp_path / "t.c3d"), pts, rate=60.0, units=units, labels=labels)
    assert open(a, "rb").read() == open(b, "rb").read()


def _files(tmp_path):
    float_file = tc3d.write_c3d(str(tmp_path / "f.c3d"), _points(F=600, M=41), rate=100.0,
                                units="mm", labels=[f"M{i}" for i in range(41)])
    ints = RNG.randint(-3000, 3000, (9, 3, 3)).astype(np.int16)
    return float_file, _int_c3d(str(tmp_path / "i.c3d"), ints, 0.25)


def test_read_c3d_and_peek_agree_with_jax(tmp_path):
    for path in _files(tmp_path):
        ref = jc3d.read_c3d(path, use_native=False)
        out = tc3d.read_c3d(path, use_native=False)
        assert out.keys() == ref.keys()
        np.testing.assert_array_equal(out["points"], ref["points"])
        for k in ("rate", "units", "labels", "first_frame", "num_points"):
            assert out[k] == ref[k], k
        assert tc3d.peek_c3d_shape(path) == jc3d.peek_c3d_shape(path)


def test_native_parser_agrees_with_python_and_raises_on_garbage(tmp_path):
    for path in _files(tmp_path):
        py = tc3d.read_c3d(path, use_native=False)
        nat = tc3d.read_c3d(path)  # the native library, built on first use
        np.testing.assert_array_equal(nat["points"], py["points"])
        for k in ("rate", "units", "labels", "num_points"):
            assert nat[k] == py[k], k
    garbage = tmp_path / "garbage.c3d"
    garbage.write_bytes(RNG.bytes(2000))
    with pytest.raises(ValueError, match="c3d parse failed"):
        read_c3d_native(str(garbage))
    truncated = tmp_path / "truncated.c3d"
    truncated.write_bytes(open(_files(tmp_path)[0], "rb").read()[:600])
    with pytest.raises(ValueError, match="c3d parse failed"):
        read_c3d_native(str(truncated))
    with pytest.raises(ValueError, match="cannot open"):
        read_c3d_native(str(tmp_path / "missing.c3d"))


def test_prefetcher_round_trip(tmp_path):
    paths = [tc3d.write_c3d(str(tmp_path / f"s{i}.c3d"), _points(F=20 + i, M=5), rate=30.0)
             for i in range(5)]
    with SequencePrefetcher(n_threads=2) as pf:
        for p in paths:
            pf.enqueue(p)
        for p in reversed(paths):
            got = pf.get(p)
            ref = tc3d.read_c3d(p, use_native=False)
            np.testing.assert_array_equal(got["points"], ref["points"])
            assert got["rate"] == ref["rate"]


def test_markers_units_and_shuffle(tmp_path):
    pts_m = _points(F=6, M=4)
    path = tc3d.write_c3d(str(tmp_path / "mm.c3d"), pts_m * 1000.0, rate=50.0, units="mm")
    mk = Markers(path)
    np.testing.assert_allclose(mk.get_points(), pts_m, rtol=1e-6, atol=0)
    assert (mk.get_frequency(), mk.get_num_markers(), len(mk)) == (50.0, 4, 6)
    assert mk.get_labels() == ["M000", "M001", "M002", "M003"]
    via_dict = markers_from_c3d_dict(tc3d.read_c3d(path), path)
    np.testing.assert_array_equal(via_dict.get_points(), mk.get_points())
    shuffled = Markers(path, shuffle=True, rng=np.random.RandomState(0))
    np.testing.assert_array_equal(np.sort(shuffled.get_points(), axis=1),
                                  np.sort(mk.get_points(), axis=1))
    ints = RNG.randint(-3000, 3000, (4, 3, 3)).astype(np.int16)
    cm = Markers(_int_c3d(str(tmp_path / "cm.c3d"), ints, 0.5, units="cm"))
    np.testing.assert_allclose(cm.get_points(), ints * 0.5 / 100.0, rtol=1e-6)


def _nested_payload():
    rng = np.random.RandomState(1)
    return {
        "frame_000.jpg": {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
                          "f": np.asfortranarray(rng.randn(5, 3)), "i": np.arange(7),
                          "s": "text", "lst": [np.float32(1.5), np.zeros(0), np.array(3.0)],
                          "obj": np.array([{"x": 1}, None], dtype=object)},
        "frame_001.jpg": {"big": rng.randn(300, 45, 3).astype(np.float32), "tracked_ids": [0]},
    }


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == object:
            assert list(a.ravel()) == list(b.ravel())
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("compress", [0, 3, ("gzip", 3)])
def test_pkl_reader_matches_joblib(tmp_path, compress):
    path = str(tmp_path / "demo.pkl")
    joblib.dump(_nested_payload(), path, compress=compress)
    _assert_same(load_pkl(path), joblib.load(path))


def test_pkl_writer_is_read_by_joblib(tmp_path):
    path = dump_pkl(_nested_payload(), str(tmp_path / "plain.pkl"))
    _assert_same(joblib.load(path), _nested_payload())
    _assert_same(load_pkl(path), _nested_payload())


def _phalp(F=24, seed=0):
    """A 4D-Humans demo pkl dict: untracked frames at the start, in two
    middle gaps and at the end; camera streams on tracked frames; random 2D
    joints."""
    rng = np.random.RandomState(seed)
    tracked = np.ones(F, bool)
    tracked[[0, 1, 7, 8, 9, 15, F - 1]] = False
    data = {}
    for f in range(F):
        go = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(rng.randn(3).astype(np.float32))))
        pose = np.asarray(jrot.axis_angle_to_matrix(
            jnp.asarray(rng.randn(23, 3).astype(np.float32) * 0.4)))
        frame = {"tracked_ids": [3] if tracked[f] else [],
                 "2d_joints": [rng.rand(90).astype(np.float32) * (1.0 + 0.01 * f)],
                 "camera_bbox": [], "center": [], "scale": [], "size": []}
        if tracked[f]:
            frame["smpl"] = [{"global_orient": go[None], "body_pose": pose,
                              "betas": rng.randn(10).astype(np.float32)}]
            frame["3d_joints"] = [rng.randn(45, 3).astype(np.float32)]
            frame["camera_bbox"] = [rng.rand(3).astype(np.float32)]
            frame["center"] = [rng.rand(2).astype(np.float32)]
            frame["scale"] = [rng.rand(1).astype(np.float32)]
            frame["size"] = [rng.rand(2).astype(np.float32)]
        data[f"frame_{f:06d}.jpg"] = frame
    return data


def test_img_smpl_parses_phalp_like_jax(tmp_path):
    path = str(tmp_path / "demo_seq.pkl")
    joblib.dump(_phalp(), path, compress=3)
    ref = JaxImgSmpl(joblib.load(path), 30.0)
    out = ImgSmpl(load_pkl(path), 30.0)
    np.testing.assert_array_equal(out.img_mask, ref.img_mask)
    np.testing.assert_array_equal(out.foot_contacts, ref.foot_contacts)
    for k in ("camera_bbox", "center", "scale", "size"):
        np.testing.assert_array_equal(getattr(out, k), getattr(ref, k))
    for k in ("trans", "betas", "root_orient", "hmr_root_orient", "pose_body"):
        np.testing.assert_allclose(getattr(out, k), getattr(ref, k), atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(out.root_orient[2], CORRECTION_MATRIX @ out.hmr_root_orient[2],
                               atol=1e-6)
    s_out, s_ref = out.get_smpl(), ref.get_smpl()
    assert s_out.keys() == s_ref.keys()
    np.testing.assert_allclose(s_out["poses"], s_ref["poses"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(s_out["betas"], s_ref["betas"])
    assert str(s_out["gender"]) == str(s_ref["gender"])


class _FakeCh(np.ndarray):
    """Pickles under chumpy's module path, as SMPL's assets do."""


def _chumpy(a):
    return np.asarray(a).view(_FakeCh)


def _smpl_pkl(path, arrays):
    """An SMPL-style pkl: chumpy arrays, a csc_matrix regressor, a
    kintree_table; posedirs [V, 3, 207] as the asset stores them."""
    pkg, mod = types.ModuleType("chumpy"), types.ModuleType("chumpy.ch")
    pkg.ch, mod.Ch = mod, _FakeCh
    _FakeCh.__module__, _FakeCh.__qualname__ = "chumpy.ch", "Ch"
    sys.modules.update({"chumpy": pkg, "chumpy.ch": mod})
    try:
        V = arrays["v_template"].shape[0]
        kintree = np.stack([np.r_[4294967295, PARENTS[1:].astype(np.int64)],
                            np.arange(24)]).astype(np.int64)
        payload = {
            "v_template": _chumpy(arrays["v_template"]),
            "shapedirs": _chumpy(np.concatenate(
                [arrays["shapedirs"], np.ones((V, 3, 290), np.float32)], axis=-1)),
            "posedirs": _chumpy(arrays["posedirs"].T.reshape(V, 3, -1)),
            "J_regressor": scipy.sparse.csc_matrix(arrays["j_regressor"].astype(np.float64)),
            "weights": _chumpy(arrays["lbs_weights"]),
            "f": arrays["faces"].astype(np.uint32),
            "kintree_table": kintree,
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=2)
    finally:
        del sys.modules["chumpy"], sys.modules["chumpy.ch"]
    return path


def _forwards(jm, tm):
    rng = np.random.RandomState(3)
    F = 3
    pose = np.array(jrot.axis_angle_to_matrix(jnp.asarray(rng.randn(F, 23, 3).astype(np.float32) * 0.3)))
    root = np.array(jrot.axis_angle_to_matrix(jnp.asarray(rng.randn(F, 1, 3).astype(np.float32))))
    betas = rng.randn(F, 10).astype(np.float32)
    trans = rng.randn(F, 3).astype(np.float32)
    ref = jax_lbs_forward(jm, *(jnp.asarray(a) for a in (pose, betas, root, trans)))
    out = lbs_forward(tm, *(torch.as_tensor(a) for a in (pose, betas, root, trans)))
    for k in ("joints", "vertices"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=0)


def _same_model(jm, tm):
    for k in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)), err_msg=k)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_array_equal(tm.parents, jm.parents)
    assert tm.gender == jm.gender


def test_load_body_model_from_smpl_pkl_matches_jax(tmp_path):
    os.makedirs(tmp_path / "smpl")
    _smpl_pkl(str(tmp_path / "smpl" / "SMPL_FEMALE.pkl"), _build_arrays("female"))
    jm = jax_load_body_model(str(tmp_path), "female")
    tm = load_body_model(str(tmp_path), "female", device="cpu")
    _same_model(jm, tm)
    _forwards(jm, tm)


def test_load_body_model_from_npz_matches_jax(tmp_path):
    path = export_synthetic_npz(str(tmp_path / "model.npz"))
    jm = jax_load_body_model(path)
    tm = load_body_model(path, device="cpu")
    _same_model(jm, tm)
    _forwards(jm, tm)
