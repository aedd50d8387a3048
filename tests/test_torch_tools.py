"""The port's small tools against the JAX package's, on the CPU, on the same
inputs made from a seed with numpy: ``cli.filter``, ``cli.export_marker_layout``,
``cli.video_tools`` and the ``utils`` helpers (colors, mesh culling, seeding,
device placement).

Tolerances: the smoother within 1e-12 (float64 on both sides), the PLY
writer byte for byte; ``export_marker_layout`` runs the SMPL forward and the
point-to-mesh projection in float32 on both sides, so its PLY is held to the
same header counts and faces and to vertex coordinates within 1e-5 m.  The
synthetic body (V = 6890, 13776 faces), 6 frames x 8 markers.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import random

import jax
import numpy as np
import pytest
import torch

from uuo_mocap_tpu.cli import export_marker_layout as jexport
from uuo_mocap_tpu.cli import filter as jfilter
from uuo_mocap_tpu.cli import video_tools as jvideo
from uuo_mocap_tpu.utils import colors as jcolors
from uuo_mocap_tpu.utils import mesh as jmesh
from uuo_mocap_tpu.utils import random as jrandom
from uuo_mocap_tpu.utils import tensor as jtensor
from uuo_mocap_tpu_torch.cli import export_marker_layout as texport
from uuo_mocap_tpu_torch.cli import filter as tfilter
from uuo_mocap_tpu_torch.cli import video_tools as tvideo
from uuo_mocap_tpu_torch.data.c3d import write_c3d
from uuo_mocap_tpu_torch.utils import colors as tcolors
from uuo_mocap_tpu_torch.utils import mesh as tmesh
from uuo_mocap_tpu_torch.utils import random as trandom
from uuo_mocap_tpu_torch.utils import tensor as ttensor

NO_MODELS = "no_body_models_here"  # a missing directory: both CLIs take the synthetic body


@pytest.mark.parametrize("F,window,order", [(30, 7, 3), (12, 9, 2), (8, 7, 3), (4, 7, 3), (41, 11, 4)])
def test_smooth_poses_equal(F, window, order):
    x = np.random.RandomState(F).randn(F, 72)
    np.testing.assert_allclose(tfilter.smooth_poses(x, window, order),
                               jfilter.smooth_poses(x, window, order), rtol=0, atol=1e-12)


def test_filter_cli_equal(tmp_path):
    rng = np.random.RandomState(0)
    src = str(tmp_path / "in.npz")
    np.savez(src, poses=rng.randn(30, 72), trans=rng.randn(30, 3), betas=rng.randn(10),
             mocap_frame_rate=30.0, gender="neutral")
    argv = ["--input", src, "--window", "9", "--order", "2", "--output"]
    jfilter.main(argv + [str(tmp_path / "ref.npz")])
    tfilter.main(argv + [str(tmp_path / "ours.npz")])
    a, b = np.load(tmp_path / "ours.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12, err_msg=k)
        else:
            assert a[k] == b[k], k
    raw = np.load(src)["poses"]
    assert np.abs(np.diff(a["poses"], axis=0)).mean() < np.abs(np.diff(raw, axis=0)).mean()


@pytest.mark.parametrize("with_colors", [True, False])
def test_write_ply_same_bytes(tmp_path, with_colors):
    rng = np.random.RandomState(1)
    v = rng.randn(20, 3).astype(np.float32)
    f = rng.randint(0, 20, (11, 3))
    c = rng.rand(20, 3) * 1.2 - 0.1 if with_colors else None
    a = texport.write_ply(str(tmp_path / "ours.ply"), v, f, c)
    b = jexport.write_ply(str(tmp_path / "ref.ply"), v, f, c)
    assert open(a, "rb").read() == open(b, "rb").read()


def _read_ply(path):
    with open(path) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    header = lines[:end]
    nv = int(next(l for l in header if l.startswith("element vertex")).split()[-1])
    nf = int(next(l for l in header if l.startswith("element face")).split()[-1])
    rows = [l.split() for l in lines[end + 1:]]
    verts = np.array([[float(x) for x in r[:3]] for r in rows[:nv]])
    colors = np.array([[int(x) for x in r[3:]] for r in rows[:nv]])
    faces = np.array([[int(x) for x in r] for r in rows[nv:nv + nf]])
    return header, verts, colors, faces


def test_export_marker_layout_main_equal(tmp_path):
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.eval.comparisons import load_smpl_npz, smpl_forward_zeroed_hands

    rng = np.random.RandomState(3)
    F, M = 6, 8
    poses = rng.randn(F, 72) * 0.2
    trans = rng.randn(F, 3) * 0.1
    npz = str(tmp_path / "seq_stageii.npz")
    np.savez(npz, poses=poses, betas=rng.randn(10) * 0.5, trans=trans, mocap_frame_rate=30.0,
             gender="neutral")
    # markers near the posed surface: vertices of the sequence's forward, offset by ~1 cm
    model = synthetic_body_model(device="cpu")
    verts = smpl_forward_zeroed_hands(model, load_smpl_npz(npz))["vertices"].numpy()
    ids = rng.choice(verts.shape[1], M, replace=False)
    markers = verts[:, ids] + rng.randn(F, M, 3) * 0.01
    c3d = write_c3d(str(tmp_path / "seq.c3d"), markers * 1000.0, rate=30.0, units="mm")

    argv = ["--markers", c3d, "--smpl", npz, "--frame", "4", "--body_models", NO_MODELS,
            "--output"]
    jexport.main(argv + [str(tmp_path / "ref.ply")])
    got = texport.main(argv + [str(tmp_path / "ours.ply"), "--cpu_only"])
    ha, va, ca, fa = _read_ply(tmp_path / "ours.ply")
    hb, vb, cb, fb = _read_ply(tmp_path / "ref.ply")
    assert ha == hb
    assert f"element vertex {6890 + 6 * M}" in ha and f"element face {13776 + 8 * M}" in ha
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_allclose(va, vb, rtol=0, atol=1e-5)
    assert got["path"] == str(tmp_path / "ours.ply")
    assert got["face_index"].shape == (M,) and got["barycentric"].shape == (M, 3)
    assert np.isfinite(got["distance"]).all() and got["distance"].max() < 0.1
    # each marker's octahedron is centred on its template position
    np.testing.assert_allclose(va[6890::6] - [0.012, 0, 0], got["template_position"], atol=1e-5)


def test_new_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from uuo_mocap_tpu_torch.eval import qualitative

    with pytest.raises(RuntimeError, match="device='cpu'"):
        texport.main(["--markers", "m.c3d", "--smpl", "s.npz", "--output",
                      str(tmp_path / "x.ply")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qualitative.main(["--input_dir", str(tmp_path), "--dataset", "ds", "--methods", "moshpp"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttensor.dict2device({"a": np.zeros(2)})
    assert not os.path.exists(tmp_path / "x.ply")


def test_video_tools_equal(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(4)
    video = str(tmp_path / "v.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (48, 48))
    for _ in range(5):
        writer.write(rng.randint(0, 255, (48, 48, 3), dtype=np.uint8))
    writer.release()
    na = tvideo.video2images(video, str(tmp_path / "ours"), stride=2)
    nb = jvideo.video2images(video, str(tmp_path / "ref"), stride=2)
    assert na == nb == 3
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "ours")) == names == ["000000.jpg", "000002.jpg", "000004.jpg"]
    for n in names:
        assert open(tmp_path / "ours" / n, "rb").read() == open(tmp_path / "ref" / n, "rb").read()

    img = np.full((128, 128), 60, np.uint8)
    for x, y in ((30, 30), (90, 40), (60, 100)):
        cv2.circle(img, (x, y), 6, 255, -1)
    path = str(tmp_path / "dots.png")
    cv2.imwrite(path, cv2.GaussianBlur(img, (5, 5), 1.5))
    a, b = tvideo.detect_keypoints(path), jvideo.detect_keypoints(path)
    assert a.shape == (3, 3)
    np.testing.assert_array_equal(a, b)
    tvideo.main(["video2images", "--video", video, "--out_dir", str(tmp_path / "cli")])
    assert len(os.listdir(tmp_path / "cli")) == 5


def test_colors_and_cull_parts_equal():
    np.testing.assert_array_equal(tcolors.PART_COLORS, jcolors.PART_COLORS)
    for j in (0, 7, 23, 30):
        np.testing.assert_array_equal(tcolors.get_joint_color(j), jcolors.get_joint_color(j))
    for name in ("pelvis", "left_wrist", "right_foot"):
        np.testing.assert_array_equal(tcolors.get_joint_color_by_name(name),
                                      jcolors.get_joint_color_by_name(name))
    labels = np.random.RandomState(5).randint(0, 60, 40)
    np.testing.assert_array_equal(tcolors.colors_for_labels(labels), jcolors.colors_for_labels(labels))

    rng = np.random.RandomState(6)
    faces = rng.randint(0, 50, (80, 3))
    vertex_labels = rng.randint(0, 24, 50)
    for keep in ([0], [1, 5, 9], range(12), []):
        np.testing.assert_array_equal(tmesh.cull_parts(faces, vertex_labels, keep),
                                      jmesh.cull_parts(faces, vertex_labels, keep))


def test_set_random_seed_streams_equal():
    draws = []
    for fn in (jrandom.set_random_seed, trandom.set_random_seed):
        out = fn(1234)
        draws.append((random.random(), random.randint(0, 10 ** 9), np.random.rand(5).tolist(),
                      np.random.randint(0, 100, 4).tolist()))
    assert draws[0] == draws[1]
    gen = trandom.set_random_seed(77)
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 77
    a = torch.rand(4, generator=gen)
    assert torch.equal(a, torch.rand(4, generator=trandom.set_random_seed(77)))
    assert out.initial_seed() == 1234


def test_dict2device_cpu_equal():
    rng = np.random.RandomState(7)
    tree = {"a": rng.randn(3, 2).astype(np.float32), "b": {"c": np.arange(4)},
            "t": torch.ones(2, dtype=torch.float64), "n": 3, "s": "name",
            "l": [rng.randn(2), 1.5]}
    ours = ttensor.dict2device(tree, "cpu")
    ref = jtensor.dict2device({k: v.numpy() if isinstance(v, torch.Tensor) else v
                               for k, v in tree.items()}, jax.devices("cpu")[0])
    for got, want in ((ours["a"], ref["a"]), (ours["b"]["c"], ref["b"]["c"]),
                      (ours["t"], ref["t"]), (ours["l"][0], ref["l"][0])):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        want = np.asarray(want)  # float32 where the JAX package runs without x64
        np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)
    assert ours["n"] == ref["n"] == 3 and ours["s"] == ref["s"] and ours["l"][1] == 1.5
