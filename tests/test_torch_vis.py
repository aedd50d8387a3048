"""The port's vis core and ``eval.qualitative`` against the JAX package's, on
the CPU, on the same inputs made from a seed with numpy.

Scene dictionaries are held equal (the floor included); the renderer and
the five plots are held pixel for pixel, PNGs decoded with PIL.
``run_qualitative`` is held to the same written paths; its device half,
``posed_vertices``, to the JAX ``lbs_forward`` within 1e-5 m (float32 on
both sides).  Sizes: the synthetic body (V = 6890), a 2-frame render of a
culled mesh, sequences of 3-4 frames rendered at 2.
"""
import copy
import dataclasses
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import jax.numpy as jnp
import numpy as np
import pytest

from uuo_mocap_tpu.body.model import lbs_forward as jax_lbs_forward
from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.eval import qualitative as jqual
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu.vis import plots as jplots
from uuo_mocap_tpu.vis import renderer as jrenderer
from uuo_mocap_tpu.vis import scene as jscene
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.eval import qualitative as tqual
from uuo_mocap_tpu_torch.vis import plots as tplots
from uuo_mocap_tpu_torch.vis import renderer as trenderer
from uuo_mocap_tpu_torch.vis import scene as tscene
from uuo_mocap_tpu_torch.vis import viewer_pyrender as tviewer


@pytest.fixture(scope="module")
def bodies():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


def _pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _same_scene(a, b):
    assert a.up_axis == b.up_axis
    assert (a.floor is None) == (b.floor is None)
    if b.floor is not None:
        assert sorted(a.floor) == sorted(b.floor)
        for k in b.floor:
            np.testing.assert_array_equal(a.floor[k], b.floor[k])
    for got, want in ((a.meshes, b.meshes), (a.points, b.points), (a.lines, b.lines)):
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert sorted(x) == sorted(y)
            for k in y:
                if isinstance(y[k], (str, float)) or y[k] is None:
                    assert x[k] == y[k], k
                else:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _fill(scene, rng_seed, verts, faces):
    rng = np.random.RandomState(rng_seed)
    scene.add_mesh(verts, faces)
    scene.add_mesh(verts + 0.5, faces, color=(0.2, 0.3, 0.4),
                   vertex_colors=rng.rand(verts.shape[0], 3), name="second")
    scene.add_markers(verts[::7] + 0.01, labels=np.arange(len(verts[::7])) % 30)
    scene.add_markers(verts[::11], color=(0.0, 0.5, 1.0), size=8.0, name="plain")
    scene.add_lines(verts[:3], verts[3:6], name="offsets")


@pytest.mark.parametrize("floor,up", [(True, "z"), (True, "y"), (False, "z")])
def test_scene_dicts_equal(bodies, floor, up):
    jm, _ = bodies
    verts = np.asarray(jm.v_template)[::97]
    faces = np.array([[0, 1, 2], [2, 3, 4]])
    a, b = tscene.VideoMocapScene(floor=floor, up_axis=up), jscene.VideoMocapScene(floor=floor, up_axis=up)
    _fill(a, 0, verts, faces)
    _fill(b, 0, verts, faces)
    _same_scene(a, b)
    a.clear_dynamic()
    assert not (a.meshes or a.points or a.lines)
    for extent, tiles in ((3.0, 8), (1.0, 3)):
        fa, fb = tscene.create_floor(extent, tiles), jscene.create_floor(extent, tiles)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k])
    labels = np.asarray(jm.lbs_weights).argmax(-1)
    np.testing.assert_array_equal(tscene.extract_part_vertices(labels, [0, 3, 20]),
                                  jscene.extract_part_vertices(labels, [0, 3, 20]))
    np.testing.assert_array_equal(tscene.SMPL_COLORS, jscene.SMPL_COLORS)


def test_renderer_pixel_equal(bodies, tmp_path):
    jm, _ = bodies
    verts = np.asarray(jm.v_template)
    faces = np.asarray(jm.faces)[::40]
    markers = verts[::400] + 0.01

    def frames(mod_scene, mod_renderer, out):
        scene = mod_scene.VideoMocapScene()

        def render_frame(s, f):
            s.add_mesh(verts + [0.05 * f, 0, 0], faces)
            s.add_markers(markers, labels=np.arange(markers.shape[0]) % 24)
            s.add_lines(markers[:2], markers[2:4])

        return mod_renderer.VideoMocapRenderer(scene, render_frame, 2, out, figsize=3.0,
                                               elev=15.0, azim=-30.0).run()

    a = frames(tscene, trenderer, str(tmp_path / "ours"))
    b = frames(jscene, jrenderer, str(tmp_path / "ref"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == ["000000.png", "000001.png"]
    for name in ("000000.png", "000001.png"):
        pa, pb = _pixels(os.path.join(a, name)), _pixels(os.path.join(b, name))
        assert pa.shape == (300, 300, 4)
        np.testing.assert_array_equal(pa, pb)
    assert not np.array_equal(_pixels(os.path.join(a, "000000.png")),
                              _pixels(os.path.join(a, "000001.png")))


def test_plots_pixel_equal(tmp_path):
    rng = np.random.RandomState(0)
    trajs = [rng.randn(20, 3), rng.randn(15, 3)]
    joints = rng.rand(2, 45, 2) * 100
    contacts = np.array([[1.0, 0.0], [0.0, 1.0]])
    err = rng.rand(30, 22)
    labels = rng.randint(0, 24, 50)
    true, pred = rng.randint(0, 24, 100), rng.randint(0, 24, 100)
    calls = [
        ("plot_root_trajectories", lambda m, p: m.plot_root_trajectories(p, trajs, ["a", "b"])),
        ("plot_2d_joints", lambda m, p: m.plot_2d_joints(p, joints, 1, foot_contacts=contacts)),
        ("plot_error_heatmap", lambda m, p: m.plot_error_heatmap(p, err, vmax=0.8)),
        ("plot_label_histogram", lambda m, p: m.plot_label_histogram(p, labels)),
        ("plot_confusion_matrix", lambda m, p: m.plot_confusion_matrix(p, true, pred)),
    ]
    for name, call in calls:
        a = call(tplots, str(tmp_path / f"ours_{name}.png"))
        b = call(jplots, str(tmp_path / f"ref_{name}.png"))
        np.testing.assert_array_equal(_pixels(a), _pixels(b), err_msg=name)


def _pose_npz(path, F, seed, gender="neutral"):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, poses=(rng.randn(F, 72) * 0.3).astype(np.float32),
             betas=(rng.randn(10) * 0.5).astype(np.float32),
             trans=(rng.randn(F, 3) * 0.2).astype(np.float32), mocap_frame_rate=30.0,
             gender=gender, mocap_markers=rng.randn(F, 8, 3).astype(np.float32))


def test_run_qualitative_same_paths(bodies, tmp_path):
    # the full bodies with every 24th face: the renders are held by the
    # renderer's own test; this one holds the paths and the calls that make them
    jm, tm = bodies
    jm = dataclasses.replace(jm, faces=jm.faces[::24])
    tm = copy.copy(tm)
    tm.faces = tm.faces[::24]
    base = tmp_path / "ds"
    _pose_npz(str(base / "smpl" / "s1" / "seq_stageii.npz"), 4, 1)
    _pose_npz(str(base / "results" / "video_mocap" / "s1" / "seq_stageii.npz"), 4, 2)
    _pose_npz(str(base / "smpl" / "s1" / "other_stageii.npz"), 3, 3)  # no video_mocap result
    _pose_npz(str(base / "results" / "video_mocap" / "s1" / "arm" / "seq_stageii.npz"), 3, 4)
    kw = dict(max_frames=2, body_models_dir=str(tmp_path / "none"))
    cases = [(["moshpp", "video_mocap"], {}), (["video_mocap", "moshpp"], {"part": "arm"}),
             (["moshpp"], {"fmt": "png"})]
    for methods, extra in cases:
        ref = jqual.run_qualitative(jm, str(tmp_path), "ds", methods, **kw, **extra)
        ours = tqual.run_qualitative(tm, str(tmp_path), "ds", methods, **kw, **extra)
        assert ours == ref and ours
        assert all(os.path.exists(p) for p in ours)
    assert os.path.exists(base / "results" / "qual" / "video_mocap" / "s1" / "arm" / "seq.gif")
    assert os.path.isdir(base / "results" / "qual" / "moshpp" / "s1" / "seq.png")


def test_posed_vertices_equal_jax_lbs(bodies, tmp_path):
    from uuo_mocap_tpu_torch.eval.comparisons import load_smpl_npz

    jm, tm = bodies
    path = str(tmp_path / "a_stageii.npz")
    _pose_npz(path, 5, 7)
    pred = load_smpl_npz(path)
    mats = jrot.axis_angle_to_matrix(jnp.asarray(pred["pose_aa"]))
    want = np.asarray(jax_lbs_forward(jm, mats[:, 1:], jnp.broadcast_to(jnp.asarray(pred["betas"])[None], (5, 10)),
                                      mats[:, :1], jnp.asarray(pred["trans"]))["vertices"])
    for max_frames, F in ((None, 5), (3, 3)):
        got = tqual.posed_vertices(pred, tm, max_frames)
        assert tuple(got.shape) == (F, 6890, 3) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want[:F], rtol=0, atol=1e-5)


def test_pyrender_available_matches_import():
    try:
        import pyrender  # noqa: F401
        have = True
    except Exception:
        have = False
    assert tviewer.pyrender_available() is have
