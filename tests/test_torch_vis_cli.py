"""The last of the port's ``vis/`` (the seven ``visualize_*`` CLIs,
``visualize_part`` and ``paper.py``) against the JAX package's, on the CPU,
on the same inputs made from seeds with numpy.

Renders and plots are held pixel for pixel (PNGs decoded with PIL, GIFs
frame by frame); device halves (the LBS forwards of the CLIs, the
reprojection stage, the segmenter, the solve) against the JAX package's
arrays: vertices within 1e-5 m, labels and confusion matrices equal, the
reprojection stage and ``visualize_model``'s solve under their parity
tests' rules (``tests/test_torch_reprojection.py``,
``tests/test_torch_learned_solve.py``: 1e-2, or twice what the reference
itself moves when its markers are scaled by 1 + 1e-6).  A CLI's render is
held pixel for pixel from the same arrays: the port's ``main`` runs with
its device half handing over the reference's arrays (float32 rounding
moves a rendered edge by a pixel), and its device half is held on its own.  Sizes: the
synthetic body (V = 6890), 2-4 frames, renders of 2 frames; the solve 24
frames x 12 markers with 5-iteration stages.  ``--viewer`` is not run: this
host has no pyrender.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import contextlib
import glob
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from uuo_mocap_tpu.body.model import lbs_forward as jax_lbs_forward
from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.cli import export_synthetic_c3d as jax_export
from uuo_mocap_tpu.data.c3d import write_c3d
from uuo_mocap_tpu.data.synthetic import random_pose_sequence
from uuo_mocap_tpu.vis import paper as jpaper
from uuo_mocap_tpu.vis import renderer as jrenderer
from uuo_mocap_tpu.vis import visualize_dataset as jdataset
from uuo_mocap_tpu.vis import visualize_iterations as jiterations
from uuo_mocap_tpu.vis import visualize_markers as jmarkers
from uuo_mocap_tpu.vis import visualize_model as jmodel
from uuo_mocap_tpu.vis import visualize_part as jpart
from uuo_mocap_tpu.vis import visualize_reprojection as jreproj
from uuo_mocap_tpu.vis import visualize_segmentation as jseg
from uuo_mocap_tpu.vis import visualize_smpl as jsmpl
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.vis import paper as tpaper
from uuo_mocap_tpu_torch.vis import renderer as trenderer
from uuo_mocap_tpu_torch.vis import visualize_dataset as tdataset
from uuo_mocap_tpu_torch.vis import visualize_iterations as titerations
from uuo_mocap_tpu_torch.vis import visualize_markers as tmarkers
from uuo_mocap_tpu_torch.vis import visualize_model as tmodel
from uuo_mocap_tpu_torch.vis import visualize_part as tpart
from uuo_mocap_tpu_torch.vis import visualize_reprojection as treproj
from uuo_mocap_tpu_torch.vis import visualize_segmentation as tseg
from uuo_mocap_tpu_torch.vis import visualize_smpl as tsmpl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = os.path.join(REPO, "checkpoints")
VERT_TOL = 1e-5
PARAM_ATOL = 1e-2
RENDER_FRAMES = 2


@pytest.fixture(scope="module")
def bodies():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run in ``tmp_path``: a render without a path writes
    ``render_preview.png`` in the working directory."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture
def capped_renders():
    with _capped():
        yield


def _pixels(path):
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(f.convert("RGBA")) for f in ImageSequence.Iterator(im)]


def _same_image(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert len(pa) == len(pb), (a, b)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y, err_msg=f"{a} vs {b}")


def _same_tree(a, b, pattern="*.png"):
    """Every image under ``b`` has a pixel-equal twin under ``a``."""
    names = sorted(os.path.relpath(p, b) for p in glob.glob(os.path.join(b, "**", pattern),
                                                             recursive=True))
    assert names and names == sorted(os.path.relpath(p, a) for p in glob.glob(
        os.path.join(a, "**", pattern), recursive=True))
    for n in names:
        _same_image(os.path.join(a, n), os.path.join(b, n))
    return names


def _seq(jm, F, seed):
    gt = random_pose_sequence(F, seed=seed)
    out = jax_lbs_forward(jm, gt.pose_body, jnp.broadcast_to(gt.betas, (F, 10)), gt.root_orient,
                          gt.trans)
    return gt, np.asarray(out["vertices"])


def _write_npz(path, gt, F):
    from uuo_mocap_tpu.ops import rotations as jrot

    mats = jnp.concatenate([gt.root_orient, gt.pose_body], axis=1)
    poses = np.asarray(jrot.matrix_to_axis_angle(mats)).reshape(F, -1)
    np.savez(path, poses=poses, betas=np.asarray(gt.betas)[0], trans=np.asarray(gt.trans),
             mocap_frame_rate=30.0, gender="neutral")
    return str(path)


# ------------------------------------------------------------ visualize_part

def test_visualize_part_renders_equal(bodies, in_tmp):
    jm, _ = bodies
    _, verts = _seq(jm, 3, seed=1)
    rng = np.random.RandomState(2)
    markers = verts[:, rng.choice(verts.shape[1], 9, replace=False)] + 0.01
    labels = rng.randint(0, 24, size=(3, 9))
    vids = np.nonzero(np.asarray(jnp.argmax(jm.lbs_weights, -1)) == 4)[0]
    args = (markers, verts, np.asarray(jm.faces), labels, np.array([0, 3, 5]), vids)
    jpart.visualize_part(str(in_tmp / "j"), *args, max_frames=RENDER_FRAMES)
    tpart.visualize_part(str(in_tmp / "t"), *args, max_frames=RENDER_FRAMES)
    assert len(_same_tree(str(in_tmp / "t"), str(in_tmp / "j"))) == RENDER_FRAMES


# ------------------------------------------------------------ visualize_smpl

def test_visualize_smpl_device_half_matches_jax(bodies, tmp_path):
    from uuo_mocap_tpu.eval.comparisons import load_smpl_npz, smpl_forward_zeroed_hands

    jm, tm = bodies
    gt, _ = _seq(jm, 3, seed=4)
    npz = _write_npz(tmp_path / "a_stageii.npz", gt, 3)
    ref = np.asarray(smpl_forward_zeroed_hands(jm, load_smpl_npz(npz))["vertices"])
    (ours,) = tsmpl.smpl_bodies([npz], tm)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=VERT_TOL)


def test_visualize_smpl_main_renders_equal(bodies, in_tmp, monkeypatch):
    from uuo_mocap_tpu.eval.comparisons import load_smpl_npz, smpl_forward_zeroed_hands

    jm, _ = bodies
    gt, verts = _seq(jm, RENDER_FRAMES, seed=5)
    npz = _write_npz(in_tmp / "a_stageii.npz", gt, RENDER_FRAMES)
    ref = np.asarray(smpl_forward_zeroed_hands(jm, load_smpl_npz(npz))["vertices"])
    monkeypatch.setattr(tsmpl, "smpl_bodies", lambda files, model: [ref for _ in files])
    c3d = str(in_tmp / "m.c3d")
    write_c3d(c3d, verts[:, ::700] + 0.02, rate=30.0, units="m")
    common = ["--input_files", npz, "--markers", c3d, "--part_colors",
              "--body_models", str(in_tmp / "none")]
    jsmpl.main(common + ["--video", str(in_tmp / "j")])
    tsmpl.main(common + ["--video", str(in_tmp / "t"), "--cpu_only"])
    _same_tree(str(in_tmp / "t"), str(in_tmp / "j"))


# --------------------------------------------------------- visualize_markers

def test_visualize_markers_matches_jax(bodies, in_tmp):
    jm, _ = bodies
    _, verts = _seq(jm, 6, seed=6)
    c3d = str(in_tmp / "m.c3d")
    write_c3d(c3d, verts[:, ::400] + 0.01, rate=30.0, units="m")
    flags = ["--shuffle", "--id_markers", "--drop", "2", "--rigid_colors", "--max_frames", "6"]
    pts, labels, _ = tmarkers.prepare_points(c3d, True, True, 2, True, 6)
    assert pts.shape == (6, verts[:, ::400].shape[1], 3) and labels is not None
    for name, main in (("j", jmarkers.main), ("t", tmarkers.main)):
        main(["--input", c3d, "--video", str(in_tmp / name)] + flags)
    _same_tree(str(in_tmp / "t"), str(in_tmp / "j"))


# --------------------------------------------------------- visualize_dataset

def _stand_in_amass(root, rng):
    """A seeded stand-in for an AMASS tree (the processed schema)."""
    for sub, subject, F in (("ACCAD", "s1", 40), ("KIT", "s2", 25)):
        d = os.path.join(root, sub, subject)
        os.makedirs(d)
        np.savez(os.path.join(d, "seq.npz"), poses=(rng.randn(F, 156) * 0.2).astype(np.float32),
                 trans=rng.randn(F, 3).astype(np.float32) * 0.1,
                 betas=rng.randn(16).astype(np.float32), mocap_frame_rate=30.0)
    return str(root)


@pytest.mark.parametrize("structured", [True, False])
def test_visualize_dataset_matches_jax(bodies, in_tmp, capped_renders, monkeypatch, structured):
    jm, tm = bodies
    amass = _stand_in_amass(in_tmp / "amass", np.random.RandomState(8))
    flags = ["--amass_dir", amass, "--index", "1", "--num_markers", "12", "--frames", "4"]
    flags += ["--structured"] if structured else []
    verts, markers, labels = tdataset.dataset_sample(tm, amass, 1, 12, 4, structured)
    # the reference's arrays, as its main builds them
    from uuo_mocap_tpu.data.amass import DatasetMocap as JaxDatasetMocap

    ds = JaxDatasetMocap(jm, amass_dir=amass, sequence_length=4, num_markers=12)
    params = ds._load_params(1)
    if structured:
        from uuo_mocap_tpu.data.markers_synthetic import MarkersSyntheticStructured

        mk = MarkersSyntheticStructured(jm, num_frames=4, seed=1)
        ref_markers, ref_labels, params = mk.get_points(), np.asarray(mk.marker_labels), mk.gt_params
    else:
        sample = ds.compute_markers(params)
        ref_markers, ref_labels = sample["markers"], sample["marker_labels"]
    F = params.trans.shape[0]
    ref_verts = np.asarray(jax_lbs_forward(jm, params.pose_body,
                                           jnp.broadcast_to(params.betas, (F, 10)),
                                           params.root_orient, params.trans)["vertices"])
    np.testing.assert_allclose(verts, ref_verts, rtol=0, atol=VERT_TOL)
    np.testing.assert_allclose(markers, np.asarray(ref_markers), rtol=0, atol=VERT_TOL)
    np.testing.assert_array_equal(labels, np.asarray(ref_labels))
    monkeypatch.setattr(tdataset, "dataset_sample", lambda *a, **k: (
        ref_verts, np.asarray(ref_markers), np.asarray(ref_labels)))
    jdataset.main(flags + ["--video", str(in_tmp / "j")])
    tdataset.main(flags + ["--video", str(in_tmp / "t"), "--cpu_only"])
    _same_tree(str(in_tmp / "t"), str(in_tmp / "j"))


# ------------------------------------------------------ visualize_iterations

def _journal(jm, path, F=3):
    """A journal in the schema both packages write: stage records with
    parameters and scores, and per-segment snapshots of two lanes."""
    def params(seed, lanes=None):
        gt = random_pose_sequence(F, seed=seed)
        p = {"pose_body": np.asarray(gt.pose_body), "betas": np.asarray(gt.betas),
             "root_orient": np.asarray(gt.root_orient), "trans": np.asarray(gt.trans)}
        return p if lanes is None else {k: np.stack([v] * lanes) for k, v in p.items()}

    entries = {
        "chamfer": [{"t": 0.5, "params": params(11), "scores": np.array([0.3, 0.1, 0.2])}],
        "marker__segments": [
            {"t": 1.0, "lanes": np.array([0, 1]), "iters": np.array([4, 4]),
             "params": params(12, 2)},
            {"t": 2.0, "lanes": np.array([1, 0]), "iters": np.array([8, 8]),
             "params": params(13, 2)},
            {"t": 3.0, "lanes": np.array([1]), "iters": np.array([9]), "params": params(14, 1)}],
        "marker__curve": [{"iteration": 1, "loss": 0.5}],
    }
    with open(path, "wb") as f:
        pickle.dump(entries, f)
    return entries


def _jax_replay(jm, entries, lane):
    """The reference CLI's snapshots, posed by its ``lbs_forward``."""
    out = []
    for stage, records in entries.items():
        for ri, rec in enumerate(records):
            params = rec.get("params")
            if params is None:
                continue
            if "lanes" in rec:
                pos = np.where(np.asarray(rec["lanes"]) == lane)[0]
                if pos.size == 0:
                    continue
                params = {k: np.asarray(v)[int(pos[0])] for k, v in params.items()}
            F = params["pose_body"].shape[0]
            verts = jax_lbs_forward(jm, jnp.asarray(params["pose_body"]),
                                    jnp.broadcast_to(jnp.asarray(params["betas"]), (F, 10)),
                                    jnp.asarray(params["root_orient"]),
                                    jnp.asarray(params["trans"]))["vertices"]
            out.append((rec.get("t", 0.0), stage, ri, np.asarray(verts)))
    return sorted(out, key=lambda e: e[:3])


def test_visualize_iterations_matches_jax(bodies, in_tmp, monkeypatch):
    jm, tm = bodies
    path = str(in_tmp / "journal.pkl")
    entries = _journal(jm, path)
    replay = titerations.replay_vertices(entries, tm, lane=0)
    ref = _jax_replay(jm, entries, 0)
    assert [(t, s, ri) for t, s, ri, _ in replay] == [(t, s, ri) for t, s, ri, _ in ref] == [
        (0.5, "chamfer", 0), (1.0, "marker__segments", 0), (2.0, "marker__segments", 1)]
    for ours, want in zip(replay, ref):
        np.testing.assert_allclose(ours[3], want[3], rtol=0, atol=VERT_TOL)
    monkeypatch.setattr(titerations, "replay_vertices", lambda e, m, lane: ref)
    common = ["--journal", path, "--frame", "1", "--gif", "--body_models", str(in_tmp / "none")]
    jiterations.main(common + ["--out_dir", str(in_tmp / "j")])
    titerations.main(common + ["--out_dir", str(in_tmp / "t"), "--cpu_only"])
    assert len(_same_tree(str(in_tmp / "t"), str(in_tmp / "j"))) == 4  # 3 stills + scores
    _same_tree(str(in_tmp / "t"), str(in_tmp / "j"), "*.gif")


# ----------------------------------------------------- visualize_reprojection

REPROJ = dict(frames=6, num_angles=2, num_iters=5, seed=3)


def _jax_reprojection(jm, scale, frames, num_angles, num_iters, seed):
    """The reference CLI's stage call (``visualize_reprojection.main``) on
    markers scaled by ``scale``."""
    from uuo_mocap_tpu.data.config import default_config_dir, load_config
    from uuo_mocap_tpu.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params
    from uuo_mocap_tpu.ops.geometry import get_marker_mask
    from uuo_mocap_tpu.pipeline.reprojection import ReprojectionStage

    cfg = load_config(os.path.join(os.path.dirname(default_config_dir()), "configs",
                                   "video_mocap.yaml"))
    cfg["stages"]["reprojection_part"].update(num_iters=num_iters, num_angles=num_angles)
    F = frames
    gt = random_pose_sequence(F, seed=seed)
    points = generate_markers(jm, gt, num_markers=30, seed=seed + 1).points * np.float32(scale)
    img = ImgSmpl.from_params(perturb_params(gt, seed=seed + 2))
    img.camera_bbox = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (F, 1))
    img.center = np.tile(np.array([320.0, 240.0], np.float32), (F, 1))
    img.scale = np.full((F, 1), 200.0, np.float32)
    img.size = np.tile(np.array([480.0, 640.0], np.float32), (F, 1))
    angles = jnp.asarray(np.arange(num_angles) * 2 * np.pi / num_angles, jnp.float32)
    out = ReprojectionStage(jm, cfg, "reprojection_part")(
        angles, points, get_marker_mask(points), jnp.asarray(img.pose_body),
        jnp.asarray(img.betas[:1]), jnp.asarray(img.betas), jnp.asarray(img.hmr_root_orient),
        jnp.asarray(img.trans), jnp.asarray(img.camera_bbox), jnp.asarray(img.center),
        jnp.asarray(img.size), jnp.asarray(img.scale), jnp.ones(F))
    host = {k: np.asarray(v) for k, v in out.items() if k != "metrics"}
    host["metrics"] = {k: np.asarray(v) for k, v in out["metrics"].items()}
    return host, np.asarray(angles)


@pytest.fixture(scope="module")
def reprojection_runs(bodies):
    jm, tm = bodies
    ref, angles = _jax_reprojection(jm, 1.0, **REPROJ)
    moved, _ = _jax_reprojection(jm, 1 + 1e-6, **REPROJ)
    ours, t_angles = treproj.run_reprojection(tm, **REPROJ)
    return ref, moved, ours, angles, t_angles


def test_visualize_reprojection_stage_matches_jax(reprojection_runs):
    """The CLI's device half under ``test_torch_reprojection.py``'s rule."""
    ref, moved, ours, angles, t_angles = reprojection_runs
    np.testing.assert_allclose(t_angles, angles, rtol=0, atol=1e-7)
    for key in ("reproject", "chamfer"):
        o, r, m = ours["metrics"][key], ref["metrics"][key], moved["metrics"][key]
        assert np.all(np.abs(o - r) <= np.maximum(1e-4 * np.abs(r), 2.0 * np.abs(m - r))), key
    for k in ("joints_2d", "trans", "root_orient"):
        for a in range(len(angles)):
            tol = max(PARAM_ATOL, 2.0 * float(np.abs(moved[k][a] - ref[k][a]).max()))
            np.testing.assert_allclose(ours[k][a], ref[k][a], atol=tol, rtol=0, err_msg=k)
    # the targets project the prior's joints: float32 rounding of its forward
    gt_2d = ref["joints_2d_gt"]
    np.testing.assert_allclose(ours["joints_2d_gt"], gt_2d, rtol=0,
                               atol=1e-6 * float(np.abs(gt_2d).max()))


def test_visualize_reprojection_plots_equal(reprojection_runs, tmp_path):
    """Both packages' plots of the same (the reference's) arrays."""
    ref, _, _, angles, _ = reprojection_runs
    j = jreproj.plot_reprojection_overlays(str(tmp_path / "j"), ref, angles)
    t = treproj.plot_reprojection_overlays(str(tmp_path / "t"), ref, angles)
    assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j]
    for a, b in zip(t, j):
        _same_image(a, b)


# ----------------------------------------------------- visualize_segmentation

SEG_FLAGS = ["--num_markers", "12", "--frames", "4", "--seed", "2"]


def _jax_predictions(jm, checkpoints, multimodal):
    """The reference CLI's labels on ``checkpoints`` (its main prints only
    the accuracy): the same load and forward."""
    import jax

    from uuo_mocap_tpu.models import train as T
    from uuo_mocap_tpu.models.checkpoints import load_params
    from uuo_mocap_tpu.models.marker_segmenter import MarkerSegmenter
    from uuo_mocap_tpu.models.marker_segmenter_multimodal import MarkerSegmenterMultimodal

    name = "marker_segmenter_multimodal" if multimodal else "marker_segmenter"
    net = MarkerSegmenterMultimodal() if multimodal else MarkerSegmenter()
    pts0, _, jts0 = T._segmentation_batch(jm, 1, 12, seed=9999)
    template = (net.init(jax.random.PRNGKey(0), pts0, jts0) if multimodal
                else net.init(jax.random.PRNGKey(0), pts0))
    params = load_params(template, checkpoints, name)
    F = 4
    gt = random_pose_sequence(F, seed=2)
    out = jax_lbs_forward(jm, gt.pose_body, jnp.broadcast_to(gt.betas, (F, 10)), gt.root_orient,
                          gt.trans)
    vid = np.random.RandomState(2).choice(jm.num_vertices, 12, replace=False)
    markers = np.asarray(out["vertices"][:, vid])
    probs = (net.forward_sequence(params, jnp.asarray(markers), out["joints"][:, :22])
             if multimodal else net.forward_sequence(params, jnp.asarray(markers)))
    return markers, np.asarray(jnp.argmax(probs, axis=-1))


def _run_segmentation(jm, in_tmp, checkpoints, extra, capsys, monkeypatch):
    """Both mains; the port's host half on the reference's markers and
    labels."""
    multimodal = "--multimodal" in extra
    markers, pred = _jax_predictions(jm, checkpoints, multimodal)
    true_labels = np.asarray(jnp.argmax(jm.lbs_weights, axis=-1))[
        np.random.RandomState(2).choice(jm.num_vertices, 12, replace=False)]
    monkeypatch.setattr(tseg, "predict_parts", lambda *a, **k: (markers, pred, true_labels))
    paths = {}
    for name, main in (("j", jseg.main), ("t", tseg.main)):
        flags = SEG_FLAGS + extra + ["--checkpoints", checkpoints, "--video", str(in_tmp / name),
                                     "--confusion", str(in_tmp / f"{name}_cm.png")]
        main(flags + (["--cpu_only"] if name == "t" else []))
        paths[name] = capsys.readouterr().out
    assert [ln for ln in paths["t"].splitlines() if "accuracy" in ln] == \
        [ln for ln in paths["j"].splitlines() if "accuracy" in ln]
    _same_image(str(in_tmp / "t_cm.png"), str(in_tmp / "j_cm.png"))
    _same_tree(str(in_tmp / "t"), str(in_tmp / "j"))


@pytest.mark.parametrize("multimodal", [False, True])
def test_visualize_segmentation_on_the_shipped_checkpoint(bodies, in_tmp, capped_renders, capsys,
                                                          monkeypatch, multimodal):
    jm, tm = bodies
    extra = ["--multimodal"] if multimodal else []
    net, hist = tseg.load_or_train(tm, CHECKPOINTS, multimodal)
    assert hist is None
    markers, pred, _ = tseg.predict_parts(tm, net, multimodal, 12, 4, 2)
    ref_markers, ref_pred = _jax_predictions(jm, CHECKPOINTS, multimodal)
    np.testing.assert_allclose(markers, ref_markers, rtol=0, atol=VERT_TOL)
    np.testing.assert_array_equal(pred, ref_pred)
    _run_segmentation(jm, in_tmp, CHECKPOINTS, extra, capsys, monkeypatch)


def test_visualize_segmentation_trains_when_no_checkpoint(bodies, in_tmp, capped_renders, capsys,
                                                          monkeypatch):
    """``--train_steps 2`` into an empty directory: the port trains and
    writes a flax-layout checkpoint, which both packages then read."""
    jm, _ = bodies
    ckpt = str(in_tmp / "ckpt")
    out = tseg.main(SEG_FLAGS + ["--checkpoints", ckpt, "--train_steps", "2", "--cpu_only",
                                 "--video", str(in_tmp / "first")])
    assert "trained marker_segmenter" in capsys.readouterr().out
    assert os.path.exists(os.path.join(ckpt, "marker_segmenter.msgpack")) or glob.glob(
        os.path.join(ckpt, "marker_segmenter*"))
    _, ref_pred = _jax_predictions(jm, ckpt, False)
    np.testing.assert_array_equal(out["pred"], ref_pred)
    _run_segmentation(jm, in_tmp, ckpt, [], capsys, monkeypatch)


# ------------------------------------------------------------ visualize_model

# The demo pads the frames to the 64-frame bucket, and the reference's part
# scores count padded frames (ROADMAP C.4, not copied), so the part fit is
# off here as in tests/test_torch_cli.py; tests/test_torch_batch_solver.py
# and tests/test_torch_pipeline.py hold it.
MODEL_CONFIG = """parent: configs/video_mocap.yaml
find_best_part_fits: false
stages:
  part:
    num_iters: 5
  chamfer:
    num_iters: 5
  marker:
    num_iters: 5
"""


@pytest.fixture(scope="module")
def model_runs(bodies, tmp_path_factory):
    """Both packages' ``visualize_model.main`` on one exported sequence (24
    frames x 12 markers, a perturbed prior pkl; 5-iteration stages, no part
    fit: ``MODEL_CONFIG``), and the reference on its
    markers scaled by 1 + 1e-6 when a difference needs it."""
    from uuo_mocap_tpu.data.markers import Markers as JaxMarkers
    from uuo_mocap_tpu.pipeline import multimodal as jmm

    root = tmp_path_factory.mktemp("vis_model")
    jax_export.main(["--input_dir", str(root / "data"), "--dataset", "ds", "--subjects", "s1",
                     "--sequences", "a", "--num_markers", "12", "--num_frames", "24",
                     "--seed", "5"])
    # the demo reads <dataset>/mocap/<subject>/<sequence>.c3d
    (mocap,) = glob.glob(str(root / "data" / "ds" / "mocap_synthetic___*"))
    shutil.copytree(mocap, str(root / "data" / "ds" / "mocap"))
    config = root / "small.yaml"
    config.write_text(MODEL_CONFIG.replace("configs/", os.path.join(REPO, "configs") + "/"))
    argv = ["--config", str(config), "--dataset", "ds", "--input_dir", str(root / "data"),
            "--subject", "s1", "--sequence", "a", "--show_hmr", "--cull_parts", "0", "3", "6",
            "--body_models", str(root / "none")]
    captured = {}
    real = jmm.multimodal_video_mocap

    def record(img_smpl, markers, *args, **kw):
        out = real(img_smpl, markers, *args, **kw)
        captured.update(result=out, points=np.asarray(markers.get_points()), img=img_smpl)
        return out

    cwd = os.getcwd()
    os.chdir(root)
    try:
        with _patched(jmm, "multimodal_video_mocap", record), _capped():
            jmodel.main(argv + ["--video", str(root / "j")])
            ours = tmodel.main(argv + ["--video", str(root / "t"), "--cpu_only"])
    finally:
        os.chdir(cwd)

    def moved():
        path = str(root / "data" / "ds" / "mocap" / "s1" / "a.c3d")
        mk = JaxMarkers(path)
        mk.set_points(np.nan_to_num(mk.get_points(), nan=0.0) * np.float32(1 + 1e-6))
        from uuo_mocap_tpu.data.config import load_config

        return real(captured["img"], mk, load_config(str(config)), bodies[0], offset=0,
                    save_stages=True)

    return root, captured, ours, moved


@contextlib.contextmanager
def _patched(mod, name, value):
    old = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, old)


@contextlib.contextmanager
def _capped():
    """Both packages' renderers draw at most RENDER_FRAMES frames."""
    with contextlib.ExitStack() as stack:
        for mod in (jrenderer, trenderer):
            cls = mod.VideoMocapRenderer

            class Capped(cls):
                def __init__(self, scene, fn, num_frames, *args, **kw):
                    super().__init__(scene, fn, min(num_frames, RENDER_FRAMES), *args, **kw)

            stack.enter_context(_patched(mod, "VideoMocapRenderer", Capped))
        yield


def test_visualize_model_solve_matches_jax(bodies, model_runs):
    jm, _ = bodies
    root, captured, ours, moved = model_runs
    ref, res = captured["result"], ours["result"]
    assert set(res) - {"stage_times_s"} == set(ref) - {"stage_times_s"}
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert np.asarray(res[k]).shape == v.shape, k
    # the rigid groups: the same partition (the port numbers them by their
    # lowest marker, the reference as scikit-learn does)
    pairs = np.unique(np.stack([np.ravel(res["markers_labels"]),
                                np.ravel(ref["markers_labels"])]), axis=1)
    assert len(set(pairs[0])) == len(set(pairs[1])) == pairs.shape[1]
    cache = []
    for k in ("trans", "pose_body", "root_orient", "betas"):
        o, r = np.asarray(res[k]), np.asarray(ref[k])
        assert np.isfinite(o).all(), k
        diff = float(np.abs(o - r).max())
        if diff > PARAM_ATOL:
            if not cache:
                cache.append(moved())
            assert diff <= 2.0 * float(np.abs(np.asarray(cache[0][k]) - r).max()), (k, diff)
    np.testing.assert_array_equal(ours["points"], captured["points"])
    F = ref["trans"].shape[0]
    ref_verts = np.asarray(jax_lbs_forward(jm, jnp.asarray(res["pose_body"]),
                                           jnp.asarray(res["betas"]),
                                           jnp.asarray(res["root_orient"]),
                                           jnp.asarray(res["trans"]))["vertices"])
    np.testing.assert_allclose(ours["verts"], ref_verts, rtol=0, atol=VERT_TOL)
    img = captured["img"]
    hmr = np.asarray(jax_lbs_forward(jm, jnp.asarray(img.pose_body[:F]),
                                     jnp.asarray(np.broadcast_to(img.betas[:1], (F, 10))),
                                     jnp.asarray(img.root_orient[:F]),
                                     jnp.asarray(img.trans[:F]))["vertices"])
    np.testing.assert_allclose(ours["hmr_verts"], hmr, rtol=0, atol=VERT_TOL)


def test_visualize_model_render_matches_jax(bodies, model_runs, in_tmp):
    """The port's host half on the reference's arrays, against the
    reference CLI's render."""
    jm, tm = bodies
    root, captured, ours, _ = model_runs
    ref = captured["result"]
    F = ref["trans"].shape[0]
    img = captured["img"]

    def jverts(pose, betas, root_orient, trans):
        return np.asarray(jax_lbs_forward(jm, jnp.asarray(pose), jnp.asarray(betas),
                                          jnp.asarray(root_orient), jnp.asarray(trans))["vertices"])

    solved = {"result": ref, "points": captured["points"], "freq": ours["freq"],
              "verts": jverts(ref["pose_body"], ref["betas"], ref["root_orient"], ref["trans"]),
              "hmr_verts": jverts(img.pose_body[:F], np.broadcast_to(img.betas[:1], (F, 10)),
                                  img.root_orient[:F], img.trans[:F])}
    with _capped():
        tmodel.render_solution(tm, solved, str(in_tmp / "t"), [0, 3, 6])
    _same_tree(str(in_tmp / "t"), str(root / "j"))


# ------------------------------------------------------------------- paper

def _stats_tree(root, rng):
    """Per-part stats in the comparisons harness's layout: a csv per
    (side, group) and a yaml per part, as ``save_stats`` writes them."""
    from uuo_mocap_tpu_torch.eval.comparisons import save_stats

    for side in ("left", "right"):
        for group in ("arm", "leg", "shoulder"):
            n = 3 if side == "left" else 2  # ragged sides
            per_seq = {f"seq{i}": {m: float(rng.rand() * 50) for m in ("m2s", "mpjpe", "mpjve")}
                       for i in range(n)}
            stats = {m: {"mean": float(np.mean([v[m] for v in per_seq.values()])),
                         "std": 1.0, "median": 2.0} for m in ("m2s", "mpjpe", "mpjve")}
            save_stats(stats, per_seq, os.path.join(root, "ds", f"{side}_{group}"), "video_mocap")
    return str(root)


@pytest.mark.parametrize("figure", ["part_errors", "part_metrics", "part_errors_plot"])
def test_paper_part_figures_equal(tmp_path, figure):
    stats_root = _stats_tree(tmp_path / "stats", np.random.RandomState(9))
    if figure == "part_errors_plot":
        rng = np.random.RandomState(10)
        stats = {m: {f"{p}__mpjpe": {"mean": float(rng.rand())} for p in ("hips", "spine")}
                 for m in ("a", "b")}
        for name, mod in (("j", jpaper), ("t", tpaper)):
            mod.plot_part_errors(str(tmp_path / f"{name}.png"), stats, parts=["hips", "spine"])
        _same_image(str(tmp_path / "t.png"), str(tmp_path / "j.png"))
        return
    argv = [figure, "--stats_root", stats_root, "--dataset", "ds"]
    jpaper.main(argv + ["--out_dir", str(tmp_path / "j")])
    tpaper.main(argv + ["--out_dir", str(tmp_path / "t")])
    assert len(_same_tree(str(tmp_path / "t"), str(tmp_path / "j"))) >= 1


def test_paper_confusion_matrix_matches_jax(bodies, tmp_path, monkeypatch):
    """The labels and the count matrix equal the reference's.  The
    reference hands the count matrix to ``plot_confusion_matrix``, which
    takes the label vectors (it raises ``TypeError``): its plot is held
    from the same labels, drawn by its own plotting function."""
    from uuo_mocap_tpu.vis import plots as jplots

    seen = {}

    def record(path, cm, *args):
        seen["cm"] = np.asarray(cm)
        raise TypeError("plot_confusion_matrix() missing 1 required positional argument")

    monkeypatch.setattr(jplots, "plot_confusion_matrix", record)
    kw = dict(checkpoint_root=CHECKPOINTS, num_sequences=2, frames=4, markers=8, seed=1)
    with pytest.raises(TypeError):
        jpaper.segmentation_confusion_matrix(str(tmp_path / "j.png"), **kw)
    monkeypatch.undo()
    y_true, y_pred, cm = tpaper.segmentation_labels(device="cpu", **kw)
    np.testing.assert_array_equal(cm, seen["cm"])
    out = tpaper.main(["confusion_matrix", "--out", str(tmp_path / "t.png"), "--checkpoints",
                       CHECKPOINTS, "--cpu_only"])
    assert out == str(tmp_path / "t.png")
    tpaper.segmentation_confusion_matrix(str(tmp_path / "t.png"), device="cpu", **kw)
    jplots.plot_confusion_matrix(str(tmp_path / "j.png"), y_true, y_pred, cm.shape[0])
    _same_image(str(tmp_path / "t.png"), str(tmp_path / "j.png"))


def test_paper_crops_equal(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(12)
    qual = tmp_path / "qual"
    for method, sub in (("moshpp", ("s1", "seq")), ("video_mocap", ("s1", "arm", "seq"))):
        d = qual.joinpath(method, *sub)
        d.mkdir(parents=True)
        Image.fromarray((rng.rand(40, 60, 3) * 255).astype(np.uint8)).save(d / "00000003.png")
    outs = {}
    for name, mod in (("j", jpaper), ("t", tpaper)):
        outs[name] = mod.main(["crop", "--qual_root", str(qual), "--out_root",
                               str(tmp_path / name), "--dataset", "ds", "--subject", "s1",
                               "--sequence", "seq", "--methods", "moshpp", "video_mocap",
                               "hmr", "--frame", "3", "--scale", "0.5", "--part", "arm"])
        outs[name + "_plain"] = mod.crop_results(
            [str(qual / "moshpp" / "s1" / "seq" / "00000003.png")],
            str(tmp_path / f"{name}_plain"), (5, 4, 30, 33))
    assert outs["j"] is None  # the reference's main prints, returns nothing
    _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    _same_tree(str(tmp_path / "t_plain"), str(tmp_path / "j_plain"))


def test_paper_stills_match_jax(bodies, in_tmp, monkeypatch):
    jm, tm = bodies
    gt, ref_verts = _seq(jm, 2, seed=14)
    npz = _write_npz(in_tmp / "a_stageii.npz", gt, 2)
    np.testing.assert_allclose(tpaper.stills_vertices(npz, tm), ref_verts, rtol=0, atol=VERT_TOL)
    monkeypatch.setattr(tpaper, "stills_vertices", lambda path, model: ref_verts)
    argv = ["stills", "--npz", npz, "--frames", "1", "--body_models", str(in_tmp / "none")]
    jpaper.main(argv + ["--out_dir", str(in_tmp / "j")])
    written = tpaper.main(argv + ["--out_dir", str(in_tmp / "t"), "--cpu_only"])
    assert len(written) == 2
    _same_tree(str(in_tmp / "t"), str(in_tmp / "j"))
    shutil.rmtree(in_tmp / "j")
