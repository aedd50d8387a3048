"""The reprojection stage and the camera streams of ``prepare_sequence``:
the port against the JAX package on the CPU.

Size: ``tests/test_parity_fillers.py``'s reprojection test, F = 10 frames,
M = 20 markers (V = 6890), 2 yaw seeds, 10 iterations, with
``tests/test_batch_reprojection_network.py``'s camera streams (centre
(320, 240), scale 200, size (480, 640) in every frame) but the crop camera
(0.04, 0, 0) where those tests use (1, 0, 0): the depth is 2 x 5000 / (s x
51200 crop pixels), 4.9 m here and 0.2 m there.  At 0.2 m the reference's
objective is so steep that its metrics move by up to 1.7x under a 1e-6
marker scaling (``tools/reprojection_seed_check.py``): no parity bound
holds on it.

The seeds are 0 and pi/2, where the reference is stable: under the markers
scaled by 1 + 1e-6 its metrics move by at most 2.4e-5 relative and its
outputs by at most 8.2e-5 (``tools/reprojection_seed_check.py``).  The
parity fillers' pi is not used: there the reference's reprojection error
moves from 0.077 to 0.015 under that scaling, so a bound derived from the
move would pass anything.

Tolerances, each seed under its own: the same best seed under both
criteria; the metrics within 1e-4 relative, or within twice what the
reference itself moves under that scaling, and that bound under a tenth of
the metric; parameters under the batch solve's rule (within 1e-2, or within
twice the reference's own move); the lanes form equal to a lone run of each
lane, bit for bit; the camera streams equal.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_batch_solver import models  # noqa: F401  (a fixture)
from uuo_mocap_tpu.data.config import load_config as jax_load_config
from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params, random_pose_sequence
from uuo_mocap_tpu.ops.geometry import get_marker_mask as jax_marker_mask
from uuo_mocap_tpu.pipeline.multimodal import prepare_sequence as jax_prepare_sequence
from uuo_mocap_tpu.pipeline.reprojection import ReprojectionStage as JaxReprojectionStage
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.ops.geometry import get_marker_mask
from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence
from uuo_mocap_tpu_torch.pipeline.reprojection import ReprojectionStage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, M, ITERS = 10, 20, 10
ANGLES = np.array([0.0, np.pi / 2], np.float32)
PARAM_ATOL = 1e-2
CAMERA = {"camera_bbox": (0.04, 0.0, 0.0), "center": (320.0, 240.0), "scale": (200.0,),
          "size": (480.0, 640.0)}
OUTPUTS = ("betas", "root_orient", "trans")


def with_camera(img, frames):
    for name, value in CAMERA.items():
        setattr(img, name, np.tile(np.array(value, np.float32), (frames, 1)))
    return img


def config():
    cfg = jax_load_config(os.path.join(REPO, "configs", "video_mocap.yaml"))
    cfg["stages"]["reprojection_part"]["num_iters"] = ITERS
    return cfg


@pytest.fixture(scope="module")
def inputs(models):
    """The stage's numpy arguments, in call order but the angles."""
    gt = random_pose_sequence(F, seed=3)
    mk = np.array(generate_markers(models[0], gt, num_markers=M, seed=4).points)
    prior = perturb_params(gt, seed=5)
    img = with_camera(JaxImgSmpl.from_params(prior), F)
    return [mk, np.array(jax_marker_mask(jnp.asarray(mk)))] + [np.array(a, np.float32) for a in (
        img.pose_body, img.betas[:1], img.betas, img.hmr_root_orient, img.trans, img.camera_bbox,
        img.center, img.size, img.scale, np.ones(F))]


def _jax(stage, args, scale=1.0):
    args = [args[0] * np.float32(scale)] + args[1:]
    out = stage(jnp.asarray(ANGLES), *(jnp.asarray(a) for a in args))
    return {k: (np.asarray(v) if k != "metrics" else {m: np.asarray(x) for m, x in v.items()})
            for k, v in out.items()}


@pytest.fixture(scope="module")
def solves(models, inputs):
    """The reference's stage, the same on markers scaled by 1 + 1e-6 (one
    compiled program for both), and the port's."""
    stage = ReprojectionStage(models[1], copy.deepcopy(config()))
    ours = stage(torch.as_tensor(ANGLES), *(torch.as_tensor(a) for a in inputs))
    ref_stage = JaxReprojectionStage(models[0], config())
    return _jax(ref_stage, inputs), _jax(ref_stage, inputs, 1 + 1e-6), ours


def test_reprojection_picks_the_reference_seed(solves):
    ref, _, ours = solves
    for key in ("reproject", "chamfer"):
        assert int(np.argmin(ours["metrics"][key].numpy())) == int(np.argmin(ref["metrics"][key]))


def test_reprojection_metrics_match_jax(solves):
    ref, moved, ours = solves
    for key in ("reproject", "chamfer"):
        o, r, m = ours["metrics"][key].numpy(), ref["metrics"][key], moved["metrics"][key]
        bound = np.maximum(1e-4 * np.abs(r), 2.0 * np.abs(m - r))  # one per seed
        assert np.all(bound < 0.1 * np.abs(r)), (key, "a seed the reference is unstable on", r, m)
        assert np.all(np.abs(o - r) <= bound), (key, o, r, m)


def test_reprojection_matches_jax(solves):
    ref, moved, ours = solves
    assert set(ours) == set(ref)
    for k in set(ref) - {"metrics"}:
        assert tuple(ours[k].shape) == ref[k].shape, k
    for k in OUTPUTS + ("cam_trans", "output_angle", "joints_2d"):
        o, r = ours[k].numpy(), ref[k]
        assert np.isfinite(o).all(), k
        for a in range(len(ANGLES)):  # each seed under its own tolerance
            tol = max(PARAM_ATOL, 2.0 * float(np.abs(moved[k][a] - r[a]).max()))
            np.testing.assert_allclose(o[a], r[a], atol=tol, rtol=0, err_msg=f"{k}, seed {a}")
    for k in ("joints_2d_gt", "reproject_mask", "focal_length", "camera_center"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_reprojection_lanes_equal_lone_runs(models, inputs, solves):
    """Two sequences, one yaw seed each, through ``lanes``: each lane's
    outputs are those of the lane solved alone."""
    stage = ReprojectionStage(models[1], copy.deepcopy(config()))
    seq = [torch.as_tensor(a) for a in inputs]
    other = [seq[0] * 1.01] + seq[1:]  # the second sequence: markers moved
    angles = torch.as_tensor(ANGLES)
    lanes = stage.lanes(angles, *(torch.stack([a, b]) for a, b in zip(seq, other)))
    for i, args in enumerate((seq, other)):
        alone = stage.lanes(angles[i:i + 1], *(a[None] for a in args))
        for k in OUTPUTS + ("cam_trans", "output_angle"):
            torch.testing.assert_close(lanes[k][i:i + 1], alone[k], rtol=0, atol=0, msg=k)
        for k in ("reproject", "chamfer"):
            torch.testing.assert_close(lanes["metrics"][k][i:i + 1], alone["metrics"][k],
                                       rtol=0, atol=0)


def _preps(frames, pad_to, camera):
    gt = random_pose_sequence(frames, seed=7)
    prior = perturb_params(gt, seed=8)
    prior = type(prior)(*(np.asarray(a) for a in prior))
    mk = np.random.RandomState(9).randn(frames, 6, 3).astype(np.float32)
    jimg, timg = JaxImgSmpl.from_params(prior), ImgSmpl.from_params(prior)
    if camera:  # per-frame streams, so that the padding shows
        rng = np.random.RandomState(10)
        for name, value in CAMERA.items():
            stream = (np.asarray(value, np.float32) * (1 + rng.rand(frames, len(value)))
                      ).astype(np.float32)
            setattr(jimg, name, stream)
            setattr(timg, name, stream.copy())
    return (jax_prepare_sequence(jimg, JaxArrayMarkers(mk.copy()), frame_bucket=None,
                                 pad_to_frames=pad_to),
            prepare_sequence(timg, ArrayMarkers(mk.copy()), frame_bucket=None, pad_to_frames=pad_to))


CAMERA_FIELDS = ("hmr_betas", "hmr_root_orient", "camera_bbox", "cam_center", "cam_size",
                 "cam_scale")


@pytest.mark.parametrize("pad_to", [None, 16])
def test_prepare_sequence_camera_streams_match_jax(pad_to):
    ref, ours = _preps(12, pad_to, camera=True)
    assert ours.has_camera and ref.has_camera and ours.F == ref.F == (pad_to or 12)
    for name in CAMERA_FIELDS:
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), err_msg=name)
        assert getattr(ours, name).shape[0] == ours.F
    if pad_to:  # padded by repeating the last real frame
        np.testing.assert_array_equal(ours.cam_center[12:], np.repeat(ours.cam_center[11:12], 4, 0))


def test_prepare_sequence_without_camera_has_no_streams():
    ref, ours = _preps(12, None, camera=False)
    assert not ours.has_camera and not ref.has_camera
    for name in CAMERA_FIELDS:
        assert getattr(ours, name) is None and getattr(ref, name) is None, name
