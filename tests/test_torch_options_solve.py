"""The solve's opt-in options through the whole single-sequence solve: the
port's ``multimodal_video_mocap`` against the JAX package's on the CPU, with
the reprojection stages on (the prior carrying camera streams) and with the
ranking variants on.

Size and tolerances are those of ``tests/test_torch_ablation_configs.py``:
F = 24 frames, M = 12 markers (V = 6890) with 5-iteration stages; the same
keys, stages, chain and marker labels; parameters within 1e-2 in the output
and in every stage's snapshot.  The reprojection case runs both stages at 5
iterations over 4 yaw seeds, with ``tests/test_torch_reprojection.py``'s
camera streams (the crop camera (0.04, 0, 0), 4.9 m from the body).  The
ranking case turns on ``optimizer.rank_hier`` (the coarse-to-fine ranking
in the sparse chamfer stage).
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import copy

import numpy as np
import pytest

from test_torch_ablation_configs import PARAMS, load
from test_torch_batch_solver import PARAM_ATOL, models  # noqa: F401  (models: a fixture)
from test_torch_reprojection import CAMERA
from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params, random_pose_sequence
from uuo_mocap_tpu.pipeline import multimodal as jmm
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.pipeline import multimodal as tmm

F, M, ITERS = 24, 12, 5


def options(name):
    cfg = load("video_mocap", ITERS)
    if name == "reprojection":
        for key in ("reprojection_part", "reprojection_full"):
            cfg["stages"][key].update(num_iters=ITERS, num_angles=4)
    else:
        cfg["optimizer"]["rank_hier"] = True
    return cfg


def with_camera(img):
    for name, value in CAMERA.items():
        setattr(img, name, np.tile(np.array(value, np.float32), (F, 1)))
    return img


@pytest.mark.parametrize("name", ["reprojection", "rank_hier"])
def test_solve_with_option_matches_jax(models, name):
    jm, tm = models
    gt = random_pose_sequence(F, seed=3, yaw=0.9, travel=0.3)
    markers = np.array(generate_markers(jm, gt, num_markers=M, seed=4, occlusion_rate=0.05).points)
    prior = perturb_params(gt, seed=5, pose_noise=0.05, trans_noise=0.08, betas_noise=0.2)
    prior = type(prior)(*(np.asarray(a) for a in prior))
    jimg, timg = JaxImgSmpl.from_params(prior), ImgSmpl.from_params(prior)
    if name == "reprojection":
        jimg, timg = with_camera(jimg), with_camera(timg)
    ref = jmm.multimodal_video_mocap(jimg, JaxArrayMarkers(markers.copy()), options(name), jm,
                                     save_stages=True, frame_bucket=None)
    ours = tmm.multimodal_video_mocap(timg, ArrayMarkers(markers.copy()),
                                      copy.deepcopy(options(name)), tm, save_stages=True,
                                      frame_bucket=None, device="cpu")
    assert set(ours) - {"stage_times_s"} == set(ref) - {"stage_times_s"}
    assert set(ours["stages"]) == set(ref["stages"])
    if name == "reprojection":
        assert {"reprojection_part", "reprojection_full"} <= set(ours["stage_times_s"])
    np.testing.assert_array_equal(ours["chain"], ref["chain"])
    np.testing.assert_array_equal(ours["markers_labels"], ref["markers_labels"])
    for d_o, d_r, what in [(ours, ref, "output")] + [
            (ours["stages"][s], ref["stages"][s], s) for s in ref["stages"]]:
        for k in PARAMS:
            assert d_o[k].shape == d_r[k].shape and np.isfinite(d_o[k]).all(), (what, k)
            np.testing.assert_allclose(d_o[k], d_r[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name} {what} {k}")
