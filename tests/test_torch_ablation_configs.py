"""The shipped ablation configs (``configs/hmr_full.yaml``: the part fit on
the full 24-joint skeleton with the later stages off; ``hmr_part.yaml``:
the part fit alone; ``mht_rotation.yaml``: one yaw hypothesis) through the
port against the JAX package on the CPU.

Size and tolerances are those of ``tests/test_torch_pipeline.py``'s
whole-slice test: ``multimodal_video_mocap`` at F = 24 frames, M = 12
markers with 5-iteration stages; the same keys, stages, chain and marker
labels; parameters within 1e-2.

Their batch solves are not run: with them the tier-1 run came within 140 s
of its limit (their JAX programs take minutes to trace and compile there).
The shipped configuration's batch solve is held by
``tests/test_torch_batch_solver.py``; these configs change only the part
fit's subtree set (hmr_full), the stages that run (hmr_full, hmr_part) and
the number of yaw hypotheses (mht_rotation).
"""
import copy
import os

import numpy as np
import pytest

from test_torch_batch_solver import PARAM_ATOL, models  # noqa: F401  (models: a fixture)
from uuo_mocap_tpu.data.config import load_config as jax_load_config
from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params, random_pose_sequence
from uuo_mocap_tpu.pipeline import multimodal as jmm
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.pipeline import multimodal as tmm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["hmr_full", "hmr_part", "mht_rotation"]
PARAMS = ("trans", "pose_body", "root_orient", "betas")


def load(name, iters):
    cfg = jax_load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    for stage in ("part", "chamfer", "marker"):
        if cfg["stages"][stage]["num_iters"] > 0:
            cfg["stages"][stage]["num_iters"] = iters
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_ablation_config_single_sequence_matches_jax(models, name):
    jm, tm = models
    F, M = 24, 12
    gt = random_pose_sequence(F, seed=3, yaw=0.9, travel=0.3)
    markers = np.array(generate_markers(jm, gt, num_markers=M, seed=4, occlusion_rate=0.05).points)
    prior = perturb_params(gt, seed=5, pose_noise=0.05, trans_noise=0.08, betas_noise=0.2)
    prior = type(prior)(*(np.asarray(a) for a in prior))
    ref = jmm.multimodal_video_mocap(JaxImgSmpl.from_params(prior), JaxArrayMarkers(markers.copy()),
                                     load(name, 5), jm, save_stages=True, frame_bucket=None)
    ours = tmm.multimodal_video_mocap(ImgSmpl.from_params(prior), ArrayMarkers(markers.copy()),
                                      copy.deepcopy(load(name, 5)), tm, save_stages=True,
                                      frame_bucket=None, device="cpu")
    assert set(ours) - {"stage_times_s"} == set(ref) - {"stage_times_s"}
    assert set(ours["stages"]) == set(ref["stages"])
    np.testing.assert_array_equal(ours["chain"], ref["chain"])
    np.testing.assert_array_equal(ours["markers_labels"], ref["markers_labels"])
    for d_o, d_r, what in [(ours, ref, "output")] + [
            (ours["stages"][s], ref["stages"][s], s) for s in ref["stages"]]:
        for k in PARAMS:
            assert d_o[k].shape == d_r[k].shape and np.isfinite(d_o[k]).all(), (what, k)
            np.testing.assert_allclose(d_o[k], d_r[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name} {what} {k}")
