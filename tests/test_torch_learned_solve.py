"""The whole learned slice against the JAX package on the CPU:
``multimodal_video_mocap`` with ``part.mode: network`` and
``marker.use_sdf: true`` on the shipped checkpoints, at F = 24 frames and
M = 12 markers with 5-iteration stages (the size of
``test_torch_ablation_configs.py``).  Tolerances, as in
``test_torch_batch_solver.py``: the same keys, stages, chain and marker
labels; parameters within 1e-2, or within twice what the reference itself
moves when its markers are scaled by 1 + 1e-6 (that solve runs only when a
difference passes 1e-2).  The pieces are held in
``test_torch_learned_modes.py`` and ``test_torch_models.py``.
"""
import copy

import numpy as np

from test_torch_learned_modes import learned_config, models, sequence  # noqa: F401  (a fixture)
from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
from uuo_mocap_tpu.pipeline import multimodal as jmm
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.pipeline import multimodal as tmm

PARAM_ATOL = 1e-2
PARAMS = ("trans", "pose_body", "root_orient", "betas")


def test_network_sdf_solve_matches_jax(models):
    """Both packages' single-sequence solve with both learned modes on."""
    jm, tm = models
    gt, mk, prior = sequence(jm, 24, 12, seed=3)
    cfg = learned_config()

    def ref_solve(scale):
        return jmm.multimodal_video_mocap(JaxImgSmpl.from_params(prior),
                                          JaxArrayMarkers(mk * np.float32(scale)), cfg, jm,
                                          save_stages=True, frame_bucket=None)

    ref = ref_solve(1.0)
    ours = tmm.multimodal_video_mocap(ImgSmpl.from_params(prior), ArrayMarkers(mk.copy()),
                                      copy.deepcopy(cfg), tm, save_stages=True,
                                      frame_bucket=None, device="cpu")
    assert set(ours) - {"stage_times_s"} == set(ref) - {"stage_times_s"}
    assert set(ours["stages"]) == set(ref["stages"])
    np.testing.assert_array_equal(ours["chain"], ref["chain"])
    np.testing.assert_array_equal(ours["markers_labels"], ref["markers_labels"])
    moved = None
    for what in ["output"] + sorted(ref["stages"]):
        d_o, d_r = (ours, ref) if what == "output" else (ours["stages"][what], ref["stages"][what])
        for k in PARAMS:
            assert d_o[k].shape == d_r[k].shape and np.isfinite(d_o[k]).all(), (what, k)
            diff = float(np.abs(d_o[k] - d_r[k]).max())
            if diff <= PARAM_ATOL:
                continue
            if moved is None:  # the reference's own move under a 1e-6 scaling
                moved = ref_solve(1 + 1e-6)
            d_m = moved if what == "output" else moved["stages"][what]
            assert diff <= 2.0 * float(np.abs(d_m[k] - d_r[k]).max()), (what, k, diff)
