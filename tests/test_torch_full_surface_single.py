"""The ``full_surface`` configuration of ``chip_smoke.py`` through the port's
``multimodal_video_mocap`` on the CPU: every stage runs, the root stage's
snapshot is written and is the root stage's own result, the outputs have
the reference's keys and shapes and are finite.

Size: the first sequence of ``tests/test_torch_batch_solver.py``'s batch
(F = 16 frames, M = 20 markers, V = 6890), every stage capped at 5
iterations.  The reference's single-sequence solve is not run here: it
raises whenever the root stage runs (``int()`` of the root stage's [1]
evaluation count, ``uuo_mocap_tpu/pipeline/multimodal.py:506``, ROADMAP
C.8), and run with that count summed it cost minutes of the tier-1 time.
The pieces are held to the reference instead: the root stage
(``test_torch_root_stage.py``), the correspondences and the dense part fit
(``test_torch_stages_surface.py``), the whole configuration through the
batch solve (``test_torch_full_surface.py``).
"""
import numpy as np
import torch

from test_torch_batch_solver import batch, models  # noqa: F401  (fixtures)
from test_torch_full_surface import PARAMS, STAGES, fs_config
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.pipeline import multimodal as tmm
from uuo_mocap_tpu_torch.pipeline.stages import SolveStages


def test_full_surface_single_sequence_runs_every_stage(models, batch):
    tm = models[1]
    _, markers, prior = batch[0]
    F, M = markers.shape[:2]
    cfg = fs_config(False)
    for stage in ("root", "part", "chamfer", "marker"):
        cfg["stages"][stage]["num_iters"] = 5
    calls = []
    root_stage = SolveStages.root_stage

    def recording(self, *args, **kw):
        out = root_stage(self, *args, **kw)
        calls.append(out)
        return out

    SolveStages.root_stage = recording
    try:
        out = tmm.multimodal_video_mocap(
            ImgSmpl.from_params(prior), ArrayMarkers(markers.copy()), cfg, tm,
            save_stages=True, frame_bucket=None, device="cpu")
    finally:
        SolveStages.root_stage = root_stage
    assert set(out["stages"]) == STAGES and "root" in out["stage_times_s"]
    assert len(calls) == 1 and int(calls[0][1].num_iters[0]) > 0
    params = calls[0][0]
    root = out["stages"]["root"]
    np.testing.assert_array_equal(root["trans"], params.trans.numpy())
    np.testing.assert_array_equal(root["betas"], params.betas.numpy()[0])
    shapes = {"trans": (F, 3), "root_orient": (F, 1, 3, 3), "pose_body": (F, 23, 3, 3),
              "betas": (F, 10)}
    for k in PARAMS:
        assert out[k].shape == shapes[k] and np.isfinite(out[k]).all(), k
        for stage, sd in out["stages"].items():
            want = (10,) if k == "betas" else shapes[k]
            assert sd[k].shape == want and np.isfinite(sd[k]).all(), (stage, k)
    assert out["markers_labels"].shape == (F, M) and "chain" in out
    assert torch.isfinite(torch.as_tensor(out["trans"])).all()
