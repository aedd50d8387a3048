"""Pieces of the port's multi-sequence solve on the CPU: the lane forms of the
losses, the frame-summed distances and the stage closures against a per-lane
loop of their single-sequence forms; ``upsample_frames`` against the JAX
function; the tournament's ``pick_survivors``; the streaming L-BFGS and its
``last_run_stats``; the batch solver's helpers and its device rule.

Inputs are made with numpy from seeds.  A lane form and the loop over lanes
run the same float32 operations on the same numbers, so they are held to
1e-6 relative (the order of a sum over lanes may differ)."""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uuo_mocap_tpu.ops.geometry import upsample_frames as jax_upsample_frames
from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
from uuo_mocap_tpu_torch.data.config import load_config
from uuo_mocap_tpu_torch.ops import chamfer as tchamfer
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.ops.geometry import upsample_frames
from uuo_mocap_tpu_torch.parallel.batch_solver import (
    MultiSequenceSolver, chunked_lanes, upsample_lane_params)
from uuo_mocap_tpu_torch.pipeline.part_fit import PartFitter, pick_survivors
from uuo_mocap_tpu_torch.pipeline.stages import MarkerAttachment, SmplParams, SolveStages
from uuo_mocap_tpu_torch.solver import losses as L
from uuo_mocap_tpu_torch.solver.lbfgs import BatchedLbfgs, LbfgsOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "video_mocap.yaml")
RNG = np.random.RandomState(57)
REL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _rotations(*shape):
    return rot.axis_angle_to_matrix(_t(0.3 * RNG.randn(*shape, 3)))


@pytest.fixture(scope="module")
def model():
    return synthetic_body_model(device="cpu")


@pytest.mark.parametrize("Fs, F_full, stride", [(5, 9, 2), (5, 10, 2), (4, 12, 3), (3, 3, 1)])
def test_upsample_frames_matches_jax(Fs, F_full, stride):
    x = RNG.randn(3, Fs, 2, 3).astype(np.float32)
    ref = np.asarray(jax_upsample_frames(jnp.asarray(x), F_full, stride))
    np.testing.assert_allclose(upsample_frames(_t(x), F_full, stride).numpy(), ref,
                               rtol=0, atol=1e-6)


def test_upsample_lane_params_keeps_betas_shared():
    Ln, Fs, F = 2, 4, 8
    p = SmplParams(_rotations(Ln, Fs, 23), _t(RNG.randn(Ln, 1, 10)), _rotations(Ln, Fs, 1),
                   _t(RNG.randn(Ln, Fs, 3)))
    up = upsample_lane_params(p, F, 2)
    assert up.betas.shape == (Ln, 1, 10) and torch.equal(up.betas, p.betas)
    assert up.trans.shape == (Ln, F, 3) and up.pose_body.shape == (Ln, F, 23, 3, 3)
    torch.testing.assert_close(up.trans[:, ::2], p.trans)
    eye = torch.eye(3).expand(Ln, F, 1, 3, 3)
    torch.testing.assert_close(up.root_orient @ up.root_orient.transpose(-1, -2), eye,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("scores, orig, keep, expected", [
    ([3.0, 1.0, 2.0, 0.5], [0, 1, 2, 3], 2, [1, 3]),
    # lanes 0 and 1 are copies of subtree 0 (padding): keep one of them
    ([1.0, 1.0, 2.0, 3.0], [0, 0, 1, 2], 2, [0, 2]),
    # equal scores keep the stable order
    ([2.0, 1.0, 1.0, 5.0], [0, 1, 2, 3], 2, [1, 2]),
    # fewer distinct subtrees than keep: pad with the best duplicates
    ([4.0, 3.0, 3.0, 4.0], [0, 0, 0, 0], 2, [1, 2]),
    ([2.0, 1.0], [0, 1], 1, [1]),
])
def test_pick_survivors(scores, orig, keep, expected):
    got = pick_survivors(np.asarray(scores), np.asarray(orig), keep)
    np.testing.assert_array_equal(got, expected)


def _lane_masks(Ln, F):
    fv = np.ones((Ln, F), np.float32)
    fv[0, F - 3:] = 0.0  # lane 0: a padded sequence
    fv[1, ::4] = 0.0
    return _t(fv)


def test_losses_lane_masks_match_a_loop_over_lanes():
    Ln, F, M = 3, 9, 5
    fv = _lane_masks(Ln, F)
    trans, markers = _t(RNG.randn(Ln, F, 3)), _t(RNG.randn(Ln, F, M, 3))
    z_root, root = _rotations(Ln, F, 1), _rotations(Ln, F, 1)
    pose = _rotations(Ln, F, 23)
    cases = [
        (L.trans_vel_loss, (trans, markers)),
        (L.root_orient_vel_loss, (z_root, root)),
        (L.temporal_loss, (pose,)),
    ]
    for fn, args in cases:
        lanes = fn(*args, fv)
        loop = torch.cat([fn(*(a[l:l + 1] for a in args), fv[l]) for l in range(Ln)])
        assert lanes.shape == (Ln,)
        torch.testing.assert_close(lanes, loop, rtol=REL, atol=0, msg=fn.__name__)


def test_frame_summed_distances_lane_form_matches_a_loop():
    Ln, F, M, V = 3, 7, 6, 300
    markers, verts = _t(RNG.randn(Ln, F, M, 3)), _t(RNG.randn(Ln, F, V, 3))
    mask = _t((RNG.rand(Ln, F) > 0.3).astype(np.float32))
    ids = tchamfer.mean_nearest_vertex_over_frames(markers, verts, mask)
    assert ids.shape == (Ln, M)
    for l in range(Ln):
        np.testing.assert_array_equal(
            ids[l].numpy(), tchamfer.mean_nearest_vertex_over_frames(markers[l], verts[l], mask[l]).numpy())
        torch.testing.assert_close(tchamfer.summed_frame_distances(markers, verts, mask)[l],
                                   tchamfer.summed_frame_distances(markers[l], verts[l], mask[l]),
                                   rtol=REL, atol=0)


def _with_losses(stage, extra):
    cfg = load_config(CONFIG)
    cfg["stages"][stage]["losses"].update(extra)
    return cfg


def _stage_data(model, Ln, F, M):
    """Per-lane sequences: markers near the body, priors, masks."""
    pose, root = _rotations(Ln, F, 23), _rotations(Ln, F, 1)
    with torch.no_grad():
        from uuo_mocap_tpu_torch.body.model import lbs_forward

        verts = lbs_forward(model, pose, torch.zeros(Ln, 1, 10), root,
                            _t(0.1 * RNG.randn(Ln, F, 3)))["vertices"]
    ids = torch.as_tensor(RNG.randint(0, model.num_vertices, size=M))
    markers = verts[:, :, ids] + _t(0.01 * RNG.randn(Ln, F, M, 3))
    markers[0, 1, 2] = 0.0  # one occluded marker
    return dict(markers=markers, weights=(markers.abs().sum(-1) != 0).float(),
                o_pose_body=pose, o_betas=_t(0.1 * RNG.randn(Ln, 1, 10)), root_orient0=root,
                frame_valid=_lane_masks(Ln, F))


def _closure_per_lane(fun, params, lane, Ln):
    """The closure on every lane at once and on each lane alone, the lane's
    sequence given as shared data (the single-sequence form)."""
    lanes = fun(params, lane, {})
    shared_keys = [k for k in lane if k not in ("root_orient0", "att_ids", "att_w",
                                                "vertex_mask")]
    loop = torch.cat([fun({k: v[l:l + 1] for k, v in params.items()},
                          {k: v[l:l + 1] for k, v in lane.items() if k not in shared_keys},
                          {k: lane[k][l] for k in shared_keys}) for l in range(Ln)])
    return lanes, loop


@pytest.mark.parametrize("stage", ["chamfer", "marker", "part"])
def test_stage_closures_lane_data_match_a_loop(model, stage):
    Ln, F, M = 3, 6, 8
    d = _stage_data(model, Ln, F, M)
    p6 = rot.matrix_to_rotation_6d
    if stage == "chamfer":
        fun = SolveStages(model, _with_losses("chamfer", {"trans_vel": 1.0, "root_orient_vel": 1.0})
                          )._chamfer_solver.fun
        params = {"trans": _t(0.1 * RNG.randn(Ln, F, 3)), "z": _t(0.1 * RNG.randn(Ln, F, 1, 1)),
                  "betas": d["o_betas"], "pose6d": p6(d["o_pose_body"])}
        lane = {k: d[k] for k in ("root_orient0", "markers", "weights", "o_pose_body", "o_betas",
                                  "frame_valid")}
    elif stage == "marker":
        fun = SolveStages(model, _with_losses("marker", {"temporal": 1.0}))._marker_solver.fun
        params = {"pose6d": p6(d["o_pose_body"]), "betas": d["o_betas"],
                  "root6d": p6(d["root_orient0"]), "trans": _t(0.1 * RNG.randn(Ln, F, 3))}
        w = _t(RNG.rand(Ln, M, 3))
        lane = {"att_ids": torch.as_tensor(RNG.randint(0, 6890, size=(Ln, M, 3))),
                "att_w": w / w.sum(-1, keepdim=True),
                **{k: d[k] for k in ("markers", "weights", "o_pose_body", "o_betas", "frame_valid")}}
    else:
        fun = PartFitter(model, load_config(CONFIG))._solver.fun
        masks = np.zeros((Ln, model.num_vertices), np.float32)
        masks[:, :4000] = 1.0
        masks[1, 2000:] = 1.0
        params = {"z": _t(0.2 * RNG.randn(Ln, 1, 1, 1)), "trans": _t(0.1 * RNG.randn(Ln, F, 3)),
                  "betas": d["o_betas"]}
        lane = {"vertex_mask": _t(masks), "marker_weights": d["weights"],
                **{k: d[k] for k in ("markers", "o_pose_body", "o_betas", "root_orient0")}}
    lanes, loop = _closure_per_lane(fun, params, lane, Ln)
    assert lanes.shape == (Ln,)
    torch.testing.assert_close(lanes, loop, rtol=1e-5, atol=0)


def test_nearest_points_and_scores_lane_form_match_a_loop(model):
    Ln, F, M = 2, 5, 7
    stages = SolveStages(model, load_config(CONFIG))
    d = _stage_data(model, Ln, F, M)
    params = SmplParams(d["o_pose_body"], d["o_betas"], d["root_orient0"], _t(0.05 * RNG.randn(Ln, F, 3)))
    img = _lane_masks(Ln, F)
    att = stages.nearest_points_lanes_nolabel(d["markers"], params, img)
    scores = stages.score_chamfer_lanes(d["markers"], d["weights"], params)
    for l in range(Ln):
        p_l = SmplParams(*(t[l] for t in params))
        a_l = stages.nearest_points(d["markers"][l], p_l, img[l])
        np.testing.assert_array_equal(att.vertex_ids[l].numpy(), a_l.vertex_ids.numpy())
        s_l = stages.score_chamfer_batched(d["markers"][l], d["weights"][l],
                                           SmplParams(*(t[None] for t in p_l)))
        torch.testing.assert_close(scores[l:l + 1], s_l, rtol=REL, atol=0)


def test_chunked_lanes_equals_one_call(model):
    Ln, F = 5, 3
    p = SmplParams(_rotations(Ln, F, 23), _t(RNG.randn(Ln, 1, 10)), _rotations(Ln, F, 1),
                   _t(RNG.randn(Ln, F, 3)))
    x = _t(RNG.randn(Ln, 4))

    def fn(a, params):
        return MarkerAttachment(a * 2.0, params.trans.sum(1))

    whole, chunked = fn(x, p), chunked_lanes(fn, 2, x, p)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


# -------------------------------------------------------- streaming L-BFGS


def _quad(p, lane, shared):
    r = p["x"] - lane["target"]
    return (r * (lane["diag"] * r)).sum(-1) + 0.01 * (p["x"] ** 4).sum(-1)


def _quad_problem(Ln, n=6):
    rng = np.random.RandomState(3)
    lane = {"target": _t(rng.randn(Ln, n)), "diag": _t(0.5 + 10.0 * rng.rand(Ln, n))}
    return {"x": _t(0.5 * rng.randn(Ln, n))}, lane


def test_width_rule():
    s = BatchedLbfgs(_quad, LbfgsOptions(), max_width=16, pad_width=True)
    assert [s.width(L) for L in (1, 2, 3, 5, 8, 9, 16, 40)] == [1, 2, 4, 8, 8, 16, 16, 16]
    s.pad_width = False
    assert [s.width(L) for L in (3, 16, 40)] == [3, 16, 16]
    assert BatchedLbfgs(_quad, LbfgsOptions()).width(40) == 40


def test_streaming_stats_and_results():
    """Seven lanes through a working set of 2: every lane ends as the
    unstreamed solve leaves it, and the accounting holds together."""
    params0, lane = _quad_problem(7)
    opts = LbfgsOptions(max_iter=30)
    base = BatchedLbfgs(_quad, opts)
    p_b, r_b = base.run(params0, lane, {})
    streamed = BatchedLbfgs(_quad, opts, max_width=2)
    p_s, r_s = streamed.run(params0, lane, {})
    st = streamed.last_run_stats
    assert st["width"] == 2 and st["lanes"] == 7 and st["refills"] >= 6
    assert st["lane_evals"] == int(r_s.num_evals.sum())
    assert st["device_evals"] >= st["lane_evals"]
    assert st["ride_along_evals"] == st["device_evals"] - st["lane_evals"]
    assert base.last_run_stats["refills"] == 0 and base.last_run_stats["width"] == 7
    torch.testing.assert_close(p_s["x"], p_b["x"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(r_s.num_iters.numpy(), r_b.num_iters.numpy())


def test_iteration_caps_compose():
    """``warmup_iter_cap`` caps the lanes below the caller's ``iter_cap``."""
    params0, lane = _quad_problem(5)
    s = BatchedLbfgs(_quad, LbfgsOptions(max_iter=30), max_width=2)
    s.iter_cap, s.warmup_iter_cap = 4, 2
    _, res = s.run(params0, lane, {})
    assert int(res.num_iters.max()) == 2


# ------------------------------------------------------------ batch solver


def test_batch_solver_device_rule_and_unported_options(model):
    cfg = load_config(CONFIG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MultiSequenceSolver(model, cfg)
    with pytest.raises(NotImplementedError):
        MultiSequenceSolver(model, cfg, mesh=object(), device="cpu")
    solver = MultiSequenceSolver(model, copy.deepcopy(cfg), device="cpu")
    assert solver.stages._chamfer_solver.max_width == 16
    cfg_sdf = copy.deepcopy(cfg)
    cfg_sdf["stages"]["marker"]["use_sdf"] = True
    with pytest.raises(NotImplementedError):
        MultiSequenceSolver(model, cfg_sdf, device="cpu").solve_prepared([])


def test_prepare_sequence_padding_matches_jax():
    """Padded shapes for a batch: frames 12 -> 16, markers 16 -> 20."""
    from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
    from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
    from uuo_mocap_tpu.pipeline.multimodal import prepare_sequence as jax_prepare_sequence
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
    from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence

    F, M = 12, 16
    prior = SmplParams(_rotations(F, 23).numpy(), RNG.randn(1, 10).astype(np.float32),
                       _rotations(F, 1).numpy(), RNG.randn(F, 3).astype(np.float32))
    markers = RNG.randn(F, M, 3).astype(np.float32)
    markers[3, 4] = np.nan  # an occluded marker
    kw = dict(pad_to_frames=16, pad_to_markers=20)
    ref = jax_prepare_sequence(JaxImgSmpl.from_params(prior), JaxArrayMarkers(markers.copy()), **kw)
    ours = prepare_sequence(ImgSmpl.from_params(prior), ArrayMarkers(markers.copy()), **kw)
    assert (ours.F, ours.F_real, ours.M_real, ours.has_camera) == (16, F, M, False)
    assert (ref.F, ref.F_real, ref.M_real, ref.has_camera) == (ours.F, ours.F_real, ours.M_real,
                                                               ours.has_camera)
    for k in ("markers", "img_mask", "frame_valid", "o_trans", "o_root_orient", "o_pose_body",
              "o_foot_contacts", "o_betas"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k), err_msg=k)


def test_batch_solve_padded_shapes(model):
    """Sequences of different lengths and marker counts batch through the
    padded shapes and come back at their own sizes."""
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
    from uuo_mocap_tpu_torch.data.synthetic import (
        generate_markers, perturb_params, random_pose_sequence)
    from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence

    cfg = load_config(CONFIG)
    cfg["num_root_orient_angles"] = 2
    cfg["find_best_part_fits"] = False
    for stage in ("chamfer", "marker"):
        cfg["stages"][stage]["num_iters"] = 10
    shapes = [(12, 16), (16, 20)]
    preps = []
    for q, (F, M) in enumerate(shapes):
        gt = random_pose_sequence(F, seed=400 + q, device="cpu")
        mk = generate_markers(model, gt, num_markers=M, seed=500 + q)
        prior = perturb_params(gt, seed=600 + q, pose_noise=0.03)
        preps.append(prepare_sequence(ImgSmpl.from_params(prior), ArrayMarkers(mk.points.numpy()),
                                      pad_to_frames=16, pad_to_markers=20))
    out = MultiSequenceSolver(model, cfg, device="cpu").solve_prepared(preps, save_stages=True)
    assert out["scores"].shape == (2, 2)
    for q, (F, M) in enumerate(shapes):
        r = out["results"][q]
        assert r["trans"].shape == (F, 3) and r["pose_body"].shape == (F, 23, 3, 3)
        assert r["markers_labels"].shape == (F, M) and r["betas"].shape == (F, 10)
        assert set(r["stages"]) == {"chamfer", "marker", "marker_final"}
        assert r["stages"]["chamfer"]["trans"].shape == (F, 3)
        assert np.isfinite(r["trans"]).all()
        assert r["best_hypothesis"] == int(out["best_hypothesis"][q])
