"""Network-mode segmentation and the SDF marker stage: the port against the
JAX package on the CPU, on the shipped checkpoints.

Inputs are made with the JAX package's generators from numpy seeds and
handed to both packages as numpy.  Tolerances:
  * segmentation: labels equal except at counted near-ties (top-2 softmax
    margin <= 1e-4); the mode, the left/right merge and the chains equal on
    fixed label arrays, ties included;
  * the SDF closure's value within 1e-5 relative and its gradient within
    1e-4 relative in norm; the virtual points' seeds within 1e-6; the lanes
    form equal to the single-sequence form lane by lane.
The whole slice against the JAX package is ``test_torch_learned_solve.py``.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.data.config import load_config as jax_load_config
from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params, random_pose_sequence
from uuo_mocap_tpu.models.checkpoints import load_params as jax_load_params
from uuo_mocap_tpu.models.marker_segmenter_multimodal import MarkerSegmenterMultimodal
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu.pipeline import multimodal as jmm
from uuo_mocap_tpu.pipeline import segmentation as jseg
from uuo_mocap_tpu.pipeline.stages import MarkerAttachment as JaxAttachment
from uuo_mocap_tpu.pipeline.stages import SolveStages as JaxSolveStages
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.ops import rotations as trot
from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
from uuo_mocap_tpu_torch.pipeline import multimodal as tmm
from uuo_mocap_tpu_torch.pipeline import segmentation as tseg
from uuo_mocap_tpu_torch.pipeline.stages import MarkerAttachment, SmplParams, SolveStages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
CONFIG = os.path.join(REPO, "configs", "video_mocap.yaml")
MARGIN = 1e-4
RNG = np.random.RandomState(61)


@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


def learned_config(iters=5):
    """The shipped config with network-mode segmentation, SDF markers and
    ``iters`` iterations per stage."""
    cfg = jax_load_config(CONFIG)
    cfg["checkpoints_dir"] = CKPT
    cfg["stages"]["part"]["mode"] = "network"
    cfg["stages"]["marker"]["use_sdf"] = True
    for stage in ("part", "chamfer", "marker"):
        cfg["stages"][stage]["num_iters"] = iters
    return cfg


def sequence(jm, F, M, seed, occlusion=0.05):
    """(ground truth, markers [F, M, 3], prior) as numpy from seeds."""
    gt = random_pose_sequence(F, seed=seed, yaw=0.9, travel=0.3)
    mk = np.array(generate_markers(jm, gt, num_markers=M, seed=seed + 1,
                                   occlusion_rate=occlusion).points)
    prior = perturb_params(gt, seed=seed + 2, pose_noise=0.05, trans_noise=0.08, betas_noise=0.2)
    return gt, mk, type(prior)(*(np.asarray(a) for a in prior))


def prior_joints(jm, prior):
    """The prior's 22 joints [F, 22, 3] from the JAX forward."""
    forward = jax.jit(lambda *a: jmm._forward(jm, jmm.SmplParams(*a))["joints"][:, :22])
    return np.asarray(forward(*(jnp.asarray(a) for a in prior)))


@pytest.mark.parametrize("with_joints", [True, False])
def test_segment_markers_network_matches_jax(models, with_joints):
    """A 70 x 41 sequence (a partial last window): the multimodal net with
    the prior's joints, the marker-only net without."""
    jm, _ = models
    _, mk, prior = sequence(jm, 70, 41, seed=71)
    joints = prior_joints(jm, prior) if with_joints else None
    ref = jseg.segment_markers_network(mk, 30.0, checkpoint_root=CKPT, joints=joints)
    ours = tseg.segment_markers_network(mk, 30.0, checkpoint_root=CKPT, joints=joints,
                                        device="cpu")
    assert ours.shape == ref.shape == (70, 41)
    differ = ours != np.asarray(ref)
    ties = 0
    if differ.any():  # only at near-ties of the reference's probabilities
        net = MarkerSegmenterMultimodal()
        params = jax_load_params(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 41, 3)),
                                          jnp.zeros((1, 32, 22, 3))), CKPT,
                                 "marker_segmenter_multimodal")
        assert with_joints, "the marker-only net disagrees"
        probs = np.asarray(net.forward_sequence(params, jnp.asarray(mk), jnp.asarray(joints)))
        top2 = np.sort(probs, axis=-1)[..., -2:]
        ties = int((top2[..., 1] - top2[..., 0] <= MARGIN).sum())
        assert (top2[..., 1] - top2[..., 0])[differ].max() <= MARGIN
    print(f"joints={with_joints}: {int(differ.sum())} labels differ, {ties} near-ties")


def test_missing_segmenter_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tseg.segment_markers_network(np.zeros((40, 10, 3), np.float32), 30.0,
                                     checkpoint_root=str(tmp_path), device="cpu")


def test_label_helpers_match_jax(models):
    """labels_mode, merge_symmetric_labels and chains_from_labels on fixed
    arrays: random labels, columns with tied counts, right-side labels, and
    chains tied on their part count."""
    jm, tm = models
    labels = RNG.randint(0, 24, size=(9, 30))
    labels[:, 0] = [1, 1, 2, 2, 5, 5, 7, 7, 0]  # a four-way tie
    labels[:, 1] = [20, 21] * 4 + [21]
    np.testing.assert_array_equal(tseg.labels_mode(labels), jseg.labels_mode(labels))
    cases = [tseg.labels_mode(labels), np.array([2, 5, 8, 11, 14, 17, 19, 21, 23, 0]),
             np.array([15, 20, 21, 22, 23, 12]), np.array([7, 8, 10, 11, 18, 19, 3])]
    parents = np.asarray(jm.parents)
    np.testing.assert_array_equal(np.asarray(tm.parents), parents)
    for case in cases:
        merged = tseg.merge_symmetric_labels(case)
        np.testing.assert_array_equal(merged, jseg.merge_symmetric_labels(case))
        assert tseg.chains_from_labels(merged, parents) == jseg.chains_from_labels(merged, parents)


def test_network_segmentation_ignores_frame_bucket_padding(models):
    """``cli.test`` pads every sequence to its 64-frame bucket with frames
    of zero markers.  The reference's segmenter reads them, which changes
    the labels of the real frames that share a window with them and can
    change the per-marker mode and the chain (ROADMAP C.9); the port
    segments the real frames only, so the padded sequence gives the
    unpadded labels, and an unpadded sequence the reference's.  The CLI
    data's layout: 41 random-vertex markers, no occlusion; 70 frames padded
    to 128."""
    jm, tm = models
    _, mk, prior = sequence(jm, 70, 41, seed=81, occlusion=0.0)
    preps = {b: tmm.prepare_sequence(ImgSmpl.from_params(prior), ArrayMarkers(mk.copy()),
                                     frame_bucket=b) for b in (64, None)}
    assert preps[64].F == 128 and preps[None].F == 70
    (lp, mp, cp), (lu, mu, cu) = (tmm.network_segmentation(tm, preps[b], CKPT) for b in (64, None))
    assert lp.shape == (128, 41) and lu.shape == (70, 41)
    np.testing.assert_array_equal(lp[:70], lu)
    np.testing.assert_array_equal(mp, mu)
    assert cp == cu
    np.testing.assert_array_equal(tmm._mode_per_column(lp), tmm._mode_per_column(lu))
    # the reference's way on the same two inputs
    ref = {}
    for b in (64, None):
        jp = jmm.prepare_sequence(JaxImgSmpl.from_params(prior), JaxArrayMarkers(mk.copy()),
                                  frame_bucket=b)
        joints = prior_joints(jm, (jp.o_pose_body, jp.o_betas, jp.o_root_orient, jp.o_trans))
        ref[b] = jseg.segment_markers_network(jp.markers, jp.mocap_freq, checkpoint_root=CKPT,
                                              joints=joints)
    np.testing.assert_array_equal(lu, ref[None])
    assert (ref[64][:70] != ref[None]).any()  # the padding changes the reference's labels


def _sdf_inputs(jm, F=6, M=12, A=2):
    """A sequence, its prior as the body parameters (A lanes, perturbed),
    and attachments on random faces' corners."""
    _, mk, prior = sequence(jm, F, M, seed=91)
    d6 = lambda R: np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(R)))  # noqa: E731
    lanes = {"pose6d": np.stack([d6(prior.pose_body) + 0.01 * a for a in range(A)]),
             "betas": np.stack([prior.betas] * A),
             "root6d": np.stack([d6(prior.root_orient)] * A),
             "trans": np.stack([prior.trans + 0.01 * RNG.randn(F, 3).astype(np.float32)
                                for _ in range(A)])}
    faces = np.asarray(jm.faces)[RNG.randint(0, len(jm.faces), size=(A, M))]
    w = RNG.rand(A, M, 3).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    faces[0, 0] = faces[0, 0, :1]  # a vertex attachment: (v, v, v), weights (1, 0, 0)
    w[0, 0] = (1.0, 0.0, 0.0)
    return mk, prior, lanes, faces.astype(np.int64), w


def test_sdf_closure_and_seeds_match_jax(models):
    """The closure's value and gradient at one point (lane 0: the seeded
    virtual points moved by 1 cm), and the seeds of every lane."""
    jm, tm = models
    cfg = learned_config()
    mk, prior, lanes, ids, w = _sdf_inputs(jm)
    jst, tst = JaxSolveStages(jm, cfg), SolveStages(tm, copy.deepcopy(cfg))
    seeds_r = np.asarray(jst._seed_virtual(JaxAttachment(jnp.asarray(ids, jnp.int32),
                                                         jnp.asarray(w))))
    att = MarkerAttachment(torch.as_tensor(ids), torch.as_tensor(w))
    seeds = tst._seed_virtual(att).numpy()
    np.testing.assert_allclose(seeds, seeds_r, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(att.to_one_hot(6890)[0].numpy(),
                                  np.asarray(JaxAttachment(jnp.asarray(ids[0]), jnp.asarray(w[0]))
                                             .to_one_hot(6890)))
    params = {k: v[0] for k, v in lanes.items()}
    params["virtual_points"] = seeds_r[0] + 0.01 * RNG.randn(*seeds_r[0].shape).astype(np.float32)
    weights = (np.abs(mk).sum(-1) != 0).astype(np.float32)
    shared = {"markers": mk, "weights": weights, "o_pose_body": prior.pose_body,
              "o_betas": prior.betas}
    f_r, g_r = jax.jit(jax.value_and_grad(lambda p: jst._marker_solver_sdf.fun(
        p, {}, {k: jnp.asarray(v) for k, v in shared.items()})))(
        {k: jnp.asarray(v) for k, v in params.items()})
    p_t = {k: torch.as_tensor(v)[None].requires_grad_(True) for k, v in params.items()}
    f = tst._marker_solver_sdf.fun(p_t, {}, {k: torch.as_tensor(v) for k, v in shared.items()})
    f.sum().backward()
    np.testing.assert_allclose(f.item(), float(f_r), rtol=1e-5)
    for k, g in g_r.items():
        g, g_t = np.asarray(g), p_t[k].grad[0].numpy()
        assert np.linalg.norm(g_t - g) <= 1e-4 * np.linalg.norm(g), k


def test_sdf_lanes_equal_single_sequence_stage(models):
    """The port's ``marker_stage_sdf_lanes`` (data per lane) lands where its
    ``marker_stage_sdf`` (data shared by the lanes) does, lane by lane."""
    jm, tm = models
    cfg = learned_config()
    mk, prior, lanes, ids, w = _sdf_inputs(jm)
    st = SolveStages(tm, copy.deepcopy(cfg))
    A, F = lanes["trans"].shape[:2]

    def rot6(x):
        return trot.rotation_6d_to_matrix(torch.as_tensor(x))

    params = SmplParams(rot6(lanes["pose6d"]), torch.as_tensor(lanes["betas"]),
                        rot6(lanes["root6d"]), torch.as_tensor(lanes["trans"]))
    att = MarkerAttachment(torch.as_tensor(ids), torch.as_tensor(w))
    markers = torch.as_tensor(mk)
    weights = (markers.abs().sum(-1) != 0).float()
    o_pose, o_betas = torch.as_tensor(prior.pose_body), torch.as_tensor(prior.betas)
    single, res_s = st.marker_stage_sdf(markers, weights, o_pose, o_betas, params, att)

    def tile(x):
        return x[None].expand((A,) + x.shape).contiguous()

    per_lane, res_l = st.marker_stage_sdf_lanes(tile(markers), tile(weights), tile(o_pose),
                                                tile(o_betas), params, att, torch.ones(A, F))
    for a, b in zip(single, per_lane):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(res_l.num_iters.numpy(), res_s.num_iters.numpy())


def test_batch_solve_with_network_mode_and_sdf(models):
    """The port's ``MultiSequenceSolver`` at 2 x 16 x 20 with both learned
    modes, 5 iterations per stage: finite outputs of the reference's shapes,
    and the part fit's marker weights masked to each sequence's largest
    chain of ``segment_markers_network`` -> ``chains_from_labels``."""
    jm, tm = models
    Q, F, M = 2, 16, 20
    seqs = [sequence(jm, F, M, seed=101 + 10 * q) for q in range(Q)]
    preps = [tmm.prepare_sequence(ImgSmpl.from_params(prior), ArrayMarkers(mk.copy()),
                                  frame_bucket=None) for _, mk, prior in seqs]
    cfg = copy.deepcopy(learned_config())
    cfg["parallel"] = {"lane_width": 16, "part_lane_width": 16, "pad_width": True,
                       "hypothesis_prune": {"enabled": True, "at_iters": [2, 4], "keep": [2, 1]},
                       "part_prune": {"enabled": True, "at_iters": 2, "keep": 2}}
    solver = MultiSequenceSolver(tm, cfg, device="cpu")
    seen = {}
    fit_batch = solver.part_fitter.fit_batch

    def capture(markers_b, weights_b, *args, **kw):
        seen["weights"] = weights_b.clone()
        return fit_batch(markers_b, weights_b, *args, **kw)

    solver.part_fitter.fit_batch = capture
    out = solver.solve_prepared(preps, save_stages=True)
    assert {"segment_network", "part_fit", "marker", "marker_final"} <= set(out["stage_times_s"])
    for q, (r, (_, mk, prior)) in enumerate(zip(out["results"], seqs)):
        shapes = {"trans": (F, 3), "root_orient": (F, 1, 3, 3), "pose_body": (F, 23, 3, 3),
                  "betas": (F, 10), "markers_labels": (F, M)}
        for k, shp in shapes.items():
            assert r[k].shape == shp and np.isfinite(r[k]).all(), (q, k)
        assert set(r["stages"]) == {"part", "chamfer", "marker", "marker_final"}
        joints = prior_joints(jm, prior)
        labels = tseg.segment_markers_network(mk, 30.0, checkpoint_root=CKPT, joints=joints,
                                              device="cpu")
        merged = tseg.merge_symmetric_labels(tmm._mode_per_column(labels))
        largest = tseg.chains_from_labels(merged, np.asarray(tm.parents))[0]
        expected = np.isin(merged, largest).astype(np.float32)
        np.testing.assert_array_equal(seen["weights"][q].numpy(),
                                      np.broadcast_to(expected, (F, M)))
    assert out["eval_stats"]["marker"]["lanes"] == Q

