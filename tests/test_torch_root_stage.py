"""The port's root stage against the JAX package on the CPU: the closure
(value and gradient) in the three rotation modes and a short descent of the
lanes form in the shipped one, the single-sequence form held to the lanes
form in all three; the modes (one yaw per sequence, ``constrained_rotation``; a yaw
per frame, ``yaw_lock``; a free 6d rotation per frame) with all six loss
keys (``part_chamfer``, ``full_chamfer``, ``root_orient_vel``,
``trans_vel``, ``reg_betas``, ``ground``) and both chamfer directions.

Size: F = 12 frames, M = 16 markers (5 % occluded), V = 6890, marker
labels from the generating vertices' parts; descents of 10 iterations (3
where the single form is held to the lanes form only);
lanes: 2 sequences.  Inputs are made with the JAX package's generators from
numpy seeds.  Tolerances: closure values and gradients 1e-5 relative
(float32 sums in another order); descended parameters (trans, betas,
rotation-matrix entries) of the yaw_lock lanes form within 1e-2 or twice what the
reference itself moves when its markers are scaled by 1 + 1e-6, whichever
is larger (the batch solve's rule, ``tests/test_torch_batch_solver.py``;
the scaled solve runs only when a difference passes 1e-2); the port's
single-sequence form equal to its lanes form's first lane within 1e-5.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.data.config import load_config as jax_load_config
from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params, random_pose_sequence
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu.pipeline.stages import SolveStages as JaxSolveStages
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.pipeline.stages import SolveStages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "video_mocap.yaml")
F, M, ITERS = 12, 16, 10
REL, PARAM_ATOL = 1e-5, 1e-2
MODES = {"constrained": dict(constrained_rotation=True, yaw_lock=True),
         "yaw_lock": dict(constrained_rotation=False, yaw_lock=True),
         "free": dict(constrained_rotation=False, yaw_lock=False)}
LOSSES = {"part_chamfer": 10.0, "full_chamfer": 10.0, "root_orient_vel": 1.0, "trans_vel": 1.0,
          "reg_betas": 0.1, "ground": 1.0}


def config(mode, single_directional=False):
    cfg = jax_load_config(CONFIG)
    cfg["stages"]["root"].update(num_iters=ITERS, single_directional=single_directional,
                                 losses=dict(LOSSES), **MODES[mode])
    return cfg


@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


def make_sequence(jm, seed):
    gt = random_pose_sequence(F, seed=seed, yaw=0.9, travel=0.3)
    mk = generate_markers(jm, gt, num_markers=M, seed=seed + 1, occlusion_rate=0.05)
    prior = perturb_params(gt, seed=seed + 2, pose_noise=0.05, trans_noise=0.08, betas_noise=0.2)
    markers = np.array(mk.points)
    labels = np.asarray(jnp.argmax(jm.lbs_weights, axis=-1))[np.asarray(mk.vertex_ids)]
    return dict(markers=markers, weights=(np.abs(markers).sum(-1) != 0).astype(np.float32),
                pose=np.asarray(prior.pose_body), betas=np.asarray(prior.betas),
                root=np.asarray(prior.root_orient),
                trans=np.asarray(prior.trans) + np.float32(0.03),
                labels=labels.astype(np.int64), frame_valid=np.ones(F, np.float32))


@pytest.fixture(scope="module")
def sequences(models):
    return [make_sequence(models[0], seed) for seed in (21, 31)]


def _args(s, scale=1.0):
    """root_stage's arguments for one sequence (numpy)."""
    return [s["markers"] * np.float32(scale), s["weights"], s["pose"], s["betas"], s["root"],
            s["trans"], s["labels"], s["betas"]]


def _z(mode, rng):
    if mode == "constrained":
        return np.full((1, 1, 1), 0.15, np.float32)
    if mode == "yaw_lock":
        return (0.1 * rng.randn(F, 1, 1)).astype(np.float32)
    aa = (0.1 * rng.randn(F, 1, 3)).astype(np.float32)
    return np.asarray(jrot.matrix_to_rotation_6d(jrot.axis_angle_to_matrix(jnp.asarray(aa))))


@pytest.mark.parametrize("mode, single_directional",
                         [("constrained", False), ("yaw_lock", False), ("free", False),
                          ("yaw_lock", True)])
def test_root_closure_matches_jax(models, sequences, mode, single_directional):
    jm, tm = models
    s = sequences[0]
    rng = np.random.RandomState(7)
    params = {"trans": s["trans"], "z": _z(mode, rng),
              "betas": s["betas"] + (0.05 * rng.randn(1, 10)).astype(np.float32)}
    shared = {"markers": s["markers"], "weights": s["weights"], "o_pose_body": s["pose"],
              "o_betas": s["betas"], "marker_labels_mode": s["labels"],
              "frame_valid": s["frame_valid"]}
    lane = {"root_orient0": s["root"]}
    cfg = config(mode, single_directional)
    jfun = JaxSolveStages(jm, cfg)._root_solver.fun
    # the reference's closure is one lane's (its solver vmaps it)
    fj, gj = jax.value_and_grad(lambda p: jfun(
        p, {k: jnp.asarray(v) for k, v in lane.items()},
        {k: jnp.asarray(v) for k, v in shared.items()}))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tfun = SolveStages(tm, copy.deepcopy(cfg))._root_solver.fun
    p = {k: torch.as_tensor(v)[None].requires_grad_(True) for k, v in params.items()}
    ft = tfun(p, {k: torch.as_tensor(v)[None] for k, v in lane.items()},
              {k: torch.as_tensor(v) for k, v in shared.items()})
    assert ft.shape == (1,)
    ft.sum().backward()
    np.testing.assert_allclose(ft.item(), float(fj), rtol=REL)
    for k in params:
        g = np.asarray(gj[k])
        np.testing.assert_allclose(p[k].grad[0].numpy(), g, rtol=0, atol=REL * np.abs(g).max(),
                                   err_msg=k)


def _assert_within_rule(ours, ref, moved, what):
    """Every field within 1e-2, or within twice what the reference moves
    (``moved()``: its solve on scaled markers, run only when needed)."""
    for k, (o, r) in enumerate(zip(ours, ref)):
        o, r = np.asarray(o), np.asarray(r)
        assert o.shape == r.shape and np.isfinite(o).all(), (what, k)
        if float(np.abs(o - r).max()) > PARAM_ATOL:
            tol = max(PARAM_ATOL, 2.0 * float(np.abs(np.asarray(moved()[k]) - r).max()))
            np.testing.assert_allclose(o, r, atol=tol, rtol=0, err_msg=f"{what} field {k}")


def _numpy(params):
    return [t.detach().numpy() for t in params]


@pytest.mark.parametrize("mode", list(MODES))
def test_root_stage_matches_jax(models, sequences, mode):
    """Two sequences as lanes (``root_stage_lanes``) against the reference's
    lanes form (yaw_lock, the shipped mode; the other modes' closures are
    held above); one sequence (``root_stage``) against the port's lanes form
    of the same sequence, in every mode, to float32 noise (the same closure
    on one lane)."""
    jm, tm = models
    cfg = config(mode)
    if mode != "yaw_lock":  # the single form against the lanes form only
        cfg["stages"]["root"]["num_iters"] = 3
    iters = cfg["stages"]["root"]["num_iters"]
    tst = SolveStages(tm, copy.deepcopy(cfg))

    def lanes(scale=1.0):
        cols = list(zip(*(_args(q, scale) for q in sequences)))
        m, w, pose, betas, root, trans, labels, o_betas = (np.stack(c) for c in cols)
        fv = np.ones((len(sequences), F), np.float32)
        return [m, w, pose, o_betas, betas, root, trans, labels, fv]

    ours_l, res_t = tst.root_stage_lanes(*(torch.as_tensor(a) for a in lanes()))
    assert ours_l.root_orient.shape == (2, F, 1, 3, 3)
    assert np.isfinite(res_t.f.numpy()).all() and (res_t.num_iters.numpy() == iters).all()
    if mode == "yaw_lock":
        jst = JaxSolveStages(jm, cfg)
        ref_l, res_j = jst.root_stage_lanes(*(jnp.asarray(a) for a in lanes()))
        np.testing.assert_array_equal(res_t.num_iters.numpy(), np.asarray(res_j.num_iters))
        _assert_within_rule(_numpy(ours_l), ref_l, lambda: jst.root_stage_lanes(
            *(jnp.asarray(a) for a in lanes(1 + 1e-6)))[0], f"{mode} lanes")

    ours, res = tst.root_stage(*(torch.as_tensor(a) for a in _args(sequences[0])))
    assert int(res.num_iters[0]) == iters
    assert ours.pose_body.shape == (F, 23, 3, 3) and ours.betas.shape == (1, 10)
    for a, b in zip(ours_l, ours):
        torch.testing.assert_close(a[0], b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("offset", [0.0, 2.0])
def test_bucket_padded_frames_in_the_dense_terms_match_the_reference(models, sequences, offset):
    """What the reference does with frames padded to a bucket (zero markers,
    the prior's last frame repeated), and the port with it: ``part_chamfer``
    masks markers by label only and ``full_chamfer``'s reverse term is a
    mean over every vertex, so in a padded frame every vertex's nearest
    marker is one of the zeros at the origin.  The padded frames raise both
    terms, by more the farther the subject is from the origin (moved 2 m
    along x, as a capture volume's origin may sit, ``part_chamfer`` grows
    9x with 4 padded frames in 16).  The occluded markers, zeros too, count
    in ``part_chamfer``'s reverse term in every frame: at 2 m they already
    set most of its value.  The port keeps the reference's values (ROADMAP
    C.6)."""
    from uuo_mocap_tpu.body.model import lbs_forward as jax_lbs_forward
    from uuo_mocap_tpu.solver import losses as JL
    from uuo_mocap_tpu_torch.solver import losses as TL

    jm = models[0]
    s = sequences[0]
    F_pad = 16
    shift = np.array([offset, 0.0, 0.0], np.float32)
    markers = np.where(np.abs(s["markers"]).sum(-1, keepdims=True) != 0, s["markers"] + shift, 0.0)

    def pad(a, zero=False):
        tail = np.zeros_like(a[-1:]) if zero else a[-1:]
        return np.concatenate([a] + [tail] * (F_pad - F))

    values = {}
    for tag, mk, pose, root, trans in (
            ("real", markers, s["pose"], s["root"], s["trans"] + shift),
            ("padded", pad(markers, zero=True), pad(s["pose"]), pad(s["root"]),
             pad(s["trans"] + shift))):
        Fx = mk.shape[0]
        verts = np.asarray(jax_lbs_forward(jm, jnp.asarray(pose),
                                           jnp.broadcast_to(jnp.asarray(s["betas"]), (Fx, 10)),
                                           jnp.asarray(root), jnp.asarray(trans))["vertices"])
        w = (np.abs(mk).sum(-1) != 0).astype(np.float32)
        labels = jnp.argmax(jm.lbs_weights, axis=-1)
        ref = (float(JL.part_chamfer_loss(jnp.asarray(mk), jnp.asarray(verts),
                                          jnp.asarray(s["labels"]), labels, jnp.arange(24), False)),
               float(JL.full_chamfer_loss(jnp.asarray(mk), jnp.asarray(verts), jnp.asarray(w),
                                          False)))
        tv = torch.as_tensor(verts)[None]
        ours = (TL.part_chamfer_loss(torch.as_tensor(mk), tv, torch.as_tensor(s["labels"]),
                                     torch.as_tensor(np.asarray(labels)), torch.arange(24),
                                     False).item(),
                TL.full_chamfer_loss(torch.as_tensor(mk), tv, torch.as_tensor(w), False).item())
        np.testing.assert_allclose(ours, ref, rtol=REL)
        values[tag] = ref
    print(f"offset {offset} m: part_chamfer, full_chamfer: real frames {values['real']}, with "
          f"{F_pad - F} padded frames {values['padded']}")
    for real, padded in zip(values["real"], values["padded"]):
        assert padded > real
