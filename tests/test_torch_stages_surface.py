"""The rest of the port's staged solve against the JAX package on the CPU:
``nearest_points`` and its lanes forms in every correspondence mode, the
part median, barycentric picks on a shared edge, the chamfer stage's dense
branch (``part_chamfer``, ``ground``) and the part fit's dense path with
the foot and velocity losses.

Size: F = 12 frames, M = 16 markers (5 % occluded), V = 6890; lanes: 3
bodies; descents of 5-10 iterations.  Inputs are made with the JAX
package's generators from numpy seeds.  Tolerances: vertex attachments
equal; barycentric attachments give the same surface point on every
frame's mesh, within 1e-5 m plus the float32 error of the face's weights
(``_assert_attachment``: at a tie between faces the face id is float32
rounding's choice, and the synthetic mesh's thin 0.6 m x 6 mm faces carry
weight errors of 1e-3 in either package).
Closure values and gradients 1e-5 relative
(float32 sums in another order); descended parameters within 1e-2 or
twice what the reference itself moves when its markers are scaled by
1 + 1e-6, whichever is larger (``tests/test_torch_batch_solver.py``'s
rule; the scaled descent runs only when a difference passes 1e-2).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uuo_mocap_tpu.body.model import lbs_forward as jax_lbs_forward
from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.data.config import load_config as jax_load_config
from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params, random_pose_sequence
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu.ops.point_mesh import point_mesh_distance as jax_point_mesh_distance
from uuo_mocap_tpu.pipeline.part_fit import PartFitter as JaxPartFitter
from uuo_mocap_tpu.pipeline.stages import SmplParams as JaxSmplParams
from uuo_mocap_tpu.pipeline.stages import SolveStages as JaxSolveStages
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.ops.point_mesh import point_mesh_distance
from uuo_mocap_tpu_torch.pipeline.part_fit import PartFitter
from uuo_mocap_tpu_torch.pipeline.stages import SmplParams, SolveStages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "video_mocap.yaml")
F, M, LANES = 12, 16, 3
REL, PARAM_ATOL = 1e-5, 1e-2
# per part: 2 markers (even), 3 (odd), 4, 1, 5; marker 15's id is past the
# last part (clipped to part 23, which has no marker: the n = 0 case)
PART_LABELS = np.array([0, 0, 1, 1, 1, 2, 2, 2, 2, 3, 16, 16, 16, 16, 16, 30], np.int64)


@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


def _params(p):
    return [np.asarray(a) for a in p]


@pytest.fixture(scope="module")
def data(models):
    jm = models[0]
    gt = random_pose_sequence(F, seed=61, yaw=0.7, travel=0.3)
    mk = generate_markers(jm, gt, num_markers=M, seed=62, occlusion_rate=0.05,
                          position_noise=0.002)
    priors = [perturb_params(gt, seed=63 + i, pose_noise=0.05, trans_noise=0.02,
                             betas_noise=0.2) for i in range(LANES)]
    markers = np.array(mk.points)
    img_mask = np.ones(F, np.float32)
    img_mask[4] = 0.0
    return dict(gt=_params(gt), markers=markers, priors=[_params(p) for p in priors],
                weights=(np.abs(markers).sum(-1) != 0).astype(np.float32), img_mask=img_mask,
                labels=np.asarray(jnp.argmax(jm.lbs_weights, -1))[np.asarray(mk.vertex_ids)])


def nearest_config(granularity, use_mean, use_barycentric):
    cfg = jax_load_config(CONFIG)
    cfg["stages"]["segment"]["granularity"] = granularity
    cfg["stages"]["compute_locations"].update(use_mean=use_mean, use_barycentric=use_barycentric)
    return cfg


def _virtual(ids, w, verts):
    """Attached points on every frame's mesh: ids, w [(A,) M, 3], verts
    [(A,) F, V, 3] -> [(A,) F, M, 3] (float64)."""
    if ids.ndim == 3:
        return np.stack([_virtual(i, ww, v) for i, ww, v in zip(ids, w, verts)])
    v = np.asarray(verts, np.float64)
    return (v[:, ids] * np.asarray(w, np.float64)[None, ..., None]).sum(-2)


def _face_tolerance(ids, verts):
    """The float32 error of a barycentric point on each attached face, per
    frame: [(A,) M, 3] ids, [(A,) F, V, 3] verts -> [(A,) F, M] in m.  The
    weights divide by det = |e0|^2 |e1|^2 - (e0.e1)^2, whose float32
    cancellation scales the point's error by |e0|^2 |e1|^2 / det and the
    face's longest edge: 1e-9 m on this mesh's ordinary faces, but up to
    1e-3 m on its thin 0.6 m x 6 mm faces."""
    if ids.ndim == 3:
        return np.stack([_face_tolerance(i, v) for i, v in zip(ids, verts)])
    v = np.asarray(verts, np.float64)[:, ids]  # [F, M, 3 corners, 3]
    e0, e1, e2 = v[..., 1, :] - v[..., 0, :], v[..., 2, :] - v[..., 0, :], v[..., 2, :] - v[..., 1, :]
    aa, bb, cc = (e0 * e0).sum(-1), (e0 * e1).sum(-1), (e1 * e1).sum(-1)
    cond = aa * cc / np.maximum(aa * cc - bb * bb, 1e-30)
    longest = np.sqrt(np.maximum(np.maximum(aa, cc), (e2 * e2).sum(-1)))
    return 4 * np.finfo(np.float32).eps * cond * longest


def _assert_attachment(ours, ref, verts, barycentric):
    """Vertex picks (``use_mean`` or the per-frame vertex): ids equal, weights
    (1, 0, 0).  Barycentric picks: the attached surface point the same on
    every frame's mesh ``verts``, within 1e-5 m plus its face's float32
    error (``_face_tolerance``).  Face ids and weights are not compared one
    to one there: at a tie (the nearest surface point on a vertex or an
    edge shared by faces; the markers sit at vertices plus a normal offset)
    float32 rounding picks either face in either package, and on a thin face
    the weights carry the error above."""
    ids_o, ids_r = ours.vertex_ids.numpy(), np.asarray(ref.vertex_ids)
    w_o, w_r = ours.weights.numpy(), np.asarray(ref.weights)
    assert ids_o.shape == ids_r.shape and w_o.shape == w_r.shape
    np.testing.assert_allclose(w_o.sum(-1), 1.0, rtol=0, atol=1e-5)
    if not barycentric:
        np.testing.assert_array_equal(ids_o, ids_r)
        np.testing.assert_array_equal(w_o, w_r)
        return
    gap = np.abs(_virtual(ids_o, w_o, verts) - _virtual(ids_r, w_r, verts)).max(-1)
    tol = 1e-5 + np.maximum(_face_tolerance(ids_o, verts), _face_tolerance(ids_r, verts))
    assert (gap <= tol).all(), (gap.max(), (gap - tol).max())
    print(f"barycentric: {int((ids_o != ids_r).any(-1).sum())} of {ids_o.size // 3} picks on "
          f"another face, surface points within {gap.max():.2e} m")


def _posed(jm, params):
    """Vertices [..., F, V, 3] of (lane-batched) params at their mean betas."""
    pose, betas, root, trans = (jnp.asarray(a) for a in params)
    b = jnp.broadcast_to(jnp.mean(jnp.broadcast_to(betas, trans.shape[:-1] + (10,)), axis=-2,
                                  keepdims=True), trans.shape[:-1] + (10,))
    return np.asarray(jax_lbs_forward(jm, pose, b, root, trans)["vertices"])


CASES = [("full", True, False), ("full", False, False), ("full", False, True),
         ("marker", False, False), ("part", False, True), ("marker", False, True),
         ("part", False, False), ("full", True, True)]


@pytest.mark.parametrize("granularity,use_mean,use_barycentric", CASES)
def test_nearest_points_matches_jax(models, data, granularity, use_mean, use_barycentric):
    """Single sequence, lanes with labels and lanes without: the same
    attachments.  ``use_mean`` wins over ``use_barycentric``; ``part``
    without labels is ``full``."""
    jm, tm = models
    cfg = nearest_config(granularity, use_mean, use_barycentric)
    jst, tst = JaxSolveStages(jm, cfg), SolveStages(tm, copy.deepcopy(cfg))
    labels = PART_LABELS
    mk, im = data["markers"], data["img_mask"]
    p0 = data["priors"][0]
    ref = jst.nearest_points(jnp.asarray(mk), JaxSmplParams(*map(jnp.asarray, p0)),
                             jnp.asarray(im), jnp.asarray(labels))
    ours = tst.nearest_points(torch.as_tensor(mk), SmplParams(*map(torch.as_tensor, p0)),
                              torch.as_tensor(im), torch.as_tensor(labels))
    assert ours.vertex_ids.shape == (M, 3)
    bary = use_barycentric and not use_mean
    _assert_attachment(ours, ref, _posed(jm, p0), bary)

    # lanes: each its own body, frame mask and labels (marker order rolled)
    lane_p = [np.stack(c) for c in zip(*data["priors"])]
    mk_l = np.stack([mk, mk[::-1].copy(), mk])
    im_l = np.stack([im, np.ones(F, np.float32), im[::-1].copy()])
    lab_l = np.stack([np.roll(labels, i) for i in range(LANES)])
    ref_l = jst.nearest_points_lanes(jnp.asarray(mk_l), JaxSmplParams(*map(jnp.asarray, lane_p)),
                                     jnp.asarray(im_l), jnp.asarray(lab_l))
    ours_l = tst.nearest_points_lanes(torch.as_tensor(mk_l),
                                      SmplParams(*map(torch.as_tensor, lane_p)),
                                      torch.as_tensor(im_l), torch.as_tensor(lab_l))
    verts_l = _posed(jm, lane_p)
    _assert_attachment(ours_l, ref_l, verts_l, bary)
    ref_n = jst.nearest_points_lanes_nolabel(jnp.asarray(mk_l),
                                             JaxSmplParams(*map(jnp.asarray, lane_p)),
                                             jnp.asarray(im_l))
    ours_n = tst.nearest_points_lanes_nolabel(torch.as_tensor(mk_l),
                                              SmplParams(*map(torch.as_tensor, lane_p)),
                                              torch.as_tensor(im_l))
    _assert_attachment(ours_n, ref_n, verts_l, bary)


def test_part_median_frames(models):
    """The part's frame is the argmin of the median over its markers: the
    mean of the two middle values for an even count, the middle one for an
    odd count, frame 0 for a part without markers (ids past the last part
    take the last part's frame)."""
    tst = SolveStages(models[1], nearest_config("part", False, False))
    rng = np.random.RandomState(5)
    dist = rng.rand(2, 7, M).astype(np.float32)
    dist[:, 3] = 1e10  # a masked frame
    labels = np.stack([PART_LABELS, np.roll(PART_LABELS, 3)])
    got = tst._part_best_frames(torch.as_tensor(dist), torch.as_tensor(labels)).numpy()
    for a in range(2):
        for m in range(M):
            pid = min(labels[a, m], 23)
            cols = labels[a] == pid
            want = int(np.argmin(np.median(dist[a][:, cols], axis=1))) if cols.any() else 0
            assert got[a, m] == want, (a, m)


def test_barycentric_pick_on_a_shared_edge_matches_jax(models, data):
    """Markers at the midpoints of edges shared by two faces (an exact tie):
    both packages return one of the two faces, the same distance and the
    same closest point; which of the two is float32 rounding's choice (the
    reference's XLA program contracts products into fused multiply-adds,
    PyTorch's CPU ops do not), and through ``nearest_points`` the
    attachments give the same surface point."""
    jm, tm = models
    faces = np.asarray(jm.faces)
    edges = {}
    for fi, f in enumerate(faces):
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            edges.setdefault((min(a, b), max(a, b)), []).append(fi)
    shared = [e for e, fs in edges.items() if len(fs) == 2]
    pick = [shared[i] for i in np.random.RandomState(9).choice(len(shared), M, replace=False)]
    gt = data["gt"]
    verts = _posed(jm, gt)
    pts = np.stack([0.5 * (verts[:, a] + verts[:, b]) for a, b in pick], axis=1)  # [F, M, 3]
    ref = jax_point_mesh_distance(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(faces))
    ours = point_mesh_distance(torch.as_tensor(pts), torch.as_tensor(verts), faces)
    fo, fr = ours["face_index"].numpy(), np.asarray(ref["face_index"])
    for m, e in enumerate(pick):
        assert set(fo[:, m]) <= set(edges[e]) and set(fr[:, m]) <= set(edges[e]), m
    np.testing.assert_allclose(ours["distance"].numpy(), np.asarray(ref["distance"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours["closest_point"].numpy(), np.asarray(ref["closest_point"]),
                               rtol=0, atol=1e-6)
    print(f"edge midpoints: {int((fo != fr).sum())} of {fo.size} on the other face")
    cfg = nearest_config("marker", False, True)
    att_j = JaxSolveStages(jm, cfg).nearest_points(
        jnp.asarray(pts), JaxSmplParams(*map(jnp.asarray, gt)), jnp.ones(F), None)
    att_t = SolveStages(tm, copy.deepcopy(cfg)).nearest_points(
        torch.as_tensor(pts), SmplParams(*map(torch.as_tensor, gt)), torch.ones(F), None)
    _assert_attachment(att_t, att_j, verts, True)


# ------------------------------------------------------------- closures


def _check_closure(jfun, tfun, params, lane, shared):
    """The reference's one-lane closure against the port's with one lane."""
    fj, gj = jax.value_and_grad(lambda p: jfun(
        p, {k: jnp.asarray(v) for k, v in lane.items()},
        {k: jnp.asarray(v) for k, v in shared.items()}))(
        {k: jnp.asarray(v) for k, v in params.items()})
    p = {k: torch.as_tensor(np.array(v))[None].requires_grad_(True) for k, v in params.items()}
    ft = tfun(p, {k: torch.as_tensor(np.array(v))[None] for k, v in lane.items()},
              {k: torch.as_tensor(np.array(v)) for k, v in shared.items()})
    assert ft.shape == (1,)
    ft.sum().backward()
    np.testing.assert_allclose(ft.item(), float(fj), rtol=REL)
    for k in params:
        g = np.asarray(gj[k])
        np.testing.assert_allclose(p[k].grad[0].numpy(), g, rtol=0, atol=REL * np.abs(g).max(),
                                   err_msg=k)


def _assert_within_rule(ours, ref, moved):
    """Every field within 1e-2, or within twice what the reference moves
    (``moved()``: its descent on scaled markers, run only when needed)."""
    for k, (o, r) in enumerate(zip(ours, ref)):
        o, r = o.detach().numpy(), np.asarray(r)
        assert o.shape == r.shape and np.isfinite(o).all(), k
        if float(np.abs(o - r).max()) > PARAM_ATOL:
            tol = max(PARAM_ATOL, 2.0 * float(np.abs(np.asarray(moved()[k]) - r).max()))
            np.testing.assert_allclose(o, r, atol=tol, rtol=0, err_msg=f"field {k}")


CHAMFER_DENSE = {"full_chamfer": 10.0, "part_chamfer": 10.0, "ground": 1.0,
                 "reg_pose_body": 1.0, "reg_betas": 1.0, "trans_vel": 1.0,
                 "root_orient_vel": 1.0}


def chamfer_config(single_directional):
    cfg = jax_load_config(CONFIG)
    cfg["stages"]["chamfer"].update(num_iters=5, single_directional=single_directional,
                                    losses=dict(CHAMFER_DENSE))
    return cfg


@pytest.mark.parametrize("single_directional", [False, True])
def test_chamfer_dense_branch_matches_jax(models, data, single_directional):
    """The closure with ``part_chamfer`` and ``ground`` (dense in either
    direction); the descent around it is the chamfer stage's L-BFGS, held
    on the sparse branch by ``test_torch_pipeline.py``."""
    jm, tm = models
    pose, betas, root, trans = data["priors"][0]
    rng = np.random.RandomState(3)
    cfg = chamfer_config(single_directional)
    jst, tst = JaxSolveStages(jm, cfg), SolveStages(tm, copy.deepcopy(cfg))
    params = {"trans": trans, "z": (0.1 * rng.randn(F, 1, 1)).astype(np.float32),
              "betas": betas,
              "pose6d": np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(pose)))
              + (0.01 * rng.randn(F, 23, 6)).astype(np.float32)}
    shared = {"markers": data["markers"], "weights": data["weights"], "o_pose_body": pose,
              "o_betas": betas, "marker_labels_mode": data["labels"],
              "frame_valid": np.ones(F, np.float32)}
    _check_closure(jst._chamfer_solver.fun, tst._chamfer_solver.fun, params,
                   {"root_orient0": root}, shared)


PART_LOSSES = {"chamfer": 10.0, "reg_betas": 0.1, "ground": 1.0, "foot_contact": 1.0,
               "foot_velocity": 1.0, "velocity": 1.0}


def part_config(losses, full_skeleton=False):
    cfg = jax_load_config(CONFIG)
    cfg["stages"]["part"].update(num_iters=10, losses=dict(losses))
    if full_skeleton:
        cfg["stages"]["part"]["use_full_skeleton"] = 24
    return cfg


@pytest.mark.parametrize("dense", [True, False])
def test_part_closure_with_foot_and_velocity_losses_matches_jax(models, data, dense):
    """With ``ground`` the dense path (joints of the dense forward); without
    it the sparse path (joints of the gathered forward)."""
    jm, tm = models
    pose, betas, root, trans = data["priors"][0]
    losses = dict(PART_LOSSES) if dense else {k: v for k, v in PART_LOSSES.items()
                                              if k != "ground"}
    cfg = part_config(losses)
    labels = np.asarray(jnp.argmax(jm.lbs_weights, axis=-1))
    mask = np.isin(labels, [0, 1, 2, 4, 5, 7, 8, 10, 11]).astype(np.float32)
    rng = np.random.RandomState(4)
    fc = (rng.rand(F, 2) > 0.5).astype(np.float32)
    fv = np.ones(F, np.float32)
    fv[-2:] = 0.0
    params = {"z": np.full((1, 1, 1), 0.2, np.float32),
              "trans": trans + (0.01 * rng.randn(F, 3)).astype(np.float32), "betas": betas}
    shared = {"markers": data["markers"], "marker_weights": np.ones_like(data["weights"]),
              "o_pose_body": pose, "o_betas": betas, "root_orient0": root,
              "foot_contacts": fc, "frame_valid": fv}
    _check_closure(JaxPartFitter(jm, cfg)._solver.fun,
                   PartFitter(tm, copy.deepcopy(cfg))._solver.fun, params,
                   {"vertex_mask": mask}, shared)


def test_part_fit_dense_path_matches_jax(models, data):
    """``PartFitter`` on the full skeleton with every part loss, 10
    iterations: the same chain and labels, parameters within the rule."""
    jm, tm = models
    pose, betas, root, _ = data["priors"][0]
    cfg = part_config(PART_LOSSES, full_skeleton=True)
    fc = (np.random.RandomState(8).rand(F, 2) > 0.5).astype(np.float32)

    def args(scale=1.0):
        mk = data["markers"] * np.float32(scale)
        return dict(markers=mk, marker_weights=np.ones_like(data["weights"]), o_pose_body=pose,
                    o_betas=betas, root_orient0=root, foot_contacts=fc,
                    frame_valid=np.ones(F, np.float32))

    jfit = JaxPartFitter(jm, cfg)
    ref = jfit(num_rigid_groups=M, **{k: jnp.asarray(v) for k, v in args().items()})
    ours = PartFitter(tm, copy.deepcopy(cfg))(
        num_rigid_groups=M, **{k: torch.as_tensor(v) for k, v in args().items()})
    np.testing.assert_array_equal(ours.chain, ref.chain)
    np.testing.assert_array_equal(ours.marker_labels.numpy(), np.asarray(ref.marker_labels))
    _assert_within_rule(ours.params, ref.params, lambda: jfit(
        num_rigid_groups=M, **{k: jnp.asarray(v) for k, v in args(1 + 1e-6).items()}).params)
