"""The port's rotations, layouts, synthetic markers, point-mesh distance and
evaluation metrics against the JAX package, on the same numpy inputs.

Tolerances (float32 on both sides):
  * rotations 1e-5 (rad or matrix entries): the same closed forms;
  * unit vertex normals 1e-4, markers 1e-5 m: the port sums each vertex's
    face normals in face order, the JAX package by corner slot, and where a
    vertex's face normals nearly cancel, normalizing amplifies the float32
    difference (2e-5 read on the synthetic model); x 9.5 mm it is < 1e-6 m;
  * layout vertex ids and marker labels exactly (the same numpy arithmetic);
  * point-mesh distances and closest points 1e-6 m, face ids equal except
    on ties (both faces within 1e-12 m^2 of the same squared distance);
  * metrics 1e-4 mm, and 1e-6 relative for the velocity metrics, whose
    values are m/s x 1000 (float32 differences scaled by the frame rate).
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.body.model import lbs_forward as jax_lbs_forward
from uuo_mocap_tpu.data import marker_layout as jlayout
from uuo_mocap_tpu.data import markers_synthetic as jms
from uuo_mocap_tpu.data.synthetic import generate_markers as jax_generate_markers
from uuo_mocap_tpu.data.synthetic import random_pose_sequence as jax_random_pose_sequence
from uuo_mocap_tpu.eval import metrics as jmetrics
from uuo_mocap_tpu.ops import geometry as jgeom
from uuo_mocap_tpu.ops import point_mesh as jpm
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu.ops.procrustes import similarity_transform as jax_similarity_transform
from uuo_mocap_tpu.pipeline import segmentation as jseg
from uuo_mocap_tpu_torch.body.model import lbs_forward
from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
from uuo_mocap_tpu_torch.convert import smpl_params_from_numpy
from uuo_mocap_tpu_torch.data import marker_layout as tlayout
from uuo_mocap_tpu_torch.data import markers_synthetic as tms
from uuo_mocap_tpu_torch.data.synthetic import generate_markers
from uuo_mocap_tpu_torch.eval import metrics as tmetrics
from uuo_mocap_tpu_torch.ops import geometry as tgeom
from uuo_mocap_tpu_torch.ops import point_mesh as tpm
from uuo_mocap_tpu_torch.ops import rotations as trot
from uuo_mocap_tpu_torch.ops.procrustes import similarity_transform
from uuo_mocap_tpu_torch.pipeline import segmentation as tseg

TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    return jax_synthetic_body_model(), synthetic_body_model(device="cpu")


@pytest.fixture(scope="module")
def posed(models):
    """Ground-truth motion (4 frames) and its vertices and joints in both
    packages."""
    jm, tm = models
    gt = jax_random_pose_sequence(4, seed=11, yaw=0.7)
    tp = smpl_params_from_numpy(gt, device="cpu")
    jout = jax_lbs_forward(jm, gt.pose_body, jnp.broadcast_to(gt.betas, (4, 10)), gt.root_orient, gt.trans)
    with torch.no_grad():
        tout = lbs_forward(tm, tp.pose_body, tp.betas, tp.root_orient, tp.trans)
    return gt, jout, tout


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _angles():
    """Axis-angle vectors from 0 through pi: exact zero, tiny, moderate, and
    within 1e-3 and 1e-6 of pi, about random axes."""
    rng = np.random.RandomState(2)
    axes = rng.randn(8, 3)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    mags = np.array([0.0, 1e-7, 1e-4, 0.5, 2.0, np.pi - 1e-3, np.pi - 1e-6, np.pi - 1e-6])
    return (axes * mags[:, None]).astype(np.float32)


def test_matrix_to_axis_angle_near_zero_and_pi():
    aa = _angles()
    R = np.array(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    out = _np(trot.matrix_to_axis_angle(torch.as_tensor(R)))
    ref = np.asarray(jrot.matrix_to_axis_angle(jnp.asarray(R)))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    # the export round trip: the angle-axis gives the rotation back, at both ends
    np.testing.assert_allclose(_np(trot.axis_angle_to_matrix(torch.as_tensor(out))), R, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(out[:3], axis=-1), [0.0, 1e-7, 1e-4], atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(out[5:], axis=-1), np.pi, atol=2e-3)


def test_quaternion_axis_angle_rot_y_apply_rotation():
    aa = _angles()
    q = _np(trot.axis_angle_to_quaternion(torch.as_tensor(aa)))
    np.testing.assert_allclose(q, np.asarray(jrot.axis_angle_to_quaternion(jnp.asarray(aa))), atol=TOL)
    np.testing.assert_allclose(_np(trot.quaternion_to_axis_angle(torch.as_tensor(q))),
                               np.asarray(jrot.quaternion_to_axis_angle(jnp.asarray(q))), atol=TOL)
    ang = np.linspace(-3.1, 3.1, 7, dtype=np.float32)[:, None]
    np.testing.assert_allclose(_np(trot.rot_y(torch.as_tensor(ang))),
                               np.asarray(jrot.rot_y(jnp.asarray(ang))), atol=TOL)
    R = np.array(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    v = np.random.RandomState(3).randn(8, 3).astype(np.float32)
    np.testing.assert_allclose(_np(trot.apply_rotation(torch.as_tensor(R), torch.as_tensor(v))),
                               np.asarray(jrot.apply_rotation(jnp.asarray(R), jnp.asarray(v))), atol=TOL)


def test_vertex_normals(models, posed):
    jm, tm = models
    _, jout, tout = posed
    ref = np.asarray(jgeom.vertex_normals(np.asarray(jout["vertices"]), jm.faces))
    out = tgeom.vertex_normals(tout["vertices"], tm.faces)
    np.testing.assert_allclose(_np(out), ref, atol=1e-4)
    # leading dims broadcast: [2, F, V, 3], each slice as alone
    two = tgeom.vertex_normals(torch.stack([tout["vertices"], tout["vertices"] * 2.0]), tm.faces)
    np.testing.assert_array_equal(_np(two[0]), _np(out))


def test_resolve_layout_vertex_ids_equal(models):
    jm, tm = models
    ids = tlayout.resolve_layout_vertex_ids("cmu_41", tm)
    np.testing.assert_array_equal(ids, jlayout.resolve_layout_vertex_ids("cmu_41", jm))
    assert ids.dtype == np.int64 and ids.shape == (39,)
    names = ["LANK", "ROWR", "UNKNOWN"]  # ROWR is not in cmu_41; UNKNOWN takes the pelvis anchor
    np.testing.assert_array_equal(tlayout.resolve_layout_vertex_ids(names, tm),
                                  jlayout.resolve_layout_vertex_ids(names, jm))
    table = {n: i * 7 for i, n in enumerate(tlayout.get_marker_layout("cmu_41"))}
    np.testing.assert_array_equal(tlayout.resolve_layout_vertex_ids("cmu_41", tm, table),
                                  jlayout.resolve_layout_vertex_ids("cmu_41", jm, table))


def test_compute_markers_from_layout(models, posed):
    jm, tm = models
    _, jout, tout = posed
    vids = tlayout.resolve_layout_vertex_ids("cmu_41", tm)
    out = tlayout.compute_markers_from_layout(tout["vertices"][None], tm.faces, vids)["marker_pos"]
    ref = jlayout.compute_markers_from_layout(jout["vertices"][None], jm.faces, vids)["marker_pos"]
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=TOL)
    np.testing.assert_array_equal(
        _np(tlayout.compute_marker_labels_from_layout(vids, tm.lbs_weights)),
        np.asarray(jlayout.compute_marker_labels_from_layout(vids, jm.lbs_weights)))


def test_generate_markers_at_layout_ids(models):
    """bench.py's cmu_41 path: markers at the layout's ids, 5 % occlusion."""
    jm, tm = models
    gt = jax_random_pose_sequence(6, seed=2000, yaw=0.9, travel=0.5)
    vids = jlayout.resolve_layout_vertex_ids("cmu_41", jm)
    ref = jax_generate_markers(jm, gt, num_markers=41, seed=2001, occlusion_rate=0.05, vertex_ids=vids)
    out = generate_markers(tm, smpl_params_from_numpy(gt, device="cpu"), num_markers=41, seed=2001,
                           occlusion_rate=0.05, vertex_ids=tlayout.resolve_layout_vertex_ids("cmu_41", tm))
    np.testing.assert_array_equal(out.vertex_ids, ref.vertex_ids)
    np.testing.assert_array_equal(_np(out.points) == 0, np.asarray(ref.points) == 0)
    np.testing.assert_allclose(_np(out.points), np.asarray(ref.points), atol=TOL)


def test_markers_synthetic(models):
    jm, tm = models
    ref = jms.MarkersSynthetic(jm, num_frames=5, num_markers=17, seed=4, occlusion_rate=0.1)
    out = tms.MarkersSynthetic(tm, num_frames=5, num_markers=17, seed=4, occlusion_rate=0.1)
    np.testing.assert_array_equal(out.vertex_ids, ref.vertex_ids)
    np.testing.assert_allclose(out.get_points(), ref.get_points(), atol=TOL)
    assert out.get_frequency() == ref.get_frequency()
    for k in ("pose_body", "betas", "root_orient", "trans"):
        np.testing.assert_allclose(_np(getattr(out.gt_params, k)), np.asarray(getattr(ref.gt_params, k)),
                                   atol=1e-6)


@pytest.mark.parametrize("parts, shuffle", [(None, False), (["left_leg", "right_arm"], True)])
def test_markers_synthetic_structured(models, parts, shuffle):
    jm, tm = models
    ref = jms.MarkersSyntheticStructured(jm, num_frames=4, seed=9, parts=parts, shuffle=shuffle)
    out = tms.MarkersSyntheticStructured(tm, num_frames=4, seed=9, parts=parts, shuffle=shuffle)
    np.testing.assert_array_equal(out.vertex_ids, ref.vertex_ids)
    np.testing.assert_array_equal(out.marker_labels, ref.marker_labels)
    np.testing.assert_allclose(out.get_points(), ref.get_points(), atol=TOL)


def test_amass_npz_motion(models, tmp_path):
    jm, tm = models
    rng = np.random.RandomState(8)
    path = str(tmp_path / "amass.npz")
    np.savez(path, poses=rng.randn(5, 156).astype(np.float32) * 0.3, betas=rng.randn(16),
             trans=rng.randn(5, 3), mocap_frame_rate=120.0)
    ref = jms.MarkersSynthetic(jm, amass_npz=path, num_markers=9, seed=1)
    out = tms.MarkersSynthetic(tm, amass_npz=path, num_markers=9, seed=1)
    assert out.get_frequency() == ref.get_frequency() == 120.0
    np.testing.assert_allclose(out.get_points(), ref.get_points(), atol=TOL)


def test_segmentation_helpers():
    rng = np.random.RandomState(4)
    pts = rng.randn(9, 6, 3).astype(np.float32)
    pts[:, 2] = pts[0, 2]  # a static channel
    pts[7:] = 0.0  # trailing empty frames
    np.testing.assert_array_equal(tseg.trim_trailing_zero_frames(pts), jseg.trim_trailing_zero_frames(pts))
    np.testing.assert_array_equal(tseg.cleanup_markers(pts[:7]), jseg.cleanup_markers(pts[:7]))
    perm = np.stack([pts[f, rng.permutation(6)] for f in range(7)])
    np.testing.assert_array_equal(tseg.id_markers(perm), jseg.id_markers(perm))
    np.testing.assert_array_equal(tseg.shuffle_markers(pts, np.random.RandomState(1)),
                                  jseg.shuffle_markers(pts, np.random.RandomState(1)))


def _surface_queries(verts, rng, M=30):
    """Points around the surface: vertices, face interiors, offsets along
    random directions at 0-5 cm."""
    F = verts.shape[0]
    idx = rng.randint(0, verts.shape[1], (F, M))
    base = np.take_along_axis(verts, idx[..., None], axis=1)
    return (base + rng.randn(F, M, 3) * rng.uniform(0, 0.05, (F, M, 1))).astype(np.float32)


def test_point_triangle_closest(models, posed):
    jm, _ = models
    _, jout, _ = posed
    rng = np.random.RandomState(6)
    v = np.asarray(jout["vertices"])[0]
    tri = v[jm.faces[:500]]
    pts = _surface_queries(v[None], rng, M=40)[0]
    d2, bary = tpm.point_triangle_closest(*(torch.as_tensor(a) for a in (pts, tri[:, 0], tri[:, 1], tri[:, 2])))
    jd2, jbary = jpm.point_triangle_closest(*(jnp.asarray(a) for a in (pts, tri[:, 0], tri[:, 1], tri[:, 2])))
    np.testing.assert_allclose(_np(d2), np.asarray(jd2), atol=1e-12, rtol=1e-5)
    np.testing.assert_allclose(_np(bary), np.asarray(jbary), atol=1e-4)


def test_point_mesh_distance(models, posed):
    jm, tm = models
    _, jout, tout = posed
    rng = np.random.RandomState(7)
    verts = np.asarray(jout["vertices"])[:2]
    pts = _surface_queries(verts, rng)
    out = tpm.point_mesh_distance(torch.as_tensor(pts), torch.as_tensor(verts), tm.faces)
    ref = jpm.point_mesh_distance(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(jm.faces))
    np.testing.assert_allclose(_np(out["distance"]), np.asarray(ref["distance"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(out["closest_point"]), np.asarray(ref["closest_point"]), atol=1e-6)
    fi, jfi = _np(out["face_index"]), np.asarray(ref["face_index"])
    differ = fi != jfi
    assert differ.mean() < 0.05
    if differ.any():  # a tie: both faces are as close as each other
        d2_all, _ = tpm.point_triangle_closest(
            torch.as_tensor(pts), *(torch.as_tensor(verts)[:, tm.faces[:, k]] for k in range(3)))
        d2_all = _np(d2_all)
        a = np.take_along_axis(d2_all, fi[..., None], -1)[..., 0]
        b = np.take_along_axis(d2_all, jfi[..., None], -1)[..., 0]
        assert np.abs(a - b)[differ].max() <= 1e-12
    np.testing.assert_allclose(_np(out["barycentric"])[~differ], np.asarray(ref["barycentric"])[~differ],
                               atol=1e-4)


def test_marker_to_surface_distance_chunks(models, posed):
    jm, tm = models
    _, jout, _ = posed
    verts = np.asarray(jout["vertices"])
    pts = _surface_queries(verts, np.random.RandomState(9), M=12)
    ref = float(jpm.marker_to_surface_distance(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(jm.faces)))
    for chunk in (1, 3, 32):
        out = float(tpm.marker_to_surface_distance(torch.as_tensor(pts), torch.as_tensor(verts),
                                                   tm.faces, chunk=chunk))
        assert abs(out - ref) <= 1e-6, (chunk, out, ref)


def _pred_gt(posed):
    gt, jout, tout = posed
    rng = np.random.RandomState(10)
    gj = np.asarray(jout["joints"])[:, :24]
    pj = (gj + rng.randn(*gj.shape) * 0.02).astype(np.float32)
    gv = np.asarray(jout["vertices"])
    pv = (gv + rng.randn(*gv.shape) * 0.01).astype(np.float32)
    markers = _surface_queries(gv, rng, M=15)
    return pj, gj, pv, gv, markers


def test_similarity_transform(posed):
    pj, gj, *_ = _pred_gt(posed)
    R = np.array(jrot.axis_angle_to_matrix(jnp.asarray([0.3, -1.2, 0.5], jnp.float32)))
    S1 = (1.3 * pj[:, :22] @ R.T + 0.2).astype(np.float32)
    out = _np(similarity_transform(torch.as_tensor(S1), torch.as_tensor(gj[:, :22])))
    np.testing.assert_allclose(out, np.asarray(jax_similarity_transform(jnp.asarray(S1), jnp.asarray(gj[:, :22]))),
                               atol=TOL)


def _close_metric(out, ref, key):
    velocity = "mpjve" in key
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-6 if velocity else 0, err_msg=key)


def test_compute_all_metrics(models, posed):
    jm, tm = models
    pj, gj, pv, gv, markers = _pred_gt(posed)
    ref = jmetrics.compute_all_metrics(*(jnp.asarray(a) for a in (pj, gj, pv, gv, markers)), jm.faces,
                                       freq=30.0)
    out = tmetrics.compute_all_metrics(*(torch.as_tensor(a) for a in (pj, gj, pv, gv, markers)),
                                       tm.faces, freq=30.0)
    assert out.keys() == ref.keys()
    for k in ref:
        _close_metric(out[k], ref[k], k)


def test_compute_part_metrics(posed):
    pj, gj, *_ = _pred_gt(posed)
    ref = jmetrics.compute_part_metrics(jnp.asarray(pj), jnp.asarray(gj), 30.0)
    out = tmetrics.compute_part_metrics(torch.as_tensor(pj), torch.as_tensor(gj), 30.0)
    assert out.keys() == ref.keys()
    for part in ref:
        assert out[part].keys() == ref[part].keys()
        for k in ref[part]:
            _close_metric(out[part][k], ref[part][k], f"{part}/{k}")
