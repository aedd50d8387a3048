"""SMPL forwards of the PyTorch port against ``uuo_mocap_tpu.body.model``.

The JAX synthetic model is built once and carried across with
``convert.body_model_from_numpy``, so both sides use the same tensors.
Tolerance 1e-5 m: float32 sums over V = 6890 (the joint regressor) and over
207 pose correctives run in another order on each side."""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from uuo_mocap_tpu.body import model as jmodel
from uuo_mocap_tpu.body.synthetic import _build_arrays as jax_build_arrays
from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu_torch.body import model as tmodel
from uuo_mocap_tpu_torch.body.synthetic import _build_arrays
from uuo_mocap_tpu.data.synthetic import random_pose_sequence
from uuo_mocap_tpu_torch.convert import (
    body_model_arrays, body_model_from_numpy, smpl_params_from_numpy)
from uuo_mocap_tpu_torch.data.synthetic import random_pose_sequence as port_random_pose_sequence

TOL = 1e-5
RNG = np.random.RandomState(5)


@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


def _pose(batch):
    pose = np.array(jrot.axis_angle_to_matrix(jnp.asarray(
        0.4 * RNG.randn(*batch, 23, 3).astype(np.float32))))
    root = np.array(jrot.axis_angle_to_matrix(jnp.asarray(
        RNG.randn(*batch, 1, 3).astype(np.float32))))
    betas = RNG.randn(*batch, 10).astype(np.float32)
    trans = RNG.randn(*batch, 3).astype(np.float32)
    return pose, betas, root, trans


def test_synthetic_model_arrays_match_the_reference():
    ref, ours = jax_build_arrays("neutral"), _build_arrays("neutral")
    assert set(ref) == set(ours)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_converter_round_trip(models):
    jm, tm = models
    arrays = body_model_arrays(jm)
    back = body_model_arrays(body_model_from_numpy(arrays, device="cpu"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert tm.num_vertices == 6890


def test_lbs_forward_matches_jax(models):
    jm, tm = models
    pose, betas, root, trans = _pose((4,))
    ref = jmodel.lbs_forward(jm, *(jnp.asarray(a) for a in (pose, betas, root, trans)))
    out = tmodel.lbs_forward(tm, *(torch.as_tensor(a) for a in (pose, betas, root, trans)))
    assert out["vertices"].shape == (4, 6890, 3) and out["joints"].shape == (4, 45, 3)
    for k in ("vertices", "joints"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=TOL, rtol=0, err_msg=k)


def test_lbs_forward_at_matches_dense_gather_and_jax(models):
    jm, tm = models
    pose, betas, root, trans = _pose((2, 3))
    ids = RNG.randint(0, 6890, size=(2, 3, 11))
    args_t = [torch.as_tensor(a) for a in (pose, betas, root, trans)]
    dense = tmodel.lbs_forward(tm, *args_t)["vertices"]
    at = tmodel.lbs_forward_at(tm, *args_t, torch.as_tensor(ids))
    gathered = torch.gather(dense, -2, torch.as_tensor(ids)[..., None].expand(2, 3, 11, 3))
    np.testing.assert_allclose(at["points"].numpy(), gathered.numpy(), atol=TOL, rtol=0)
    ref = jmodel.lbs_forward_at(jm, *(jnp.asarray(a) for a in (pose, betas, root, trans)),
                                jnp.asarray(ids))
    np.testing.assert_allclose(at["points"].numpy(), np.asarray(ref["points"]), atol=TOL, rtol=0)
    np.testing.assert_allclose(at["joints"].numpy(), np.asarray(ref["joints"]), atol=TOL, rtol=0)


def test_lbs_forward_at_gradient_matches_jax(models):
    """The gathered forward's autograd gradient (the sparse path's O(M)
    backward) against jax.grad, relative 1e-5."""
    import jax

    jm, tm = models
    pose, betas, root, trans = _pose((3,))
    ids = RNG.randint(0, 6890, size=(3, 9))
    target = RNG.randn(3, 9, 3).astype(np.float32)

    def jloss(b, t):
        p = jmodel.lbs_forward_at(jm, jnp.asarray(pose), b, jnp.asarray(root), t, jnp.asarray(ids))
        return jnp.sum((p["points"] - target) ** 2)

    gb, gt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(betas), jnp.asarray(trans))
    b_t = torch.as_tensor(betas).requires_grad_(True)
    t_t = torch.as_tensor(trans).requires_grad_(True)
    p = tmodel.lbs_forward_at(tm, torch.as_tensor(pose), b_t, torch.as_tensor(root), t_t,
                              torch.as_tensor(ids))
    ((p["points"] - torch.as_tensor(target)) ** 2).sum().backward()
    for ours, ref in ((b_t.grad, gb), (t_t.grad, gt)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_smpl_params_converter_and_pose_generator_match_jax():
    ref = random_pose_sequence(7, seed=9, yaw=0.3, travel=0.4)
    params = smpl_params_from_numpy(ref, device="cpu")
    ours = port_random_pose_sequence(7, seed=9, yaw=0.3, travel=0.4, device="cpu")
    for k in ("pose_body", "betas", "root_orient", "trans"):
        np.testing.assert_array_equal(getattr(params, k).numpy(), np.asarray(getattr(ref, k)))
        np.testing.assert_allclose(getattr(ours, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-6, rtol=0)


def test_marker_generator_and_prior_noise_match_jax(models):
    """Same seeds, same anchors, occlusions and prior noise; positions to
    1e-5 m (vertex normals summed in another order)."""
    from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params
    from uuo_mocap_tpu_torch.data import synthetic as tsyn

    jm, tm = models
    gt = random_pose_sequence(5, seed=2, yaw=0.5, travel=0.3)
    ref = generate_markers(jm, gt, num_markers=10, seed=3, occlusion_rate=0.2, position_noise=0.001)
    gt_t = smpl_params_from_numpy(gt, device="cpu")
    ours = tsyn.generate_markers(tm, gt_t, num_markers=10, seed=3, occlusion_rate=0.2,
                                 position_noise=0.001)
    np.testing.assert_array_equal(ours.vertex_ids, ref.vertex_ids)
    np.testing.assert_allclose(ours.points.numpy(), np.asarray(ref.points), atol=TOL, rtol=0)
    pj = perturb_params(gt, seed=4)
    pt = tsyn.perturb_params(gt_t, seed=4)
    for k in ("pose_body", "betas", "root_orient", "trans"):
        np.testing.assert_allclose(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)), atol=1e-6,
                                   rtol=0, err_msg=k)
