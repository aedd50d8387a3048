"""Rotations of the PyTorch port against ``uuo_mocap_tpu.ops.rotations``.

Same numpy inputs (seeded) on both sides, float32 on the CPU.  Tolerance
1e-6: the formulas are identical, so only the last float32 bit of a few
products may differ."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu_torch.ops import rotations as trot

RNG = np.random.RandomState(17)
TOL = 1e-6


def _mats(n):
    aa = RNG.randn(n, 3).astype(np.float32)
    return np.array(jrot.axis_angle_to_matrix(jnp.asarray(aa))), aa


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


def test_axis_angle_to_matrix():
    aa = RNG.randn(64, 3).astype(np.float32)
    aa[:4] *= 1e-6  # the small-angle branch
    _close(trot.axis_angle_to_matrix(torch.as_tensor(aa)), jrot.axis_angle_to_matrix(jnp.asarray(aa)))


def test_axis_angle_gradient_at_zero_is_finite():
    aa = torch.zeros(2, 3, requires_grad=True)
    trot.axis_angle_to_matrix(aa).sum().backward()
    assert torch.isfinite(aa.grad).all()


@pytest.mark.parametrize("n", [1, 37])
def test_6d_round_trip(n):
    R, _ = _mats(n)
    d6_j = jrot.matrix_to_rotation_6d(jnp.asarray(R))
    d6_t = trot.matrix_to_rotation_6d(torch.as_tensor(R))
    _close(d6_t, d6_j)
    noisy = np.asarray(d6_j) + 0.1 * RNG.randn(n, 6).astype(np.float32)
    _close(trot.rotation_6d_to_matrix(torch.as_tensor(noisy)),
           jrot.rotation_6d_to_matrix(jnp.asarray(noisy)))


def test_rot_z_and_normalize():
    ang = RNG.randn(5, 7, 1).astype(np.float32)
    _close(trot.rot_z(torch.as_tensor(ang)), jrot.rot_z(jnp.asarray(ang)))
    R, _ = _mats(20)
    R = R + 0.01 * RNG.randn(20, 3, 3).astype(np.float32)
    _close(trot.normalize_rotation(torch.as_tensor(R)), jrot.normalize_rotation(jnp.asarray(R)))


def test_matrix_slerp():
    R0, _ = _mats(30)
    R1, _ = _mats(30)
    R1[:3] = R0[:3]  # the nearly-parallel (lerp) branch
    alpha = RNG.rand(30, 1, 1).astype(np.float32)
    _close(trot.matrix_slerp(torch.as_tensor(R0), torch.as_tensor(R1), torch.as_tensor(alpha)),
           jrot.matrix_slerp(jnp.asarray(R0), jnp.asarray(R1), jnp.asarray(alpha)))


def test_so3_relative_angle():
    R0, _ = _mats(25)
    R1, _ = _mats(25)
    _close(trot.so3_relative_angle(torch.as_tensor(R0), torch.as_tensor(R1)),
           jrot.so3_relative_angle(jnp.asarray(R0), jnp.asarray(R1)))
