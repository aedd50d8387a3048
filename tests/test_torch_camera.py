"""The HMR crop camera (``camera/hmr.py``): the port against the JAX
package on the CPU, on seeded inputs at F = 8 frames, to 1e-5 relative.

The inputs reach the reference's edge cases: one frame's point sits at a
depth of -5e-10 (inside the 1e-9 clamp, which drops the sign), image sides
of odd difference (the square pad's offsets are floor divisions of float
sizes) and a longer side of 640.5 and 641.5 (the pad side is rounded half
to even).
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_batch_solver import models  # noqa: F401  (a fixture)
from uuo_mocap_tpu.body.model import lbs_forward as jax_lbs_forward
from uuo_mocap_tpu.camera import hmr as jhmr
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu_torch.body.model import lbs_forward
from uuo_mocap_tpu_torch.camera import hmr as thmr

F = 8
RTOL = 1e-5
RNG = np.random.RandomState(17)


def _close(ours, ref, what):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-6, err_msg=what)


def _rotations(n):
    aa = RNG.randn(n, 3).astype(np.float32) * 0.5
    return np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))


def test_perspective_projection_matches_jax():
    points = RNG.randn(F, 45, 3).astype(np.float32)
    trans = (RNG.randn(F, 3) + [0.0, 0.0, 6.0]).astype(np.float32)
    points[3, 7, 2], trans[3, 2] = 0.0, -5e-10  # a depth inside the clamp, negative
    focal = RNG.uniform(10, 30, (F, 2)).astype(np.float32)
    center = RNG.randn(F, 2).astype(np.float32)
    rotation = _rotations(F)
    for kw in ({}, {"camera_center": center}, {"camera_center": center, "rotation": rotation}):
        ref = jhmr.perspective_projection(jnp.asarray(points), jnp.asarray(trans),
                                          jnp.asarray(focal),
                                          **{k: jnp.asarray(v) for k, v in kw.items()})
        ours = thmr.perspective_projection(torch.as_tensor(points), torch.as_tensor(trans),
                                           torch.as_tensor(focal),
                                           **{k: torch.as_tensor(v) for k, v in kw.items()})
        _close(ours, ref, str(sorted(kw)))
        if not kw:  # the clamped point: x, y over +1e-9, not -5e-10
            np.testing.assert_allclose(ours[3, 7].numpy(),
                                       (points[3, 7, :2] + trans[3, :2]) / 1e-9 * focal[3],
                                       rtol=RTOL)


def test_get_3d_parameters_matches_jax(models):
    jm, tm = models
    betas = (RNG.randn(F, 10) * 0.5).astype(np.float32)
    pose = _rotations(F * 23).reshape(F, 23, 3, 3)
    root = _rotations(F).reshape(F, 1, 3, 3)
    cam = np.stack([RNG.uniform(0.03, 0.08, F), RNG.randn(F) * 0.1, RNG.randn(F) * 0.1],
                   -1).astype(np.float32)
    center = RNG.uniform(100, 500, (F, 2)).astype(np.float32)
    size = np.array([[480, 640], [481, 640], [640.5, 480], [641.5, 480], [720, 1280],
                     [479, 480], [300, 301], [1080, 1920]], np.float32)
    scale = RNG.uniform(100, 300, (F, 1)).astype(np.float32)
    ref = jhmr.get_3d_parameters(lambda *a: jax_lbs_forward(jm, *a), *(jnp.asarray(a) for a in (
        betas, pose, root, cam, center, size, scale)))
    ours = thmr.get_3d_parameters(lambda *a: lbs_forward(tm, *a), *(torch.as_tensor(a) for a in (
        betas, pose, root, cam, center, size, scale)))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
        _close(ours[k], v, k)


def test_axis_swaps_match_jax_and_invert():
    pos = RNG.randn(F, 5, 3).astype(np.float32)
    for name in ("convert_hmr_pos_to_mocap_pos", "convert_mocap_pos_to_hmr_pos"):
        ours = getattr(thmr, name)(torch.as_tensor(pos))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(getattr(jhmr, name)(jnp.asarray(pos))))
    back = thmr.convert_mocap_pos_to_hmr_pos(thmr.convert_hmr_pos_to_mocap_pos(torch.as_tensor(pos)))
    np.testing.assert_array_equal(back.numpy(), pos)
