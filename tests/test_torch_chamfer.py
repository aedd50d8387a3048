"""Nearest-vertex ops of the PyTorch port against the JAX package.

On the CPU every kernel wrapper runs its plain version; these tests hold
those plain versions to the Pallas kernels they stand for, run as the JAX
package's own tests run them (``interpret=True``, or TPU interpret mode
for ``make_min_grad_y``, which takes no such argument), and the
``min_sqdist`` backward to ``jax.grad`` of the reference's custom VJP (its
XLA scatter).

Tolerances: argmin indices exactly (random clouds have no near-ties);
values 1e-5 (float32 sums of three products in another order); gradients
1e-5 relative to their largest entry."""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from uuo_mocap_tpu.ops import chamfer as jchamfer
from uuo_mocap_tpu.ops.chamfer_pallas import (F_BLOCK, make_min_grad_y, min_sqdist_pallas,
                                              ranked_nearest_pallas)
from uuo_mocap_tpu_torch.ops import chamfer as tchamfer
from uuo_mocap_tpu_torch.ops import chamfer_kernels as K

RNG = np.random.RandomState(13)


def _cloud(*shape, offset=(0.0, 0.0, 0.0)):
    return (RNG.randn(*shape, 3) + np.asarray(offset)).astype(np.float32)


@pytest.mark.parametrize("with_bias", [False, True])
def test_rank_plain_matches_pallas_rank_kernel(with_bias):
    """Ragged F (not a multiple of F_BLOCK), L = 3 lanes, optional per-lane
    subtree exclusion bias."""
    L, F, M, V = 3, 2 * F_BLOCK + 3, 17, 700
    x = _cloud(L, F, M, offset=(1.0, 0.0, -2.0))
    y = _cloud(L, F, V, offset=(1.0, 0.0, -2.0))
    bias = ((RNG.rand(L, V) > 0.6) * 1e10).astype(np.float32) if with_bias else None
    ref = np.stack([np.asarray(ranked_nearest_pallas(
        jnp.asarray(x[l]), jnp.asarray(y[l]), None if bias is None else jnp.asarray(bias[l]),
        interpret=True)) for l in range(L)])
    bias_t = None if bias is None else torch.as_tensor(bias)
    ours = K.rank_nearest_plain(torch.as_tensor(x), torch.as_tensor(y), bias_t)
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the CPU dispatcher is the plain version
    np.testing.assert_array_equal(
        K.rank_nearest(torch.as_tensor(x), torch.as_tensor(y), bias_t).numpy(), ref)
    if bias is not None:
        assert (bias[np.arange(L)[:, None, None], ours.numpy()] == 0).all()


@pytest.mark.parametrize("M, V", [(41, 60), (60, 41), (50, 50)])
def test_min_sqdist_forward_plain_matches_pallas(M, V):
    """Both directions (few queries / many queries) and M = V.  The Pallas
    kernel takes at most 64 queries, so V stays small here; the Hopper
    kernel has no such limit."""
    B = 4
    x = _cloud(B, M, offset=(2.0, -1.0, 0.5))
    y = _cloud(B, V, offset=(2.0, -1.0, 0.5))
    bias = ((RNG.rand(B, V) > 0.7) * 1e10).astype(np.float32)
    val_j, idx_j = min_sqdist_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(bias),
                                     interpret=True)
    val_t, idx_t = K.min_sqdist_forward(torch.as_tensor(x), torch.as_tensor(y),
                                        torch.as_tensor(bias))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), atol=1e-5, rtol=0)


def test_min_sqdist_reverse_plain_matches_jax_xla_path():
    """The many-query direction at the main path's shape (6890 vertices
    against 41 markers, a few batch elements), beyond the Pallas kernel's
    64 queries: the plain version against the reference's XLA forward
    (``_min_sqdist_fwd``'s argmin and ``min_sqdist``'s value), with the
    reverse direction's bias (1e10 on occluded markers).  Indices exactly
    (random clouds have no near-ties); values 1e-5."""
    rng = np.random.RandomState(29)  # its own stream: RNG's later draws stay as they were
    B, M, V = 3, 6890, 41
    verts = (rng.randn(B, M, 3) * 0.3 + [0.4, 1.1, -0.2]).astype(np.float32)
    markers = (rng.randn(B, V, 3) * 0.3 + [0.4, 1.1, -0.2]).astype(np.float32)
    bias = ((rng.rand(B, V) > 0.9) * 1e10).astype(np.float32)
    val_ref, (_, _, idx_ref) = jchamfer._min_sqdist_fwd(jnp.asarray(verts), jnp.asarray(markers),
                                                        jnp.asarray(bias))
    val_j = jchamfer.min_sqdist(jnp.asarray(verts), jnp.asarray(markers), jnp.asarray(bias))
    val_t, idx_t = K.min_sqdist_forward(torch.as_tensor(verts), torch.as_tensor(markers),
                                        torch.as_tensor(bias))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_ref))
    assert (bias[np.arange(B)[:, None], idx_t.numpy()] == 0).all()
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_ref), atol=1e-5, rtol=0)


def test_min_sqdist_backward_matches_jax_grad():
    B, M, V = 3, 23, 300
    x = _cloud(B, M)
    y = _cloud(B, V)
    bias = (RNG.rand(B, V) * 0.1).astype(np.float32)
    w = RNG.randn(B, M).astype(np.float32)

    def jloss(x_, y_, b_):
        return jnp.sum(w * jchamfer.min_sqdist(x_, y_, b_))

    gx, gy, gb = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y), jnp.asarray(bias))
    xt, yt, bt = (torch.as_tensor(a).requires_grad_(True) for a in (x, y, bias))
    (torch.as_tensor(w) * tchamfer.min_sqdist(xt, yt, bt)).sum().backward()
    for ours, ref in ((xt.grad, gx), (yt.grad, gy), (bt.grad, gb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_backward_plain_is_the_scatter():
    B, M, V = 2, 30, 40  # V small: many rows land on the same target
    idx = torch.as_tensor(RNG.randint(0, V, size=(B, M)))
    diff = torch.as_tensor(RNG.randn(B, M, 3).astype(np.float32))
    g = torch.as_tensor(RNG.randn(B, M).astype(np.float32))
    dy, db = K.min_sqdist_backward(idx, diff, g, V)
    ref_dy, ref_db = np.zeros((B, V, 3), np.float32), np.zeros((B, V), np.float32)
    for b in range(B):
        for m in range(M):
            ref_dy[b, idx[b, m]] -= diff[b, m].numpy()
            ref_db[b, idx[b, m]] += g[b, m].numpy()
    np.testing.assert_allclose(dy.numpy(), ref_dy, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), ref_db, atol=1e-6)


@pytest.mark.parametrize("B, M, V", [(2, 30, 40), (3, 64, 7), (5, 41, 600), (1, 17, 513)])
def test_backward_plain_matches_pallas_bwd_kernel(B, M, V):
    """The plain scatter against the Pallas ``_bwd_kernel`` (its one-hot
    matmul), run in TPU interpret mode on the CPU.  V small against M, so
    many rows share a target.  Tolerance 1e-6: both add the same float32
    terms (O(1), at most ~10 per target), only possibly in another order,
    which moves a sum by a few ulps."""
    rng = np.random.RandomState(B * M + V)  # its own stream: RNG's later draws stay as they were
    idx = rng.randint(0, V, size=(B, M)).astype(np.int32)
    diff = rng.randn(B, M, 3).astype(np.float32)
    g = rng.randn(B, M).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        dy_j, db_j = make_min_grad_y(V)(jnp.asarray(idx), jnp.asarray(diff), jnp.asarray(g))
    dy, db = K.min_sqdist_backward_plain(torch.as_tensor(idx), torch.as_tensor(diff),
                                         torch.as_tensor(g), V)
    np.testing.assert_allclose(dy.numpy(), np.asarray(dy_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("single_directional", [True, False])
def test_masked_chamfer_vertex_subset_matches_jax(single_directional):
    F, M, V = 5, 12, 400
    x = _cloud(F, M)
    y = _cloud(F, V)
    x[1, 3] = 0.0  # an occluded marker
    x_mask = (np.abs(x).sum(-1) != 0).astype(np.float32)
    y_mask = (RNG.rand(V) > 0.5).astype(np.float32)
    ref = jchamfer.masked_chamfer_vertex_subset(jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_mask),
                                                jnp.asarray(y_mask), single_directional)
    ours = tchamfer.masked_chamfer_vertex_subset(torch.as_tensor(x), torch.as_tensor(y),
                                                 torch.as_tensor(x_mask), torch.as_tensor(y_mask),
                                                 single_directional)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    # lane-batched form: one value per lane, each the reference's scalar
    L = 3
    yl = _cloud(L, F, V)
    masks = (RNG.rand(L, V) > 0.5).astype(np.float32)
    per_lane = tchamfer.masked_chamfer_vertex_subset(
        torch.as_tensor(x), torch.as_tensor(yl), torch.as_tensor(x_mask),
        torch.as_tensor(masks[:, None, :]), single_directional, batch_dims=1)
    for l in range(L):
        ref_l = jchamfer.masked_chamfer_vertex_subset(
            jnp.asarray(x), jnp.asarray(yl[l]), jnp.asarray(x_mask), jnp.asarray(masks[l]),
            single_directional)
        np.testing.assert_allclose(float(per_lane[l]), float(ref_l), rtol=1e-5)


@pytest.mark.parametrize("single_directional", [True, False])
def test_masked_chamfer_matches_jax(single_directional):
    F, M, V = 4, 10, 300
    x, y = _cloud(F, M), _cloud(F, V)
    w = (RNG.rand(F, M) > 0.2).astype(np.float32)
    ref = jchamfer.masked_chamfer(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), single_directional)
    ours = tchamfer.masked_chamfer(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(w),
                                   single_directional)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


def test_mean_nearest_vertex_over_frames_matches_jax():
    F, M, V = 9, 12, 500
    markers = _cloud(F, M, offset=(0.5, 0.5, 0.5))
    verts = _cloud(F, V, offset=(0.5, 0.5, 0.5))
    mask = (RNG.rand(F) > 0.3).astype(np.float32)
    ref = jchamfer.mean_nearest_vertex_over_frames(jnp.asarray(markers), jnp.asarray(verts),
                                                   jnp.asarray(mask))
    ours = tchamfer.mean_nearest_vertex_over_frames(torch.as_tensor(markers), torch.as_tensor(verts),
                                                    torch.as_tensor(mask))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # lane-batched vertices [A, F, V, 3]
    verts_l = np.stack([verts, _cloud(F, V)])
    ours_l = tchamfer.mean_nearest_vertex_over_frames(
        torch.as_tensor(markers), torch.as_tensor(verts_l), torch.as_tensor(mask))
    np.testing.assert_array_equal(ours_l[0].numpy(), np.asarray(ref))


def test_nearest_vertex_matches_jax():
    x, y = _cloud(3, 8, offset=(4.0, 0.0, 1.0)), _cloud(3, 200, offset=(4.0, 0.0, 1.0))
    ref_v, ref_i = jchamfer.nearest_vertex(jnp.asarray(x), jnp.asarray(y))
    val, idx = tchamfer.nearest_vertex(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(val.numpy(), np.asarray(ref_v), atol=1e-5, rtol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    x = torch.zeros(1, 2, 4, 3)
    with pytest.raises(ValueError):
        K.rank_nearest_cuda(x, torch.zeros(1, 2, 5, 3))
    with pytest.raises(ValueError):
        K.min_sqdist_forward_cuda(torch.zeros(2, 4, 3), torch.zeros(2, 5, 3), torch.zeros(2, 5))
    with pytest.raises(ValueError):
        K.min_sqdist_backward_cuda(torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 4, 3),
                                   torch.zeros(2, 4), 5)
    with pytest.raises(ValueError):
        K.min_sqdist_forward_cuda(torch.zeros(2, 6, 3), torch.zeros(2, 5, 3), torch.zeros(2, 5))
    assert K.launch_counts() == {"rank_nearest_cuda": 0, "min_sqdist_forward_cuda": 0,
                                 "min_sqdist_forward_rev_cuda": 0, "min_sqdist_backward_cuda": 0}
