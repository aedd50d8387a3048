"""The port's three new model families, its losses and its checkpoint
writer against the JAX package's, on the CPU.

Sizes: nets at latent 16 (Pos2BC 8 -> 16 -> 50), inputs of 2-3 windows
from numpy seeds; both packages start from the same flax init, carried
across by ``convert.py``.  Tolerances (absolute):
  * forwards of the three new families within 1e-5, the attention model's
    within 2e-5 (its LayerNorms divide by a variance of O(1e-2) at latent
    16; measured 4.8e-6), the segmenters' within 1e-4 as in
    ``test_torch_models.py``; ``soft_cross_entropy``, ``sinkhorn`` and
    their gradients within 1e-5; ``compute_offset``'s means within 1e-5 and
    the same offset; the GEMM form of the temporal convolution (used while
    training) within 1e-6 of the convolution;
  * the checkpoint writer byte for byte; ``to_flax(from_flax(v)) == v``
    bit for bit; the JAX ``load_params`` restores the port's file bit for
    bit and both packages' forwards agree on it as above.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from uuo_mocap_tpu.models import checkpoints as jckpt
from uuo_mocap_tpu.models.foot_contact_model import FootContactModel as JaxFootContact
from uuo_mocap_tpu.models.marker_segmenter import MarkerSegmenter as JaxSegmenter
from uuo_mocap_tpu.models.marker_segmenter_multimodal import (
    MarkerSegmenterMultimodal as JaxMultimodal)
from uuo_mocap_tpu.models.marker_tracking import MarkerTrackingAttention as JaxTracking
from uuo_mocap_tpu.models.marker_tracking import PermutationLearningModel as JaxPermutation
from uuo_mocap_tpu.models.marker_tracking import sinkhorn as jax_sinkhorn
from uuo_mocap_tpu.models.motion_embedding import JointEmbedding as JaxJointEmbedding
from uuo_mocap_tpu.models.motion_embedding import MarkerEmbedding as JaxMarkerEmbedding
from uuo_mocap_tpu.models.motion_embedding import TemporalAlignmentModel as JaxAlignment
from uuo_mocap_tpu.models.pos2bc import Pos2BC as JaxPos2BC
from uuo_mocap_tpu.models.pos_diff import PosDiff as JaxPosDiff
from uuo_mocap_tpu.solver.losses import soft_cross_entropy as jax_soft_cross_entropy
from uuo_mocap_tpu_torch import convert
from uuo_mocap_tpu_torch.models.checkpoints import load_params, save_params
from uuo_mocap_tpu_torch.models.marker_tracking import sinkhorn
from uuo_mocap_tpu_torch.models.motion_embedding import TemporalAlignmentModel
from uuo_mocap_tpu_torch.models.msgpack_io import packb
from uuo_mocap_tpu_torch.solver.losses import soft_cross_entropy

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _leaves(tree):
    """[(path string, leaf)] of a params tree."""
    return [(jax.tree_util.keystr(p), x) for p, x in jax.tree_util.tree_leaves_with_path(tree)]


# the eight flax modules at narrow widths: (flax module, port builder, inputs)
def _family(name, rng):
    pts = (rng.randn(2, 32, 6, 3) * 0.3).astype(np.float32)
    jts = (rng.randn(2, 32, 22, 3) * 0.3).astype(np.float32)
    return {
        "marker_segmenter": (JaxSegmenter(latent_dim=16), convert.marker_segmenter_from_flax,
                             (pts,)),
        "marker_segmenter_multimodal": (JaxMultimodal(latent_dim=16),
                                        convert.marker_segmenter_multimodal_from_flax,
                                        (pts, jts)),
        "pos2bc": (JaxPos2BC(hidden=8, wide=16, num_vertices=50), convert.pos2bc_from_flax,
                   ((rng.randn(7, 3) * 0.5).astype(np.float32),)),
        "pos_diff": (JaxPosDiff(hidden=16), convert.pos_diff_from_flax,
                     ((rng.randn(7, 3) * 0.5).astype(np.float32),)),
        "foot_contact": (JaxFootContact(latent_dim=16), convert.foot_contact_from_flax,
                         ((rng.randn(2, 20, 22, 3) * 0.3).astype(np.float32),)),
        "motion_embedding": (JaxMarkerEmbedding(latent_dim=16),
                             convert.motion_embedding_from_flax,
                             ((rng.randn(3, 16, 9, 3) * 0.3).astype(np.float32),)),
        "permutation": (JaxPermutation(latent_dim=16), convert.permutation_model_from_flax,
                        ((rng.randn(2, 4, 6, 3) * 0.3).astype(np.float32),)),
        "tracking_attention": (JaxTracking(latent_dim=16, num_markers=6),
                               convert.marker_tracking_attention_from_flax,
                               ((rng.randn(2, 3, 6, 3) * 0.3).astype(np.float32),)),
    }[name]


FAMILIES = ["marker_segmenter", "marker_segmenter_multimodal", "pos2bc", "pos_diff",
            "foot_contact", "motion_embedding", "permutation", "tracking_attention"]
FORWARD_ATOL = {"tracking_attention": 2e-5, "marker_segmenter": 1e-4,
                "marker_segmenter_multimodal": 1e-4}  # the segmenters: test_torch_models.py


def _flax_init(name, seed=3):
    jnet, build, args = _family(name, np.random.RandomState(seed))
    variables = _np_tree(jnet.init(jax.random.PRNGKey(seed), *args))
    return jnet, build, args, variables


def _check_forward(name, jnet, variables, net, args):
    ref = np.asarray(jnet.apply(jax.tree_util.tree_map(jnp.asarray, variables), *args))
    with torch.no_grad():
        ours = net(*(_t(a) for a in args)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=FORWARD_ATOL.get(name, ATOL))


@pytest.mark.parametrize("name", ["foot_contact", "motion_embedding", "permutation",
                                  "tracking_attention"])
def test_new_families_forward_parity(name):
    jnet, build, args, variables = _flax_init(name)
    _check_forward(name, jnet, variables, build(variables, "cpu"), args)


@pytest.mark.parametrize("k", [3, 5])
def test_temporal_conv_gemm_form_equals_the_convolution(k):
    """While the weights take gradients ``temporal_conv`` runs as a GEMM of
    shifted copies; without, as the convolution: the same values within
    1e-6 (float32 sums in another order)."""
    from uuo_mocap_tpu_torch.models.marker_segmenter import temporal_conv

    torch.manual_seed(k)
    conv = torch.nn.Conv1d(6, 5, k, padding=k // 2)
    x = torch.randn(3, 9, 6)
    gemm = temporal_conv(conv, x)
    with torch.no_grad():
        ref = temporal_conv(conv, x)
    assert gemm.requires_grad and not ref.requires_grad
    np.testing.assert_allclose(gemm.detach().numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_soft_cross_entropy_and_sinkhorn_values_and_gradients():
    rng = np.random.RandomState(5)
    logits = rng.randn(6, 11).astype(np.float32)
    target = rng.dirichlet(np.ones(11), size=6).astype(np.float32)
    target[target < 0.05] = 0.0  # masked entries
    want, want_g = jax.value_and_grad(jax_soft_cross_entropy)(jnp.asarray(logits),
                                                              jnp.asarray(target))
    x = _t(logits).requires_grad_(True)
    got = soft_cross_entropy(x, _t(target))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=0, atol=ATOL)

    scores = (rng.randn(3, 7, 7) * 2).astype(np.float32)
    weights = rng.randn(3, 7, 7).astype(np.float32)
    fn = lambda s: jnp.sum(jax_sinkhorn(s) * weights)  # noqa: E731
    want_p = np.asarray(jax_sinkhorn(jnp.asarray(scores)))
    want_g = np.asarray(jax.grad(fn)(jnp.asarray(scores)))
    s = _t(scores).requires_grad_(True)
    got_p = sinkhorn(s)
    (got_p * _t(weights)).sum().backward()
    np.testing.assert_allclose(got_p.detach().numpy(), want_p, rtol=0, atol=ATOL)
    np.testing.assert_allclose(s.grad.numpy(), want_g, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_p.detach().numpy().sum(-2), 1.0, atol=1e-5)  # columns last


def test_compute_offset_matches():
    rng = np.random.RandomState(8)
    jm, jj = JaxMarkerEmbedding(latent_dim=16), JaxJointEmbedding(latent_dim=16)
    vm = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 12, 3))))
    vj = _np_tree(jj.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 22, 3))))
    markers = (rng.randn(30, 12, 3) * 0.3).astype(np.float32)
    joints = (rng.randn(26, 22, 3) * 0.3).astype(np.float32)
    ref = JaxAlignment(vm, vj, window=8, marker_model=jm, joint_model=jj)
    want_k, want_means = ref.compute_offset(jnp.asarray(markers), jnp.asarray(joints))
    ours = TemporalAlignmentModel(convert.motion_embedding_from_flax(vm, "cpu"),
                                  convert.motion_embedding_from_flax(vj, "cpu", joints=True),
                                  window=8)
    k, means = ours.compute_offset(_t(markers), _t(joints))
    np.testing.assert_allclose(means.numpy(), np.asarray(want_means), rtol=0, atol=ATOL)
    assert k == want_k
    # the tie rule: the first least mean, from the most negative offset up
    ties = TemporalAlignmentModel(ours.marker_net, ours.joint_net, window=8)
    ties.embed_markers = ties.embed_joints = lambda x: torch.ones(5, 4) / 2.0
    k, means = ties.compute_offset(torch.zeros(12, 3, 3), torch.zeros(12, 3, 3))
    assert k == -4 and torch.all(means == 0)


def test_writer_bytes_equal_flax_to_bytes():
    """A params-like tree with the leaves flax writes: float32 and float16
    arrays, an empty array, int64, 1-element arrays; short and long keys,
    maps of more than 15 entries, a payload over 64 KiB."""
    rng = np.random.RandomState(2)
    tree = {"params": {f"Dense_{i}": {"kernel": rng.randn(i + 1, 2 * i + 3).astype(np.float32),
                                      "bias": np.zeros(2 * i + 3, np.float32)}
                       for i in range(20)}}
    tree["params"]["half"] = {"kernel": rng.randn(40, 7).astype(np.float16)}
    tree["params"]["empty"] = {"bias": np.zeros((0, 3), np.float32)}
    tree["params"]["ids"] = {"x": np.arange(70000, dtype=np.int64).reshape(7, 10000)}
    tree["params"]["long_" + "k" * 40] = {"scale": rng.randn(1).astype(np.float32)}
    assert packb(tree) == serialization.to_bytes(tree)


def _jax_template(jnet, args):
    return jnet.init(jax.random.PRNGKey(0), *args)


@pytest.mark.parametrize("name", FAMILIES)
def test_round_trip_and_jax_load_params(name, tmp_path):
    jnet, build, args, variables = _flax_init(name)
    net = build(variables, "cpu")
    back = convert.to_flax(net)
    ref_leaves = _leaves(variables)
    got = dict(_leaves(back))
    assert sorted(got) == sorted(p for p, _ in ref_leaves)
    for path, leaf in ref_leaves:
        assert got[path].dtype == np.float32 and got[path].shape == leaf.shape, path
        assert np.array_equal(got[path], leaf), path
    save_params(back, str(tmp_path), name)
    restored = jckpt.load_params(_jax_template(jnet, args), str(tmp_path), name)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(restored),
                                 jax.tree_util.tree_leaves_with_path(variables)):
        assert np.array_equal(np.asarray(a), b), path
    reread = build(load_params(str(tmp_path), name), "cpu")
    _check_forward(name, jnet, _np_tree(restored), reread, args)
    # trainable builds carry gradients; inference builds are frozen
    assert all(p.requires_grad for p in build(variables, "cpu", trainable=True).parameters())
    assert not any(p.requires_grad for p in net.parameters())
