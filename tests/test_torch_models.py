"""The port's learned models against the JAX package's, on the CPU.

The networks (``uuo_mocap_tpu_torch/models``) are built by ``convert.py``
from the same flax params trees: the shipped checkpoints, read by the
port's own msgpack reader, and random flax inits at a narrow width (latent
16).  Inputs are numpy from fixed seeds.  Tolerances:
  * the reader: every leaf equals ``flax.serialization.msgpack_restore``'s,
    bit for bit, dtype included;
  * segmenter logits within 1e-4, softmax within 1e-5 (float32 sums in
    another order), labels equal wherever the top-2 margin is above 1e-4
    (the tests count the markers within it: the ties);
  * PosDiff and Pos2BC within 1e-5 of the output's largest magnitude; both
    SDF maps within 1e-5;
  * the held-out data within 1e-5 (labels equal); accuracies equal but for
    counted ties; the Pos2BC error and PosDiff reduction within 1e-4
    relative at n = 256.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.models import sdf as jsdf
from uuo_mocap_tpu.models import train as jtrain
from uuo_mocap_tpu.models.marker_segmenter import MarkerSegmenter as JaxSegmenter
from uuo_mocap_tpu.models.marker_segmenter_multimodal import (
    MarkerSegmenterMultimodal as JaxMultimodal)
from uuo_mocap_tpu.models.pos2bc import Pos2BC as JaxPos2BC
from uuo_mocap_tpu.models.pos_diff import PosDiff as JaxPosDiff
from uuo_mocap_tpu.models.pos_diff import fourier_features as jax_fourier_features
from uuo_mocap_tpu.ops.point_mesh import point_mesh_distance
from uuo_mocap_tpu_torch import convert
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.models import heldout
from uuo_mocap_tpu_torch.models import sdf as tsdf
from uuo_mocap_tpu_torch.models.checkpoints import checkpoint_path, load_params
from uuo_mocap_tpu_torch.models.msgpack_io import unpackb
from uuo_mocap_tpu_torch.models.pos_diff import fourier_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
NAMES = ["marker_segmenter", "marker_segmenter_multimodal", "barycentric_coords/pos2bc",
         "barycentric_coords/pos_diff"]
LOGIT_ATOL, PROB_ATOL, MARGIN = 1e-4, 1e-5, 1e-4
RNG = np.random.RandomState(53)


@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_variables(kind, width):
    """The flax variables of one segmenter: the shipped checkpoint
    ("shipped") or a random init at latent 16 ("random")."""
    multimodal = kind == "multimodal"
    name = "marker_segmenter_multimodal" if multimodal else "marker_segmenter"
    if width == "shipped":
        return (JaxMultimodal() if multimodal else JaxSegmenter()), load_params(CKPT, name)
    net = JaxMultimodal(latent_dim=16) if multimodal else JaxSegmenter(latent_dim=16)
    args = (jnp.zeros((1, 32, 5, 3)),) + ((jnp.zeros((1, 32, 22, 3)),) if multimodal else ())
    return net, _tree_np(net.init(jax.random.PRNGKey(11), *args))


def _check_probs(ours, ref, what):
    """Softmax within PROB_ATOL, labels equal outside the near-ties (top-2
    margin <= MARGIN) -> the count of ties."""
    np.testing.assert_allclose(ours, ref, rtol=0, atol=PROB_ATOL, err_msg=what)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    np.testing.assert_array_equal(ours.argmax(-1)[clear], ref.argmax(-1)[clear], err_msg=what)
    return int((~clear).sum())


@pytest.mark.parametrize("name", NAMES)
def test_reader_matches_flax_msgpack_restore(name):
    with open(checkpoint_path(CKPT, name), "rb") as f:
        data = f.read()
    ref = jax.tree_util.tree_leaves_with_path(serialization.msgpack_restore(data))
    ours = jax.tree_util.tree_leaves_with_path(unpackb(data))
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path
    # load_params casts every leaf to float32, as the reference's template does
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(load_params(CKPT, name)), ref):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b, np.float32))


def test_reader_rejects_other_types_and_missing_files(tmp_path):
    for data, kind in ((b"\x81\xa1a\xcb" + bytes(8), "float64"), (b"\x81\xa1a\xc0", "nil"),
                       (b"\x81\xa1a\xd4\x03\x00", "extension type 3")):
        with pytest.raises(ValueError, match=kind):
            unpackb(data)
    with pytest.raises(ValueError, match="trailing"):
        unpackb(b"\x01\x02")
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path), "marker_segmenter")


@pytest.mark.parametrize("width", ["shipped", "random"])
@pytest.mark.parametrize("kind", ["markers", "multimodal"])
def test_segmenters_match_flax(kind, width):
    """Logits of a batch of windows, and ``forward_sequence`` at F = 70 (a
    partial last window) at 30 Hz and at 60 Hz (stride 8)."""
    jnet, variables = _jax_variables(kind, width)
    from_flax = (convert.marker_segmenter_multimodal_from_flax if kind == "multimodal"
                 else convert.marker_segmenter_from_flax)
    net = from_flax(variables, "cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, variables)
    multimodal = kind == "multimodal"
    pts = (RNG.randn(3, 32, 41, 3) * 0.3).astype(np.float32)
    jts = (RNG.randn(3, 32, 22, 3) * 0.3).astype(np.float32)
    args = (pts, jts) if multimodal else (pts,)
    ref = np.asarray(jnet.apply(jparams, *args))
    with torch.no_grad():
        ours = net(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=LOGIT_ATOL)
    ties = _check_probs(torch.softmax(torch.as_tensor(ours), -1).numpy(),
                        np.asarray(jax.nn.softmax(ref, -1)), "windows")
    F = 70
    seq = (RNG.randn(F, 41, 3) * 0.3).astype(np.float32)
    seq_j = (RNG.randn(F, 22, 3) * 0.3).astype(np.float32)
    for freq in (30.0, 60.0):
        sargs = (seq, seq_j) if multimodal else (seq,)
        ref_p = np.asarray(jnet.forward_sequence(jparams, *(jnp.asarray(a) for a in sargs),
                                                 freq=freq))
        with torch.no_grad():
            ours_p = net.forward_sequence(*(torch.as_tensor(a) for a in sargs), freq=freq).numpy()
        assert ours_p.shape == ref_p.shape == (F, 41, 24)
        ties += _check_probs(ours_p, ref_p, f"forward_sequence at {freq} Hz")
    print(f"{kind} {width}: {ties} near-ties")


@pytest.mark.parametrize("width", ["shipped", "random"])
@pytest.mark.parametrize("kind", ["pos2bc", "pos_diff"])
def test_mlps_match_flax(models, kind, width):
    jm, _ = models
    if width == "shipped":
        jnet = JaxPos2BC(num_vertices=jm.num_vertices) if kind == "pos2bc" else JaxPosDiff()
        variables = load_params(CKPT, f"barycentric_coords/{kind}")
    else:
        jnet = (JaxPos2BC(hidden=16, wide=64, num_vertices=jm.num_vertices) if kind == "pos2bc"
                else JaxPosDiff(hidden=16))
        variables = _tree_np(jnet.init(jax.random.PRNGKey(12), jnp.zeros((1, 3))))
    net = (convert.pos2bc_from_flax if kind == "pos2bc" else convert.pos_diff_from_flax)(
        variables, "cpu")
    x = (RNG.randn(256, 3) * 0.4).astype(np.float32)
    ref = np.asarray(jnet.apply(jax.tree_util.tree_map(jnp.asarray, variables), x))
    with torch.no_grad():
        ours = net(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_fourier_features_match_jax():
    """Up to the highest octave (2^7 pi, ~402 rad at 1 m)."""
    x = np.concatenate([(RNG.randn(64, 3) * 0.5), np.ones((1, 3))]).astype(np.float32)
    ref = np.asarray(jax_fourier_features(jnp.asarray(x), 8))
    ours = fourier_features(torch.as_tensor(x), 8).numpy()
    assert ours.shape == ref.shape == (65, 51)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_sdf_maps_match_jax(models):
    jm, tm = models
    ref = jsdf.SDF(jm, checkpoint_root=CKPT)
    ours = tsdf.SDF(tm, checkpoint_root=CKPT)
    pts = (RNG.randn(41, 3) * 0.3).astype(np.float32)
    oh_ref = np.asarray(ref.points_to_barycentric_one_hot(jnp.asarray(pts)))
    with torch.no_grad():
        oh = ours.points_to_barycentric_one_hot(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(oh, oh_ref, rtol=0, atol=1e-5)
    back_ref = np.asarray(ref.barycentric_one_hot_to_points(jnp.asarray(oh_ref)))
    back = ours.barycentric_one_hot_to_points(torch.as_tensor(oh_ref)).numpy()
    np.testing.assert_allclose(back, back_ref, rtol=0, atol=1e-5)


def test_build_sdf_grid_matches_jax(models):
    jm, tm = models
    ref = jsdf.build_sdf_grid(jm, resolution=(6, 6, 4))
    ours = tsdf.build_sdf_grid(tm, resolution=(6, 6, 4))
    for k in ("lower", "upper", "resolution"):
        np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_allclose(ours["sdf"], ref["sdf"], rtol=0, atol=1e-5)


def test_heldout_batch_and_metrics_match_jax(models):
    """One held-out batch (8 windows of 41 random-vertex markers) and both
    segmenters' accuracy on it; the Pos2BC error and the PosDiff distance
    reduction at n = 256."""
    jm, tm = models
    seed = heldout.HELD_OUT_SEED
    pts_r, labels_r, jts_r = jtrain._segmentation_batch(jm, 8, 41, seed=seed)
    pts, labels, jts = heldout._segmentation_batch(tm, 8, 41, seed=seed)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(labels_r))
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_r), rtol=0, atol=1e-5)
    np.testing.assert_allclose(jts.numpy(), np.asarray(jts_r), rtol=0, atol=1e-5)
    for kind in ("markers", "multimodal"):
        jnet, variables = _jax_variables(kind, "shipped")
        net = (convert.marker_segmenter_multimodal_from_flax if kind == "multimodal"
               else convert.marker_segmenter_from_flax)(variables, "cpu")
        args_r = (pts_r, jts_r) if kind == "multimodal" else (pts_r,)
        logits_r = np.asarray(jnet.apply(jax.tree_util.tree_map(jnp.asarray, variables), *args_r))
        with torch.no_grad():
            logits = (net(pts, jts) if kind == "multimodal" else net(pts)).numpy()
        ties = _check_probs(torch.softmax(torch.as_tensor(logits), -1).numpy(),
                            np.asarray(jax.nn.softmax(logits_r, -1)), kind)
        lab = np.asarray(labels_r)
        acc_r = float((logits_r.argmax(-1) == lab).mean())
        acc = float((logits.argmax(-1) == lab).mean())
        assert abs(acc - acc_r) <= ties / lab.size, (kind, acc, acc_r, ties)
    n = 256
    net = convert.pos2bc_from_flax(load_params(CKPT, "barycentric_coords/pos2bc"), "cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, load_params(CKPT, "barycentric_coords/pos2bc"))
    pts_s, _, _ = jtrain._surface_samples(jm, n, seed=seed)
    probs = jax.nn.softmax(JaxPos2BC(num_vertices=jm.num_vertices).apply(jparams, pts_s), -1)
    err_r = float(jnp.mean(jnp.linalg.norm(probs @ jm.v_template - pts_s, axis=-1)))
    np.testing.assert_allclose(heldout.eval_pos2bc(tm, net, n=n), err_r, rtol=1e-4)
    variables = load_params(CKPT, "barycentric_coords/pos_diff")
    q_r, tgt_r = jtrain.pos_diff_pool(jm, n, 0.05, seed)
    q, tgt = heldout.pos_diff_pool(tm, n, 0.05, seed)
    np.testing.assert_array_equal(q, q_r)
    np.testing.assert_allclose(tgt, tgt_r, rtol=0, atol=1e-5)
    pred_r = np.asarray(JaxPosDiff().apply(jax.tree_util.tree_map(jnp.asarray, variables), q_r))
    def mean_dist(p):
        return float(np.mean(np.asarray(point_mesh_distance(
            jnp.asarray(p), jnp.asarray(jm.v_template), jnp.asarray(jm.faces))["distance"])))

    red_r = 1.0 - mean_dist(q_r + pred_r) / mean_dist(q_r)
    after, before = heldout.eval_pos_diff(tm, convert.pos_diff_from_flax(variables, "cpu"), n=n)
    np.testing.assert_allclose(1.0 - after / before, red_r, rtol=1e-4)
