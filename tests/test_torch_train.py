"""The port's training loops (``models/train.py``, ``cli/train.py``)
against the JAX package's, on the CPU.

Sizes: the synthetic body (V = 6890); pools of 8-9 sequences (64 surface
samples for the surface maps), batches of 3-16; the segmenters at latent
16, the surface maps at the loops' widths.  The foot-contact and
motion-embedding loops are held in ``test_torch_train_data.py``.
Both packages start from the same flax init, carried across by
``convert.py``; the reference's loop functions are replaced by recorders, so
its own losses, data and init are read.  Tolerances:
  * pools and batches within 1e-5 absolute (labels equal);
  * one pooled update on the reference's own draws: the loss within 1e-5
    relative and each gradient leaf within 1e-4 of its largest magnitude
    plus 1e-7 (float32 sums in another order through up to 12 layers,
    measured <= 1.4e-5; the floor is for the attention key biases, whose
    gradient is 0 but for rounding, read at <= 8e-9 in both packages);
  * Adam on the cosine schedule against optax on the same gradients: the
    schedule within 5e-7 relative (optax evaluates it in float32; measured
    2.5e-7), parameters after 5 steps within 5 float32 ulps, one a step
    (p + update can round to the other neighbour when the update differs
    in its last bit; measured 2 ulps);
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train_models import ATOL, _check_forward, _leaves, _np_tree, _t
from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.models import checkpoints as jckpt
from uuo_mocap_tpu.models import train as jtrain
from uuo_mocap_tpu.models.foot_contact_model import FootContactModel as JaxFootContact
from uuo_mocap_tpu.models.marker_segmenter import MarkerSegmenter as JaxSegmenter
from uuo_mocap_tpu.models.marker_segmenter_multimodal import (
    MarkerSegmenterMultimodal as JaxMultimodal)
from uuo_mocap_tpu.models.pos_diff import PosDiff as JaxPosDiff
from uuo_mocap_tpu_torch import convert
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.models import train as ttrain
from uuo_mocap_tpu_torch.models.checkpoints import load_params

GRAD_REL, GRAD_FLOOR = 1e-4, 1e-7


@pytest.fixture(scope="module")
def bodies():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


# ------------------------------------------------------------------ pools
def _capture(monkeypatch, name):
    """Replace the reference's ``name`` loop function by one that records its
    arguments and returns them as the trained params."""
    seen = {}

    def fake(*args, **kwargs):
        seen["args"] = args
        return args[0] if name == "_fit_pooled" else args[1], [0.0]

    monkeypatch.setattr(jtrain, name, fake)
    return seen


# ------------------------------------------------------------------ pools
def test_segmentation_pool_equals_reference(bodies):
    """9 sequences: a full chunk of 8 and a partial one."""
    jm, tm = bodies
    ref = [np.asarray(a) for a in jtrain._segmentation_pool(jm, 9, 48, seed=5)]
    ours = ttrain.segmentation_pool(tm, 9, 48, seed=5)
    np.testing.assert_allclose(ours.points.numpy(), ref[0], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ours.labels.numpy(), ref[1])
    np.testing.assert_allclose(ours.joints.numpy(), ref[2], rtol=0, atol=ATOL)


# --------------------------------------------------------- one update each
def _grads_as_flax(module):
    clone = copy.deepcopy(module)
    for p, q in zip(clone.parameters(), module.parameters()):
        p.data = q.grad.clone()
    return convert.to_flax(clone)


def _check_grads(module, want, loss, want_loss):
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=ATOL, atol=0)
    got = dict(_leaves(_grads_as_flax(module)))
    for path, g in _leaves(_np_tree(want)):
        atol = GRAD_REL * float(np.abs(g).max()) + GRAD_FLOOR
        np.testing.assert_allclose(got[path], g, rtol=0, atol=atol, err_msg=path)


def _recording_optimizer():
    """An optax transformation that leaves the params and keeps the last
    gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _segmenter_draws(key, P, W, K, batch, M):
    """The reference step's draws for ``key`` (``train.py:_make_pooled_seg_step``
    with inner = 1: one split of the key, then six)."""
    ks, kc, ky, kt, kn, kl = jax.random.split(jax.random.split(key, 1)[0], 6)
    ci = jax.random.randint(kc, (batch, M), 0, K)
    if M <= min(41, K):
        use = jax.random.bernoulli(kl, 0.5, (batch, 1))
        ci = jnp.where(use, jnp.broadcast_to(jnp.arange(M), (batch, M)), ci)
    draws = {"seq": jax.random.randint(ks, (batch,), 0, P), "cols": ci,
             "yaw": jax.random.uniform(ky, (batch,), minval=0.0, maxval=6.2832),
             "shift": jax.random.uniform(kt, (batch, 1, 1, 3), minval=-0.5, maxval=0.5),
             "jitter": jax.random.normal(kn, (batch, W, M, 3))}
    return {k: torch.as_tensor(np.array(v)).long() if k in ("seq", "cols")
            else _t(v) for k, v in draws.items()}


@pytest.mark.parametrize("multimodal,num_markers", [(False, 12), (True, 50)])
def test_segmenter_update_on_reference_draws(bodies, multimodal, num_markers):
    jm, _ = bodies
    pool = jtrain._segmentation_pool(jm, 8, 64, seed=7)
    jnet = JaxMultimodal(latent_dim=16) if multimodal else JaxSegmenter(latent_dim=16)
    init_args = (jnp.zeros((1, 32, num_markers, 3)),) + (
        (jnp.zeros((1, 32, 22, 3)),) if multimodal else ())
    params = jnet.init(jax.random.PRNGKey(4), *init_args)
    step = jtrain._make_pooled_seg_step(jnet, _recording_optimizer(), pool, 3, num_markers,
                                        multimodal, inner=1)
    key = jax.random.PRNGKey(19)
    _, grads, loss = step(params, _recording_optimizer().init(params), key)
    build = (convert.marker_segmenter_multimodal_from_flax if multimodal
             else convert.marker_segmenter_from_flax)
    net = build(_np_tree(params), "cpu", trainable=True)
    tpool = ttrain.SegmentationPool(_t(pool[0]), torch.as_tensor(np.asarray(pool[1])).long(),
                                    _t(pool[2]))
    P, W, K, _ = pool[0].shape
    draws = _segmenter_draws(key, P, W, K, 3, num_markers)
    got = ttrain.segmenter_loss(net, tpool, draws, multimodal)
    got.backward()
    _check_grads(net, grads, got, loss)
    # the port's own draws have the reference's shapes, dtypes and ranges
    ours = ttrain.segmenter_draws(torch.Generator().manual_seed(1), tpool, 3, num_markers)
    for k, v in draws.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
    assert int(ours["cols"].max()) < K and float(ours["yaw"].max()) < 6.2832
    assert float(ours["shift"].abs().max()) <= 0.5


def _reference_pooled_loss(monkeypatch, train, **kwargs):
    """The reference loop's (params, loss_from_key, its closure) and the key
    of its first step, from ``train(**kwargs)`` with a recording loop function."""
    seen = _capture(monkeypatch, "_fit_pooled")
    train(**kwargs)
    params, loss_from_key = seen["args"][:2]
    key = jax.random.split(jax.random.PRNGKey(23), 1)[0]
    return params, loss_from_key, inspect.getclosurevars(loss_from_key).nonlocals, key


@pytest.mark.parametrize("name", ["pos2bc", "pos_diff"])
def test_surface_map_update_on_reference_draws(bodies, monkeypatch, name):
    jm, _ = bodies
    batch = 6
    train = jtrain.train_pos2bc if name == "pos2bc" else jtrain.train_pos_diff
    params, loss_from_key, closure, key = _reference_pooled_loss(
        monkeypatch, train, body=jm, steps=1, batch=batch, seed=2, pool_n=64)
    want_loss, grads = jax.value_and_grad(loss_from_key)(params, key)
    idx = torch.as_tensor(np.array(jax.random.randint(key, (batch,), 0, 64))).long()
    if name == "pos2bc":
        net = convert.pos2bc_from_flax(_np_tree(params), "cpu", trainable=True)
        pool = (_t(closure["pts_p"]), torch.as_tensor(np.array(closure["fv_p"])).long(),
                _t(closure["bary_p"]))
        got = ttrain.pos2bc_loss(net, pool, idx)
    else:
        net = convert.pos_diff_from_flax(_np_tree(params), "cpu", trainable=True)
        got = ttrain.pos_diff_loss(net, (_t(closure["q_p"]), _t(closure["t_p"])), idx)
    got.backward()
    _check_grads(net, grads, got, want_loss)


# --------------------------------------------------------------- optimizer
def test_adam_on_cosine_schedule_matches_optax():
    rng = np.random.RandomState(12)
    shapes = [(5, 3), (3,), (2, 4, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    # gradients over six orders of magnitude, near-zero ones included
    grads = [[(rng.randn(*s) * 10.0 ** rng.randint(-6, 1, s)).astype(np.float32)
              for s in shapes] for _ in range(5)]
    steps, lr = 5, 1e-2
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.05)
    ours_sched = ttrain.cosine_decay(lr, steps)
    for c in range(8):
        np.testing.assert_allclose(ours_sched(c), float(sched(c)), rtol=5e-7)
    opt = optax.adam(sched)
    state = opt.init(params)
    jp = [jnp.asarray(p) for p in params]
    tp = [_t(p).clone().requires_grad_(True) for p in params]
    adam = ttrain.Adam(tp, ours_sched, steps)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = _t(x)
        adam.step()
    for p, q in zip(tp, jp):
        q = np.asarray(q)
        ulps = np.abs(p.detach().numpy() - q) / np.spacing(np.abs(q))
        assert ulps.max() <= 5, ulps.max()
    assert int(adam.t) == 5


@pytest.mark.parametrize("steps", [1, 3, 9, 30, 250, 6000])
def test_chunk_and_history_contract(steps):
    inner = max(1, min(50, steps // 4))
    assert ttrain.chunking(steps) == (max(1, steps // inner), inner)


def test_pooled_loop_history_and_init(bodies):
    """``train_pos_diff`` at 9 steps: 4 chunks of 2, one history entry each;
    the flax-style init draws LeCun-normal kernels (truncated at 2 sigma)."""
    _, tm = bodies
    net, hist = ttrain.train_pos_diff(tm, steps=9, batch=16, seed=1, pool_n=64)
    assert len(hist) == 4 and np.all(np.isfinite(hist))
    fresh = ttrain.flax_init_(type(net)(), seed=0)
    w = fresh.fc1.weight.detach().numpy()
    std = np.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    assert np.abs(w).max() <= 2 * std and abs(w.std() / (std * 0.87962566103423978) - 1) < 0.05
    assert np.all(fresh.fc1.bias.detach().numpy() == 0)
    again = ttrain.flax_init_(type(net)(), seed=0)
    assert torch.equal(again.fc0.weight, fresh.fc0.weight)


# -------------------------------------------------------------------- CLI
def test_cli_train_cpu_only_writes_checkpoints_both_packages_load(tmp_path):
    from uuo_mocap_tpu_torch.cli import train as cli

    root = str(tmp_path / "ck")
    hist = cli.main(["--cpu_only", "--models", "foot_contact", "pos_diff", "--steps", "4",
                     "--checkpoints", root, "--body_models", str(tmp_path / "none")])
    assert sorted(hist) == ["foot_contact", "pos_diff"]
    assert len(hist["foot_contact"]) == 4 and len(hist["pos_diff"]) == 4
    rng = np.random.RandomState(0)
    for name, ckpt, jnet, build, x in (
            ("foot_contact", "foot_contact", JaxFootContact(), convert.foot_contact_from_flax,
             (rng.randn(2, 20, 22, 3) * 0.3).astype(np.float32)),
            ("pos_diff", "barycentric_coords/pos_diff", JaxPosDiff(), convert.pos_diff_from_flax,
             (rng.randn(9, 3) * 0.5).astype(np.float32))):
        template = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
        restored = _np_tree(jckpt.load_params(template, root, ckpt))
        ours = load_params(root, ckpt)
        for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(restored),
                                  jax.tree_util.tree_leaves_with_path(ours)):
            assert np.array_equal(a, b), p
        _check_forward(name, jnet, restored, build(ours, "cpu"), (x,))


def test_cli_train_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from uuo_mocap_tpu_torch.cli import train as cli

    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--models", "foot_contact", "--steps", "1", "--checkpoints",
                  str(tmp_path / "ck")])
    assert not os.path.exists(tmp_path / "ck")
