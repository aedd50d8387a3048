"""The foot-contact and motion-embedding loops of the port
(``models/train.py``) against the JAX package's, on the CPU: their data,
one update on the reference's own batch and draws, and the foot-contact
loop from the reference's init.

Sizes: the synthetic body; batches of 2 motions of 20 frames (foot
contact), a pool of 8 windows of 8 frames x 10 markers (motion
embedding), both nets at the loops' widths.  The reference's loop functions
are replaced by recorders, so its own data, losses and init are read.
Tolerances: as ``test_torch_train.py`` (data within 1e-5 absolute, labels
equal; losses within 1e-5 relative, gradients within 1e-4 of each leaf's
largest magnitude plus 1e-7); the foot-contact history over 3 steps within
1e-4 relative (measured 1.3e-6).
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_train import (  # noqa: F401  (bodies: a fixture)
    _capture, _check_grads, _reference_pooled_loss, bodies)
from test_torch_train_models import ATOL, _np_tree, _t
from uuo_mocap_tpu.models import train as jtrain
from uuo_mocap_tpu.models.foot_contact_model import FootContactModel as JaxFootContact
from uuo_mocap_tpu_torch import convert
from uuo_mocap_tpu_torch.models import train as ttrain

FRAMES, BATCH = 20, 2


def _reference_foot_contact(monkeypatch, jm, seed):
    """(init params, loss_fn, make_batch) of the reference loop."""
    seen = _capture(monkeypatch, "_fit")
    jtrain.train_foot_contact(jm, steps=1, batch=BATCH, frames=FRAMES, seed=seed)
    return seen["args"][1:4]


def test_foot_contact_batches_equal_reference(bodies, monkeypatch):
    jm, tm = bodies
    _, _, make_batch = _reference_foot_contact(monkeypatch, jm, seed=3)
    for i in (0, 1):
        want_j, want_l = make_batch(i)
        jts, labels = ttrain.foot_contact_batch(tm, i, BATCH, FRAMES, 3)
        np.testing.assert_allclose(jts.numpy(), np.asarray(want_j), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))


def test_foot_contact_update_on_reference_batch(bodies, monkeypatch):
    jm, _ = bodies
    params, loss_fn, make_batch = _reference_foot_contact(monkeypatch, jm, seed=1)
    batch = make_batch(0)
    want_loss, grads = jax.value_and_grad(loss_fn)(params, batch)
    net = convert.foot_contact_from_flax(_np_tree(params), "cpu", trainable=True)
    got = ttrain.foot_contact_loss(net, _t(batch[0]), _t(batch[1]))
    got.backward()
    _check_grads(net, grads, got, want_loss)


def test_train_foot_contact_from_reference_init(bodies):
    jm, tm = bodies
    _, want = jtrain.train_foot_contact(jm, steps=3, batch=BATCH, frames=FRAMES, seed=1)
    init = _np_tree(JaxFootContact().init(jax.random.PRNGKey(1),
                                          jnp.zeros((1, FRAMES, 22, 3))))
    net, hist = ttrain.train_foot_contact(tm, steps=3, batch=BATCH, frames=FRAMES, seed=1,
                                          init=init)
    assert len(hist) == 3
    np.testing.assert_allclose(hist, want, rtol=1e-4)
    assert not net.training


def _reference_motion_embedding(monkeypatch, jm, batch):
    """(init params, loss_from_key, its closure, the first step's key)."""
    return _reference_pooled_loss(monkeypatch, jtrain.train_motion_embedding, body=jm,
                                  steps=1, batch=batch, window=8, num_markers=10, seed=2,
                                  pool_seqs=8)


def test_motion_embedding_pool_and_update_on_reference_draws(bodies, monkeypatch):
    jm, tm = bodies
    batch = 6
    params, loss_from_key, closure, key = _reference_motion_embedding(monkeypatch, jm, batch)
    pts, jts = ttrain.motion_embedding_pool(tm, 8, 8, 10, seed=2)
    np.testing.assert_allclose(pts.numpy(), np.asarray(closure["pts_pool"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(jts.numpy(), np.asarray(closure["jts_pool"]), rtol=0, atol=ATOL)

    want_loss, grads = jax.value_and_grad(loss_from_key)(params, key)
    params = _np_tree(params)
    idx = torch.as_tensor(np.array(jax.random.permutation(key, 8)[:batch])).long()
    m_net = convert.motion_embedding_from_flax(params["m"], "cpu", trainable=True)
    j_net = convert.motion_embedding_from_flax(params["j"], "cpu", trainable=True, joints=True)
    got = ttrain.info_nce_loss(m_net, j_net, (_t(closure["pts_pool"]), _t(closure["jts_pool"])),
                               idx)
    got.backward()
    _check_grads(m_net, grads["m"], got, want_loss)
    _check_grads(j_net, grads["j"], got, want_loss)
    perm = ttrain.permutation_draws(torch.Generator().manual_seed(0), 12, batch)
    assert len(set(perm.tolist())) == batch  # without replacement
