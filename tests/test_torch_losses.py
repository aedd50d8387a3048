"""The port's loss library, ``chamfer_bidirectional``, ``chamfer_by_part``,
``closest_point`` and ``geometric_median`` against the JAX package on the
CPU, values and gradients (``torch.autograd`` against ``jax.grad``).

Inputs are numpy-seeded: F = 5 frames, M = 12 markers, a cloud of V = 400
vertices in 6 parts (random labels), joints [F, 24, 3].  The JAX side runs
its XLA route (``UUO_CHAMFER_PALLAS`` unset), as its own tests run it; the
port's kernel wrappers run their plain versions on CPU tensors.  Every
value and gradient is held at rtol 1e-5, atol 1e-7 (float32: the same
arithmetic, sums in another order).  The cases cover parts without markers,
``part_ids`` padded with -1, both directions, a lane axis (L = 3 against a
loop of the reference) and a tie (two markers at one position: both
packages give the lower index the gradient).  ``closest_point``'s distances
are compared squared, at the expansion's 1e-7 m^2 noise floor.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uuo_mocap_tpu.ops import chamfer as jchamfer
from uuo_mocap_tpu.ops import geometry as jgeometry
from uuo_mocap_tpu.settings import MARKER_DISTANCE
from uuo_mocap_tpu.solver import losses as JL
from uuo_mocap_tpu_torch.ops import chamfer as tchamfer
from uuo_mocap_tpu_torch.ops import geometry as tgeometry
from uuo_mocap_tpu_torch.solver import losses as TL

F, M, V, J, P = 5, 12, 400, 24, 6
RTOL, ATOL = 1e-5, 1e-7


def _data(seed=0, lanes=None):
    rng = np.random.RandomState(seed)
    lead = () if lanes is None else (lanes,)
    verts = (rng.randn(*lead, F, V, 3) * 0.3 + [0.0, 0.0, 0.9]).astype(np.float32)
    markers = (verts[..., rng.choice(V, M, replace=False), :]
               + 0.01 * rng.randn(*lead, F, M, 3)).astype(np.float32)
    markers[..., 1, 3, :] = 0.0  # an occluded marker at the origin
    return dict(
        verts=verts, markers=markers,
        weights=(np.abs(markers).sum(-1) != 0).astype(np.float32),
        vertex_labels=rng.randint(0, P, V).astype(np.int32),
        # part 5 has no marker
        marker_labels=rng.randint(0, P - 1, (*lead, M)).astype(np.int32),
        joints=(rng.randn(*lead, F, J, 3) * 0.5 + [0.0, 0.0, 0.3]).astype(np.float32),
        trans=rng.randn(*lead, F, 3).astype(np.float32),
        contacts=rng.rand(*lead, F, 2).astype(np.float32),
        frame_valid=np.array([1, 1, 1, 0, 1], np.float32),
    )


def _jax_vg(f, args, argnums):
    val, grads = jax.jit(jax.value_and_grad(f, argnums=argnums))(*(jnp.asarray(a) for a in args))
    return np.asarray(val), [np.asarray(g) for g in grads]


def _torch_vg(f, args, argnums):
    ts = [torch.as_tensor(np.array(a)) for a in args]
    for i in argnums:
        ts[i].requires_grad_(True)
    val = f(*ts)
    val.sum().backward()
    return val.detach().numpy(), [ts[i].grad.numpy() for i in argnums]


def _check(jf, tf, args, argnums):
    vj, gj = _jax_vg(jf, args, argnums)
    vt, gt = _torch_vg(tf, args, argnums)
    np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
    for i, (a, b) in enumerate(zip(gt, gj)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"gradient {i}")


@pytest.mark.parametrize("single", [True, False])
def test_full_chamfer_loss(single):
    d = _data(1)
    _check(lambda v, m: JL.full_chamfer_loss(m, v, jnp.asarray(d["weights"]), single),
           lambda v, m: TL.full_chamfer_loss(m, v[None], torch.as_tensor(d["weights"]), single)[0],
           (d["verts"], d["markers"]), (0, 1))


PART_IDS = [np.arange(P), np.array([0, 1, 2, 3, 4, 5, -1, -1]), np.array([2, -1, 4])]


@pytest.mark.parametrize("part_ids", PART_IDS, ids=["all", "padded", "subset"])
@pytest.mark.parametrize("single", [True, False])
def test_part_chamfer_loss(part_ids, single):
    d = _data(2)
    lab, vl = d["marker_labels"], d["vertex_labels"]
    _check(lambda v, m: JL.part_chamfer_loss(m, v, jnp.asarray(lab), jnp.asarray(vl),
                                             jnp.asarray(part_ids), single),
           lambda v, m: TL.part_chamfer_loss(m, v[None], torch.as_tensor(lab), torch.as_tensor(vl),
                                             torch.as_tensor(part_ids), single)[0],
           (d["verts"], d["markers"]), (0, 1))


@pytest.mark.parametrize("single", [True, False])
def test_part_chamfer_lanes_match_a_loop_of_the_reference(single):
    d = _data(3, lanes=3)
    vl = d["vertex_labels"]
    tv = torch.as_tensor(d["verts"]).requires_grad_(True)
    out = TL.part_chamfer_loss(torch.as_tensor(d["markers"]), tv, torch.as_tensor(d["marker_labels"]),
                               torch.as_tensor(vl), torch.arange(P), single)
    out.sum().backward()
    for q in range(3):
        vj, (gj,) = _jax_vg(lambda v: JL.part_chamfer_loss(
            jnp.asarray(d["markers"][q]), v, jnp.asarray(d["marker_labels"][q]), jnp.asarray(vl),
            jnp.arange(P), single), (d["verts"][q],), (0,))
        np.testing.assert_allclose(out[q].item(), vj, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tv.grad[q].numpy(), gj, rtol=RTOL, atol=ATOL)


def test_part_chamfer_tie_and_parts_without_markers():
    """Two markers of one part at one position: the lower index takes the
    gradient in both packages.  A part without markers adds nothing."""
    d = _data(4)
    m = d["markers"].copy()
    m[:, 7] = m[:, 2]
    lab = d["marker_labels"].copy()
    lab[7] = lab[2]
    lab[lab == 3] = 0  # parts 3 and 5 now have no marker
    vl = d["vertex_labels"]
    _check(lambda v, mk: JL.part_chamfer_loss(mk, v, jnp.asarray(lab), jnp.asarray(vl),
                                              jnp.arange(P), False),
           lambda v, mk: TL.part_chamfer_loss(mk, v[None], torch.as_tensor(lab),
                                              torch.as_tensor(vl), torch.arange(P), False)[0],
           (d["verts"], m), (0, 1))
    only = TL.part_chamfer_loss(torch.as_tensor(m), torch.as_tensor(d["verts"])[None],
                                torch.as_tensor(lab), torch.as_tensor(vl), torch.tensor([3, 5]),
                                False)
    assert only.item() == 0.0


@pytest.mark.parametrize("single", [True, False])
def test_chamfer_by_part_matches_jax(single):
    d = _data(5)
    vl, lab = d["vertex_labels"], d["marker_labels"]
    _check(lambda v, m: jchamfer.chamfer_by_part(m, v, jnp.asarray(lab), jnp.asarray(vl),
                                                 jnp.arange(P), MARKER_DISTANCE, single),
           lambda v, m: tchamfer.chamfer_by_part(m, v, torch.as_tensor(lab), torch.as_tensor(vl),
                                                 torch.arange(P), MARKER_DISTANCE, single),
           (d["verts"], d["markers"]), (0, 1))


def test_chamfer_bidirectional_matches_jax():
    d = _data(6)
    _check(jchamfer.chamfer_bidirectional, tchamfer.chamfer_bidirectional,
           (d["markers"], d["verts"]), (0, 1))


@pytest.mark.parametrize("masked", [False, True])
def test_ground_losses(masked):
    d = _data(7)
    fv = d["frame_valid"] if masked else None
    jfv = None if fv is None else jnp.asarray(fv)
    tfv = None if fv is None else torch.as_tensor(fv)
    _check(lambda j: JL.ground_loss_joints(j, jfv),
           lambda j: TL.ground_loss_joints(j[None], tfv)[0], (d["joints"],), (0,))
    _check(lambda v: JL.ground_loss_vertices(v, jfv),
           lambda v: TL.ground_loss_vertices(v[None], tfv)[0], (d["verts"],), (0,))


def test_foot_losses():
    d = _data(8)
    d["joints"][2, 10] = d["joints"][1, 10]  # a foot at rest: zero speed
    c = d["contacts"]
    _check(lambda j: JL.foot_contact_loss(j, jnp.asarray(c)),
           lambda j: TL.foot_contact_loss(j[None], torch.as_tensor(c))[0], (d["joints"],), (0,))
    _check(lambda j: JL.foot_velocity_loss(j, jnp.asarray(c)),
           lambda j: TL.foot_velocity_loss(j[None], torch.as_tensor(c))[0], (d["joints"],), (0,))


@pytest.mark.parametrize("masked", [False, True])
def test_velocity_loss(masked):
    d = _data(9)
    fv = d["frame_valid"] if masked else None
    mean = d["markers"].mean(1)
    _check(lambda t: JL.velocity_loss(t, jnp.asarray(mean), None if fv is None else jnp.asarray(fv)),
           lambda t: TL.velocity_loss(t[None], torch.as_tensor(mean),
                                      None if fv is None else torch.as_tensor(fv))[0],
           (d["trans"],), (0,))


def test_lane_axis_of_the_frame_losses():
    """L = 3 lanes, each with its own frame mask, against a loop."""
    d = _data(10, lanes=3)
    fv = np.stack([d["frame_valid"], np.ones(F, np.float32), d["frame_valid"][::-1].copy()])
    t = {k: torch.as_tensor(d[k]) for k in ("joints", "verts", "trans", "contacts", "markers")}
    got = {
        "ground_joints": TL.ground_loss_joints(t["joints"], torch.as_tensor(fv)),
        "ground_vertices": TL.ground_loss_vertices(t["verts"], torch.as_tensor(fv)),
        "foot_contact": TL.foot_contact_loss(t["joints"], t["contacts"]),
        "foot_velocity": TL.foot_velocity_loss(t["joints"], t["contacts"]),
        "velocity": TL.velocity_loss(t["trans"], t["markers"].mean(-2), torch.as_tensor(fv)),
    }
    for q in range(3):
        j = {k: jnp.asarray(d[k][q]) for k in ("joints", "verts", "trans", "contacts", "markers")}
        want = {
            "ground_joints": JL.ground_loss_joints(j["joints"], jnp.asarray(fv[q])),
            "ground_vertices": JL.ground_loss_vertices(j["verts"], jnp.asarray(fv[q])),
            "foot_contact": JL.foot_contact_loss(j["joints"], j["contacts"]),
            "foot_velocity": JL.foot_velocity_loss(j["joints"], j["contacts"]),
            "velocity": JL.velocity_loss(j["trans"], jnp.mean(j["markers"], axis=1),
                                         jnp.asarray(fv[q])),
        }
        for k, v in want.items():
            np.testing.assert_allclose(got[k][q].item(), float(v), rtol=RTOL, atol=ATOL, err_msg=k)


def test_weighted_mse():
    rng = np.random.RandomState(11)
    a, b, w = (rng.randn(F, 7).astype(np.float32) for _ in range(3))
    _check(lambda x: JL.weighted_mse(x, jnp.asarray(b), jnp.asarray(w)),
           lambda x: TL.weighted_mse(x[None], torch.as_tensor(b), torch.as_tensor(w))[0],
           (a,), (0,))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_line_segment_loss(reduction):
    rng = np.random.RandomState(12)
    pts = rng.randn(F, 2, 3).astype(np.float32)
    mk = rng.randn(F, M, 3).astype(np.float32)
    _check(lambda p, m: JL.line_segment_loss(p, m, reduction),
           lambda p, m: TL.line_segment_loss(p[None], m, reduction)[0], (pts, mk), (0, 1))


def test_closest_point_matches_jax():
    d = _data(13)
    for pts, cloud in ((d["markers"][0], d["verts"][0]), (d["markers"], d["verts"])):
        want = jgeometry.closest_point(jnp.asarray(pts), jnp.asarray(cloud))
        got = tgeometry.closest_point(torch.as_tensor(pts), torch.as_tensor(cloud))
        np.testing.assert_array_equal(got["vertex_indices"].numpy(), np.asarray(want["vertex_indices"]))
        # both sides take the root of the |x|^2 + |y|^2 - 2xy expansion, whose
        # float32 cancellation error (~1e-7 m^2, sums in another order) the
        # root scales by 1 / (2 d): compare the squares at that floor
        np.testing.assert_allclose(got["distances"].numpy() ** 2,
                                   np.asarray(want["distances"]) ** 2, rtol=RTOL, atol=1e-7)
        np.testing.assert_array_equal(got["points"].numpy(), np.asarray(want["points"]))


def test_geometric_median_matches_jax():
    rng = np.random.RandomState(14)
    pts = rng.randn(4, 30, 3).astype(np.float32)
    pts[0, :3] = pts[0, 3]  # repeated points: the 1e-8 floor
    want = np.asarray(jgeometry.geometric_median(jnp.asarray(pts)))
    got = tgeometry.geometric_median(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
