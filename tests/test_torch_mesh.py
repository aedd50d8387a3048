"""The port's device mesh (``uuo_mocap_tpu_torch/parallel/mesh.py``) and
``MultiSequenceSolver(mesh=)`` against the JAX package on the CPU.

The port's grids name CPU devices (``make_mesh(devices=["cpu"] * 8)``): the
split-and-combine arithmetic runs exactly as across cards.  The JAX side
uses conftest's 8 virtual CPU devices.

Sizes and tolerances:
  * ``make_mesh`` shapes: (4, 2) by default on 8 devices, (8, 1) with
    ``data=8, model=1``, as the reference's;
  * ``make_train_batch``: bit-identical arrays (the same draws);
  * ``sharded_train_step`` at B = 8, F = 3, M = 6 on the synthetic body
    (V = 6890): the loss within rtol 1e-5 and the parameters after one step
    within 1e-6 of the JAX step on its (4, 2) mesh, and of the port's own
    (1, 1) step;
  * ``sharded_hypothesis_solve`` on a seeded per-hypothesis quadratic (8
    hypotheses): the same argmin, the best parameters within 1e-6;
  * the vertex-split reductions (``ops/sharded.py``) against their whole
    versions on one cloud cut in 3 blocks: ids equal, values 1e-6 relative
    (the per-frame nearest distance 2e-6 m^2: its expansion about the
    centroid rounds at a few ulps of |x|^2);
  * the stage closures on a (1, 2) grid against the whole model's (the
    dense branches: part chamfer, ground, both chamfer directions): value
    and gradient 1e-5 relative;
  * ``MultiSequenceSolver`` at 2 sequences x 16 frames x 12 markers, 2 yaw
    hypotheses, 3-iteration stages (``tests/test_model_axis_parity.py``'s
    settings): a (2, 2) grid gives the unsharded solve's
    ``best_hypothesis`` with joints within 2 mm (the JAX package's bound
    for the same transformation), a (1, 1) grid its outputs bit for bit.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.parallel import mesh as jmesh
from uuo_mocap_tpu_torch.body.model import lbs_forward
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.data.config import load_config
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.data.synthetic import (
    generate_markers, perturb_params, random_pose_sequence)
from uuo_mocap_tpu_torch.ops import chamfer as C
from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.ops import sharded
from uuo_mocap_tpu_torch.parallel import mesh as tmesh
from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence
from uuo_mocap_tpu_torch.pipeline.part_fit import PartFitter
from uuo_mocap_tpu_torch.pipeline.stages import SolveStages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "video_mocap.yaml")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 JAX devices")


@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


def cpu_mesh(data, model):
    return tmesh.make_mesh(devices=["cpu"] * (data * model), data=data, model=model)


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("kw", [{}, {"data": 8, "model": 1}])
def test_make_mesh_shapes_match_jax(kw):
    ours = tmesh.make_mesh(8, devices=["cpu"] * 8, **kw)
    ref = jmesh.make_mesh(8, **kw)
    assert ours.shape == dict(ref.shape)
    assert ours.devices.shape == ref.devices.shape
    assert all(d == torch.device("cpu") for d in ours.devices.reshape(-1))
    with pytest.raises(ValueError):
        tmesh.make_mesh(devices=["cpu"] * 6, data=4, model=2)
    if not torch.cuda.is_available():  # no card and no devices=: no mesh
        with pytest.raises(RuntimeError, match="devices="):
            tmesh.make_mesh()


def test_make_train_batch_is_bit_identical(models):
    jm, tm = models
    p_j, b_j = jmesh.make_train_batch(jm, batch=4, frames=3, markers=5, seed=7)
    p_t, b_t = tmesh.make_train_batch(tm, batch=4, frames=3, markers=5, seed=7)
    for ref, ours in ((p_j, p_t), (b_j, b_t)):
        assert set(ref) == set(ours)
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.fixture(scope="module")
def train_step_ref(models):
    """The JAX step on its (4, 2) mesh at B = 8, F = 3, M = 6."""
    jm, _ = models
    params, batch = jmesh.make_train_batch(jm, batch=8, frames=3, markers=6)
    new, loss = jmesh.sharded_train_step(jm, jmesh.make_mesh(8))(params, batch)
    return float(loss), {k: np.asarray(v) for k, v in new.items()}


@pytest.mark.parametrize("reference", ["jax (4, 2)", "port (1, 1)"])
def test_sharded_train_step_matches(models, train_step_ref, reference):
    """The port's step on a (4, 2) CPU grid: the batch split over 4 rows,
    the min over V over 2 vertex blocks each."""
    _, tm = models
    params, batch = tmesh.make_train_batch(tm, batch=8, frames=3, markers=6)
    new, loss = tmesh.sharded_train_step(tm, cpu_mesh(4, 2))(params, batch)
    if reference.startswith("jax"):
        ref_loss, ref_new = train_step_ref
    else:
        ref_p, ref_l = tmesh.sharded_train_step(tm, cpu_mesh(1, 1))(params, batch)
        ref_loss, ref_new = float(ref_l), {k: v.numpy() for k, v in ref_p.items()}
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    for k in ref_new:
        np.testing.assert_allclose(new[k].numpy(), ref_new[k], rtol=0, atol=1e-6, err_msg=k)
    # and SGD descends
    _, loss2 = tmesh.sharded_train_step(tm, cpu_mesh(4, 2))(new, batch)
    assert float(loss2) < float(loss)


def _quadratic_inputs(A=8, n=5, seed=3):
    rng = np.random.RandomState(seed)
    return {"center": rng.randn(A, n).astype(np.float32),
            "curv": (0.5 + rng.rand(A, n)).astype(np.float32),
            "offset": rng.rand(A).astype(np.float32)}


def test_sharded_hypothesis_solve_matches_jax(models):
    """Ten gradient steps on sum(curv (x - center)^2) + offset per
    hypothesis: the reference vmaps one hypothesis, the port runs each
    data block's hypotheses as lanes."""
    jm, tm = models
    inputs = _quadratic_inputs()

    def solve_one(h):  # the reference's per-hypothesis form
        x = jnp.zeros_like(h["center"])
        for _ in range(10):
            x = x - 0.2 * 2 * h["curv"] * (x - h["center"])
        return {"x": x}, jnp.sum(h["curv"] * (x - h["center"]) ** 2) + h["offset"]

    def solve_lanes(h):  # the port's: [A_d, ...] lanes
        x = torch.zeros_like(h["center"])
        for _ in range(10):
            x = x - 0.2 * 2 * h["curv"] * (x - h["center"])
        return {"x": x}, (h["curv"] * (x - h["center"]) ** 2).sum(-1) + h["offset"]

    best_j, scores_j = jmesh.sharded_hypothesis_solve(jm, jmesh.make_mesh(8), solve_one)(
        {k: jnp.asarray(v) for k, v in inputs.items()})
    best_t, scores_t = tmesh.sharded_hypothesis_solve(tm, cpu_mesh(4, 2), solve_lanes)(
        {k: torch.as_tensor(v) for k, v in inputs.items()})
    assert int(torch.argmin(scores_t)) == int(jnp.argmin(scores_j))
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j), rtol=1e-6)
    np.testing.assert_allclose(best_t["x"].numpy(), np.asarray(best_j["x"]), rtol=0, atol=1e-6)


# ------------------------------------------------- the vertex-split reductions

def _cloud(L=2, F=3, M=7, V=50, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(L, F, V, 3, generator=g)
    y[:, :, 7] = y[:, :, 31]  # an exact tie across blocks: the lower id wins
    x = torch.randn(L, F, M, 3, generator=g)
    x[:, :, 0] = y[:, :, 31] + 0.01
    return x, y


def _split(y, bounds=(0, 17, 34, 50)):
    return sharded.VertexShards([y[..., lo:hi, :] for lo, hi in zip(bounds[:-1], bounds[1:])],
                                list(bounds[:-1]), y.device)


REDUCTIONS = ["rank", "rank_bias", "nearest_frames", "mean_nearest", "chamfer_single",
              "chamfer_both", "subset_both", "min_grad"]


@pytest.mark.parametrize("op", REDUCTIONS)
def test_vertex_split_reductions_match_the_whole_cloud(op):
    x, y = _cloud()
    ys = _split(y)
    L, F, V = y.shape[0], y.shape[1], y.shape[2]
    bias = (torch.rand(L, V, generator=torch.Generator().manual_seed(1)) > 0.6).float() * C.BIG
    if op in ("rank", "rank_bias"):
        b = bias if op == "rank_bias" else None
        assert torch.equal(sharded.rank_nearest(x, ys, b), K.rank_nearest_plain(x, y, b))
    elif op == "nearest_frames":
        (d_o, i_o), (d_r, i_r) = C.nearest_vertex_frames(x, ys), C.nearest_vertex_frames(x, y)
        assert torch.equal(i_o, i_r)
        # the value is the expansion |x|^2 + |y|^2 - 2 x.y about the frame's
        # centroid, which the split form sums block by block: their float32
        # rounding differs by a few ulps of |x|^2 (~4 here)
        torch.testing.assert_close(d_o, d_r, rtol=0, atol=2e-6)
    elif op == "mean_nearest":
        mask = torch.tensor([1.0, 0.0, 1.0])
        assert torch.equal(C.mean_nearest_vertex_over_frames(x, ys, mask),
                           C.mean_nearest_vertex_over_frames(x, y, mask))
    elif op.startswith("chamfer"):
        w = (torch.rand(L, F, x.shape[2], generator=torch.Generator().manual_seed(2)) > 0.2).float()
        single = op == "chamfer_single"
        torch.testing.assert_close(C.masked_chamfer(x, ys, w, single, batch_dims=1),
                                   C.masked_chamfer(x, y, w, single, batch_dims=1),
                                   rtol=1e-6, atol=0)
    elif op == "subset_both":
        xm = (torch.rand(L, F, x.shape[2], generator=torch.Generator().manual_seed(3)) > 0.2)
        xm[:, 1] = False  # a frame without markers: no reverse term there
        ym = bias[:, None, :] == 0
        torch.testing.assert_close(
            C.masked_chamfer_vertex_subset(x, ys, xm, ym, False, batch_dims=1),
            C.masked_chamfer_vertex_subset(x, y, xm, ym, False, batch_dims=1),
            rtol=1e-6, atol=0)
    else:  # the gradient reaches the winning block only, as the whole min's
        grads = []
        for cloud in ("split", "whole"):
            yg = y.clone().requires_grad_(True)
            src = _split(yg) if cloud == "split" else yg
            tmesh.min_over_vertices(x, src).sum().backward()
            grads.append(yg.grad)
        torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-7)


# --------------------------------------------- stage closures on a (1, 2) grid

def _params_and_data(tm, F=6, M=10, seed=5):
    gt = random_pose_sequence(F, seed=seed, device="cpu")
    mk = generate_markers(tm, gt, num_markers=M, seed=seed + 1)
    markers = mk.points
    labels = tm.vertex_part_labels()[mk.vertex_ids]
    return gt, markers, labels


CLOSURES = ["chamfer_dense", "chamfer_dense_single", "root", "part_dense", "part_sparse",
            "marker"]


@pytest.mark.parametrize("which", CLOSURES)
def test_stage_closures_on_a_split_model_match_the_whole_model(models, which):
    """Each closure with the model cut in two vertex blocks (``on_row`` 0 of
    a (1, 2) grid) against the whole model: the dense branches reduce over
    the blocks, the gathered forward reads them."""
    _, tm = models
    split = tmesh._shard_model_by_vertex(tm, cpu_mesh(1, 2))
    gt, markers, labels = _params_and_data(tm)
    F, M = markers.shape[:2]
    cfg = load_config(CONFIG)
    rng = np.random.RandomState(9)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    pose6 = rot.matrix_to_rotation_6d(gt.pose_body) + t(0.02 * rng.randn(F, 23, 6))
    common = {"markers": markers, "o_pose_body": gt.pose_body, "o_betas": gt.betas,
              "frame_valid": torch.ones(F)}
    if which.startswith("chamfer") or which == "root":
        stage = "root" if which == "root" else "chamfer"
        cfg["stages"][stage].update(
            single_directional=which == "chamfer_dense_single",
            losses={"full_chamfer": 10.0, "part_chamfer": 10.0, "ground": 1.0,
                    "reg_betas": 1.0})
        params = {"trans": gt.trans + t(0.01 * rng.randn(F, 3)), "betas": gt.betas,
                  "z": t(0.1 * rng.randn(F, 1, 1))}
        if stage == "chamfer":
            params["pose6d"] = pose6
        lane = {"root_orient0": gt.root_orient}
        shared = dict(common, weights=torch.ones(F, M), marker_labels_mode=labels)

        def fun(model):
            st = SolveStages(model, copy.deepcopy(cfg))
            return (st._root_solver if stage == "root" else st._chamfer_solver).fun
    elif which.startswith("part"):
        cfg["stages"]["part"]["losses"] = dict(
            {"chamfer": 10.0, "reg_betas": 0.1, "foot_contact": 1.0},
            **({"ground": 1.0} if which == "part_dense" else {}))
        params = {"z": t(np.full((1, 1, 1), 0.2)), "trans": gt.trans, "betas": gt.betas}
        lane = {"vertex_mask": (tm.vertex_part_labels() < 12).float()}
        shared = dict(common, marker_weights=torch.ones(F, M), root_orient0=gt.root_orient,
                      foot_contacts=torch.ones(F, 2))

        def fun(model):
            return PartFitter(model, copy.deepcopy(cfg))._solver.fun
    else:
        params = {"pose6d": pose6, "betas": gt.betas,
                  "root6d": rot.matrix_to_rotation_6d(gt.root_orient), "trans": gt.trans}
        ids = torch.as_tensor(rng.randint(0, 6890, size=(M, 3)))
        lane = {"att_ids": ids, "att_w": torch.full((M, 3), 1.0 / 3)}
        shared = dict(common, weights=torch.ones(F, M))

        def fun(model):
            return SolveStages(model, copy.deepcopy(cfg))._marker_solver.fun

    out = []
    for model in (split, tm):
        p = {k: v[None].clone().requires_grad_(True) for k, v in params.items()}
        f = fun(model)(p, {k: v[None] for k, v in lane.items()}, shared)
        f.sum().backward()
        out.append((f.detach(), {k: v.grad for k, v in p.items()}))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=0)
    for k in params:
        g = out[1][1][k]
        torch.testing.assert_close(out[0][1][k], g, rtol=0, atol=1e-5 * float(g.abs().max()),
                                   msg=k)


# ------------------------------------------------------------ the batch solve

@pytest.fixture(scope="module")
def solve_setup(models):
    _, tm = models
    cfg = load_config(CONFIG)
    cfg["num_root_orient_angles"] = 2
    for stage in ("part", "chamfer", "marker"):
        cfg["stages"][stage]["num_iters"] = 3
    preps = []
    for q in range(2):
        gt = random_pose_sequence(16, seed=40 + q, device="cpu")
        mk = generate_markers(tm, gt, num_markers=12, seed=50 + q)
        prior = perturb_params(gt, seed=60 + q, pose_noise=0.02)
        preps.append(prepare_sequence(ImgSmpl.from_params(prior),
                                      ArrayMarkers(mk.points.numpy()), frame_bucket=None))
    unsharded = MultiSequenceSolver(tm, copy.deepcopy(cfg), device="cpu").solve_prepared(preps)
    return cfg, preps, unsharded


def _joints(tm, r):
    def t(a):
        return torch.as_tensor(np.asarray(a))

    with torch.no_grad():
        return lbs_forward(tm, t(r["pose_body"]), t(r["betas"]), t(r["root_orient"]),
                           t(r["trans"]))["joints"][:, :22]


def test_mesh_solve_matches_the_unsharded_solve(models, solve_setup):
    """A (2, 2) CPU grid: 2 lane blocks x 2 vertex blocks."""
    _, tm = models
    cfg, preps, ref = solve_setup
    solver = MultiSequenceSolver(tm, copy.deepcopy(cfg), mesh=cpu_mesh(2, 2))
    assert isinstance(solver.model, tmesh.ShardedBodyModel) and solver.device.type == "cpu"
    out = solver.solve_prepared(preps)
    np.testing.assert_array_equal(out["best_hypothesis"], ref["best_hypothesis"])
    for q in range(len(preps)):
        d_mm = float(torch.linalg.norm(_joints(tm, out["results"][q])
                                       - _joints(tm, ref["results"][q]), dim=-1).max()) * 1e3
        assert d_mm < 2.0, f"sequence {q}: the mesh changed the solve by {d_mm:.3f} mm"
        assert set(out["results"][q]) == set(ref["results"][q])


def test_one_by_one_mesh_is_the_unsharded_solve(models, solve_setup):
    _, tm = models
    cfg, preps, ref = solve_setup
    out = MultiSequenceSolver(tm, copy.deepcopy(cfg), mesh=cpu_mesh(1, 1)).solve_prepared(preps)
    np.testing.assert_array_equal(out["best_hypothesis"], ref["best_hypothesis"])
    np.testing.assert_array_equal(out["scores"], ref["scores"])
    for r_o, r_r in zip(out["results"], ref["results"]):
        assert set(r_o) == set(r_r)
        for k in r_r:
            np.testing.assert_array_equal(np.asarray(r_o[k]), np.asarray(r_r[k]), err_msg=k)
