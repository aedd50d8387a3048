"""The opt-in ranking variants and the single-problem L-BFGS: the port
against the JAX package on the CPU.

  * the hierarchical ranking's table (``build_rank_table``, 640 coarse
    centres over the V = 6890 template) equal to the reference's element for
    element, and ``hierarchical_nearest``'s picks equal to the reference's
    at F = 70 frames (two 64-frame chunks) x M = 20 markers;
  * ``lbfgs_minimize`` on a quadratic and on a Rosenbrock function over a
    dict of parameters: iterates within 1e-4 (``tests/test_torch_lbfgs.py``'s
    tolerance), the same iteration and evaluation counts;
  * the rank-per-iteration chamfer solver (``_chamfer_solver_frozen``)
    descending the chamfer stage's lanes at ``tests/test_torch_batch_
    solver.py``'s size (Q = 2 sequences x 4 yaw hypotheses, F = 16, M = 20,
    20 iterations): the parameters within 1e-2, or within twice what the
    reference itself moves when its markers are scaled by 1 + 1e-6 (that
    file's rule), and the same iteration counts (a line search may take one
    evaluation more or less); on the reference's picks, its own picks equal
    to them but at float32 ties (see its test);
  * the chamfer closure ranking coarse to fine (``optimizer.rank_hier``):
    value and gradient within 1e-5;
  * the batch solve's phase-1 solver under ``hypothesis_prune.rank_phase1``
    with and without the global ``optimizer.rank_per_iteration``.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_batch_solver import PARAM_ATOL, batch, config, models  # noqa: F401  (fixtures)
from uuo_mocap_tpu.body.model import lbs_forward as jax_lbs_forward
from uuo_mocap_tpu.data.synthetic import generate_markers, random_pose_sequence
from uuo_mocap_tpu.ops import rank_hier as jrh
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu.pipeline import stages as jstages
from uuo_mocap_tpu.pipeline.stages import SolveStages as JaxSolveStages
from uuo_mocap_tpu.solver import lbfgs as jl
from uuo_mocap_tpu_torch.ops import rank_hier as trh
from uuo_mocap_tpu_torch.ops import rotations as trot
from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
from uuo_mocap_tpu_torch.pipeline import stages as tstages
from uuo_mocap_tpu_torch.pipeline.stages import SolveStages, _data
from uuo_mocap_tpu_torch.solver import lbfgs as tl

A = 4
TOL = 1e-4


@pytest.fixture(scope="module")
def tables(models):
    return jrh.rank_table_for(models[0]), trh.rank_table_for(models[1])


def test_rank_table_matches_jax(models, tables):
    ref, ours = tables
    np.testing.assert_array_equal(ours.coarse_ids, ref.coarse_ids)
    np.testing.assert_array_equal(ours.cand_ids, ref.cand_ids)
    assert ours.top_p == ref.top_p == 2 and ours.coarse_ids.shape == (640,)
    assert trh.rank_table_for(models[1]) is ours  # cached per model


def test_hierarchical_nearest_matches_jax(models, tables):
    jm = models[0]
    gt = random_pose_sequence(70, seed=31, yaw=0.5, travel=0.3)
    markers = np.array(generate_markers(jm, gt, num_markers=20, seed=32).points)
    verts = np.array(jax_lbs_forward(jm, gt.pose_body, jnp.broadcast_to(gt.betas, (70, 10)),
                                     gt.root_orient, gt.trans)["vertices"])
    ref = np.asarray(jrh.hierarchical_nearest(jnp.asarray(markers), jnp.asarray(verts), tables[0]))
    ours = trh.hierarchical_nearest(torch.as_tensor(markers), torch.as_tensor(verts), tables[1])
    np.testing.assert_array_equal(ours.numpy(), ref)
    lanes = trh.hierarchical_nearest(torch.as_tensor(markers).reshape(2, 35, 20, 3),
                                     torch.as_tensor(verts).reshape(2, 35, -1, 3), tables[1])
    np.testing.assert_array_equal(lanes.reshape(70, 20).numpy(), ref)


def _quadratic(p):  # numpy-style operators: the same code for both packages
    r = p["a"] - 1.5
    return (3.0 * r * r).sum() + ((2.0 * p["b"] - 0.5) ** 2).sum() + 0.01 * (p["a"] ** 4).sum()


def _rosenbrock(p):
    x = p["x"]
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum() + (p["y"] ** 2).sum()


@pytest.mark.parametrize("problem", [_quadratic, _rosenbrock])
def test_lbfgs_minimize_matches_jax(problem):
    rng = np.random.RandomState(23)
    names = ("a", "b") if problem is _quadratic else ("x", "y")
    params0 = {names[0]: rng.randn(5).astype(np.float32) * 0.5,
               names[1]: rng.randn(2, 2).astype(np.float32)}
    p_ref, r_ref = jl.lbfgs_minimize(problem, {k: jnp.asarray(v) for k, v in params0.items()},
                                     jl.LbfgsOptions(max_iter=20))
    p_ours, r_ours = tl.lbfgs_minimize(problem, {k: torch.as_tensor(v) for k, v in params0.items()},
                                       tl.LbfgsOptions(max_iter=20))
    for k in params0:
        assert p_ours[k].shape == params0[k].shape
        np.testing.assert_allclose(p_ours[k].numpy(), np.asarray(p_ref[k]), atol=TOL, err_msg=k)
    np.testing.assert_allclose(float(r_ours.f), float(r_ref.f), rtol=TOL, atol=1e-6)
    assert int(r_ours.num_iters) == int(r_ref.num_iters)
    assert int(r_ours.num_evals) == int(r_ref.num_evals)


def _lanes(batch, scale=1.0):
    """The chamfer stage's lane inputs (2 sequences x 4 yaw hypotheses) as
    numpy, in ``chamfer_stage_lanes``' order."""
    F = batch[0][1].shape[0]
    angles = np.arange(A) * 2 * np.pi / A
    yaw = np.asarray(jrot.rot_z(jnp.asarray(np.repeat(angles, F).reshape(A, F, 1, 1),
                                            jnp.float32)))
    rows = {k: [] for k in ("mk", "pose", "betas", "root", "trans")}
    for _, mk, prior in batch:
        for a in range(A):
            rows["mk"].append(mk * np.float32(scale))
            rows["pose"].append(np.asarray(prior.pose_body))
            rows["betas"].append(np.asarray(prior.betas))
            rows["root"].append(yaw[a] @ np.asarray(prior.root_orient))
            rows["trans"].append(np.asarray(prior.trans))
    mk, pose, betas, root, trans = (np.stack(rows[k]).astype(np.float32) for k in (
        "mk", "pose", "betas", "root", "trans"))
    weights = (np.abs(mk).sum(-1) != 0).astype(np.float32)
    L = mk.shape[0]
    return [mk, weights, pose, betas, pose, betas, root, trans,
            np.zeros((L, mk.shape[2]), np.int64), np.ones((L, F), np.float32)]


def _rank_config(jax_side, hier):
    cfg = config(jax_side)
    cfg["optimizer"]["rank_hier"] = hier
    return cfg


def _jax_lanes(jm, batch, frozen, hier, scale=1.0):
    st = JaxSolveStages(jm, _rank_config(True, hier))
    solver = st._chamfer_solver_frozen if frozen else st._chamfer_solver
    out, res = st.chamfer_stage_lanes(*(jnp.asarray(a) for a in _lanes(batch, scale)),
                                      solver=solver)
    return {f: np.asarray(getattr(out, f)) for f in out._fields}, np.asarray(res.num_iters)


def _check_lanes(out, res, ref, ref_iters, moved):
    np.testing.assert_array_equal(res.num_iters.numpy(), ref_iters)
    for f in out._fields:
        o, r = getattr(out, f).numpy(), ref[f]
        assert o.shape == r.shape and np.isfinite(o).all(), f
        diff = float(np.abs(o - r).max())
        if diff > PARAM_ATOL:
            assert diff <= 2.0 * float(np.abs(moved()[f] - r).max()), (f, diff)


def test_frozen_chamfer_solver_matches_jax(models, batch):
    """The rank-per-iteration solver.  A pick the frozen ranking makes at a
    float32 tie holds for a whole iteration, and the descent carries it on:
    on these lanes one tie (a 2.7e-9 m^2 gap) decided the other way took a
    lane 4e-2 from the reference.  So the port's descent takes the
    reference's picks, on its own posed vertices, and its own picks must
    equal them but at ties (a gap <= 1e-7 m^2, ``chip_smoke.TIE_GAP_M2``)."""
    jm, tm = models
    ref, ref_iters = _jax_lanes(jm, batch, True, False)
    st = SolveStages(tm, copy.deepcopy(_rank_config(False, False)))
    solver = st._chamfer_solver_frozen
    own, gaps = solver.prepare, []
    reference_rank = jax.jit(jstages._ranked_nearest)

    def reference_picks(p, lane, shared):
        d = _data(lane, shared)
        verts = tstages._forward(tm, tstages.SmplParams(
            trot.rotation_6d_to_matrix(p["pose6d"]), p["betas"],
            st._chamfer_apply(p["z"], d["root_orient0"]), p["trans"]))["vertices"].numpy()
        mk = d["markers"].numpy()
        picks = np.asarray(reference_rank(jnp.asarray(mk.reshape((-1,) + mk.shape[2:])),
                                          jnp.asarray(verts.reshape((-1,) + verts.shape[2:])))
                           ).reshape(mk.shape[:3]).astype(np.int64)
        mine = own(p, lane, shared).numpy()

        def d2(i):  # float64 squared distance of each marker to vertex i
            v = np.take_along_axis(verts, i[..., None].repeat(3, -1), 2).astype(np.float64)
            return ((mk.astype(np.float64) - v) ** 2).sum(-1)

        gaps.append(float(np.abs(d2(mine) - d2(picks)).max()))
        return torch.as_tensor(picks)

    solver.prepare = reference_picks
    out, res = st.chamfer_stage_lanes(*(torch.as_tensor(a) for a in _lanes(batch)), solver=solver)
    _check_lanes(out, res, ref, ref_iters,
                 functools.lru_cache(None)(lambda: _jax_lanes(jm, batch, True, False, 1 + 1e-6)[0]))
    assert len(gaps) == int(res.num_iters.max()) + 1 and max(gaps) <= 1e-7, max(gaps)


def test_rank_hier_chamfer_closure_matches_jax(models, batch):
    """The chamfer closure ranking coarse to fine (``optimizer.rank_hier``)
    on the batch's first sequence at the prior: the value within 1e-5
    relative, the gradient within 1e-5 of its largest entry (the closure
    rule of ``tests/test_torch_pipeline.py``)."""
    jm, tm = models
    args = [a[:1] for a in _lanes(batch)]  # one lane
    mk, wt, pose, betas, _, _, root, trans, labels, fv = args
    F = mk.shape[1]
    params = {"trans": trans, "z": np.full((1, F, 1, 1), 0.05, np.float32), "betas": betas,
              "pose6d": np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(pose)))}
    lane = {"root_orient0": root, "markers": mk, "weights": wt, "o_pose_body": pose,
            "o_betas": betas, "marker_labels_mode": labels, "frame_valid": fv}
    jst = JaxSolveStages(jm, _rank_config(True, True))
    st = SolveStages(tm, copy.deepcopy(_rank_config(False, True)))
    assert st._chamfer_solver.prepare is None
    fj, gj = jax.jit(jax.value_and_grad(lambda p: jst._chamfer_solver.fun(
        {k: v[0] for k, v in p.items()}, {k: jnp.asarray(v[0]) for k, v in lane.items()}, {})))(
        {k: jnp.asarray(v) for k, v in params.items()})
    p_t = {k: torch.as_tensor(v).requires_grad_(True) for k, v in params.items()}
    ft = st._chamfer_solver.fun(p_t, {k: torch.as_tensor(v) for k, v in lane.items()}, {})
    ft.sum().backward()
    np.testing.assert_allclose(float(ft[0]), float(fj), rtol=1e-5)
    for k, g in gj.items():
        g = np.asarray(g)
        np.testing.assert_allclose(p_t[k].grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(),
                                   err_msg=k)


def test_phase1_solver_follows_rank_phase1(models):
    cfg = config(False)
    cfg["parallel"]["hypothesis_prune"]["rank_phase1"] = True
    solver = MultiSequenceSolver(models[1], copy.deepcopy(cfg), device="cpu")
    frozen = solver.phase1_solver()
    assert frozen is solver.stages._chamfer_solver_frozen and frozen.prepare is not None
    assert frozen.max_width == 16 and solver.stages._chamfer_solver.prepare is None
    cfg["optimizer"]["rank_per_iteration"] = True  # the stage's own solver freezes already
    solver = MultiSequenceSolver(models[1], copy.deepcopy(cfg), device="cpu")
    assert solver.phase1_solver() is solver.stages._chamfer_solver
    assert solver.stages._chamfer_solver.prepare is not None
    cfg["parallel"]["hypothesis_prune"]["rank_phase1"] = False
    cfg["optimizer"]["rank_per_iteration"] = False
    solver = MultiSequenceSolver(models[1], copy.deepcopy(cfg), device="cpu")
    assert solver.phase1_solver() is solver.stages._chamfer_solver
