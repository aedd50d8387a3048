"""The port's stages and the whole single-sequence solve against the JAX
package, on the CPU at a small size (V = 6890, a few frames and markers).

Inputs are made once with the JAX package's generators (numpy-seeded) and
handed to both sides as numpy.  Tolerances:
  * closure values and gradients: 1e-5 relative (float32 sums in another
    order; the nearest-vertex picks agree exactly on this data);
  * the solve: same output keys and shapes, chain, marker labels and
    hypothesis; final parameters within 1e-2 (m, and rotation-matrix
    entries).  The five-iteration stages stop mid-descent, where the line
    search's cubic fit amplifies float32 noise: the JAX solve itself moves
    by 8.1e-3 m (trans) and 5.1e-3 (rotations) when its markers are scaled
    by 1 + 1e-6, and the port lands 5.9e-3 / 4.5e-3 from it.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import copy
import glob
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.data.config import load_config as jax_load_config
from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
from uuo_mocap_tpu.data.synthetic import generate_markers, perturb_params, random_pose_sequence
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu.pipeline import multimodal as jmm
from uuo_mocap_tpu.pipeline.part_fit import PartFitter as JaxPartFitter
from uuo_mocap_tpu.pipeline.segmentation import segment_rigid as jax_segment_rigid
from uuo_mocap_tpu.pipeline.stages import SolveStages as JaxSolveStages
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.data.config import load_config, parse_yaml
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.pipeline import multimodal as tmm
from uuo_mocap_tpu_torch.pipeline.part_fit import PartFitter
from uuo_mocap_tpu_torch.pipeline.segmentation import segment_rigid
from uuo_mocap_tpu_torch.pipeline.stages import SolveStages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "video_mocap.yaml")
REL = 1e-5
RNG = np.random.RandomState(31)


@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


@pytest.fixture(scope="module")
def sequence(models):
    """A small synthetic sequence and its perturbed prior, as numpy."""
    jm, _ = models
    F, M = 6, 12
    gt = random_pose_sequence(F, seed=41, yaw=0.7, travel=0.2)
    mk = generate_markers(jm, gt, num_markers=M, seed=42, occlusion_rate=0.05)
    prior = perturb_params(gt, seed=43, pose_noise=0.05, trans_noise=0.08, betas_noise=0.2)
    markers = np.array(mk.points)
    return dict(
        markers=markers, weights=(np.abs(markers).sum(-1) != 0).astype(np.float32),
        pose=np.asarray(prior.pose_body), betas=np.asarray(prior.betas),
        root=np.asarray(prior.root_orient), trans=np.asarray(prior.trans),
        frame_valid=np.ones(F, np.float32))


def _jax_value_and_grad(fun, params, lane, shared):
    f, g = jax.jit(jax.value_and_grad(lambda p: fun(p, lane, shared)))(params)
    return float(f), {k: np.asarray(v) for k, v in g.items()}


def _torch_value_and_grad(fun, params, lane, shared):
    p = {k: torch.as_tensor(np.array(v))[None].requires_grad_(True) for k, v in params.items()}
    lane_t = {k: torch.as_tensor(np.array(v))[None] for k, v in lane.items()}
    shared_t = {k: torch.as_tensor(np.array(v)) for k, v in shared.items()}
    f = fun(p, lane_t, shared_t)
    assert f.shape == (1,)
    f.sum().backward()
    return f[0].item(), {k: v.grad[0].numpy() for k, v in p.items()}


def _check_closure(jfun, tfun, params, lane, shared):
    fj, gj = _jax_value_and_grad(jfun, {k: jnp.asarray(v) for k, v in params.items()},
                                 {k: jnp.asarray(v) for k, v in lane.items()},
                                 {k: jnp.asarray(v) for k, v in shared.items()})
    ft, gt = _torch_value_and_grad(tfun, params, lane, shared)
    np.testing.assert_allclose(ft, fj, rtol=REL)
    for k in gj:
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=REL * np.abs(gj[k]).max(), err_msg=k)


def test_part_closure_matches_jax(models, sequence):
    jm, tm = models
    cfg = jax_load_config(CONFIG)
    s = sequence
    F = s["markers"].shape[0]
    mask = np.zeros(6890, np.float32)
    labels = np.asarray(jnp.argmax(jm.lbs_weights, axis=-1))
    mask[np.isin(labels, [0, 1, 2, 3, 4, 5, 6, 9, 12, 15, 16, 17])] = 1.0
    params = {"z": np.full((1, 1, 1), 0.2, np.float32),
              "trans": s["trans"] + 0.01 * RNG.randn(F, 3).astype(np.float32),
              "betas": s["betas"]}
    shared = {"markers": s["markers"], "marker_weights": np.ones_like(s["weights"]),
              "o_pose_body": s["pose"], "o_betas": s["betas"], "root_orient0": s["root"],
              "foot_contacts": np.zeros((F, 2), np.float32), "frame_valid": s["frame_valid"]}
    _check_closure(JaxPartFitter(jm, cfg)._solver.fun, PartFitter(tm, load_config(CONFIG))._solver.fun,
                   params, {"vertex_mask": mask}, shared)


def _with_losses(stage, extra):
    """The shipped config, plus the ported losses it leaves off."""
    cfg = jax_load_config(CONFIG)
    cfg["stages"][stage]["losses"].update(extra)
    return cfg


@pytest.mark.parametrize("extra", [{}, {"trans_vel": 1.0, "root_orient_vel": 1.0}])
def test_chamfer_closure_matches_jax(models, sequence, extra):
    jm, tm = models
    s = sequence
    F = s["markers"].shape[0]
    params = {"trans": s["trans"], "z": (0.1 * RNG.randn(F, 1, 1)).astype(np.float32),
              "betas": s["betas"],
              "pose6d": np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(s["pose"])))
              + (0.01 * RNG.randn(F, 23, 6)).astype(np.float32)}
    shared = {"markers": s["markers"], "weights": s["weights"], "o_pose_body": s["pose"],
              "o_betas": s["betas"], "marker_labels_mode": np.zeros(12, np.int64),
              "frame_valid": s["frame_valid"]}
    cfg = _with_losses("chamfer", extra)
    _check_closure(JaxSolveStages(jm, cfg)._chamfer_solver.fun,
                   SolveStages(tm, copy.deepcopy(cfg))._chamfer_solver.fun,
                   params, {"root_orient0": s["root"]}, shared)


@pytest.mark.parametrize("extra", [{}, {"temporal": 1.0}])
def test_marker_closure_matches_jax(models, sequence, extra):
    jm, tm = models
    s = sequence
    F, M = s["markers"].shape[:2]
    ids = RNG.randint(0, 6890, size=(M, 3))
    w = RNG.rand(M, 3).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    d6 = lambda R: np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(R)))  # noqa: E731
    params = {"pose6d": d6(s["pose"]), "betas": s["betas"], "root6d": d6(s["root"]),
              "trans": s["trans"]}
    shared = {"markers": s["markers"], "weights": s["weights"], "o_pose_body": s["pose"],
              "o_betas": s["betas"], "frame_valid": s["frame_valid"]}
    cfg = _with_losses("marker", extra)
    _check_closure(JaxSolveStages(jm, cfg)._marker_solver.fun,
                   SolveStages(tm, copy.deepcopy(cfg))._marker_solver.fun,
                   params, {"att_ids": ids, "att_w": w}, shared)


def test_segment_rigid_partition_matches_jax(sequence):
    """Rigid groups (a marker and copies of it at fixed offsets) plus free
    markers: the scipy clustering gives the scikit-learn partition."""
    markers = sequence["markers"][:, :8]
    F = markers.shape[0]
    rigid = [markers[:, :1] + RNG.randn(1, 1, 3).astype(np.float32) * 0.05 for _ in range(3)]
    drift = [markers[:, 2:3] + 0.02 * RNG.randn(F, 1, 3).astype(np.float32) for _ in range(2)]
    pts = np.concatenate([markers] + rigid + drift, axis=1)
    ours = segment_rigid(pts)
    ref = jax_segment_rigid(pts)
    assert {frozenset(c) for c in ours} == {frozenset(c) for c in ref}
    assert any(len(c) > 1 for c in ours)
    assert [c[0] for c in ours] == sorted(c[0] for c in ours)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))))
def test_config_parser_matches_yaml_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)
    assert load_config(path) == jax_load_config(path)


def test_config_parser_scalars():
    text = "a: 1\nb: 1.0e-7\nc: 1e-7\nd: true\ne:\nf: 'x # y'  # c\ng: [1, 2.5, no]\nh:\n  i: ~\n"
    assert parse_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        parse_yaml("a:\n  - 1\n")


# ------------------------------------------------------------ the slice


def _small_config():
    cfg = jax_load_config(CONFIG)
    for stage in ("part", "chamfer", "marker"):
        cfg["stages"][stage]["num_iters"] = 5
    return cfg


@pytest.fixture(scope="module")
def solves(models):
    """One JAX solve and one port solve of the same sequence (F = 24, M = 12)."""
    jm, tm = models
    F, M = 24, 12
    gt = random_pose_sequence(F, seed=3, yaw=0.9, travel=0.3)
    mk = generate_markers(jm, gt, num_markers=M, seed=4, occlusion_rate=0.05)
    prior = perturb_params(gt, seed=5, pose_noise=0.05, trans_noise=0.08, betas_noise=0.2)
    markers = np.array(mk.points)
    prior_np = type(prior)(*(np.asarray(a) for a in prior))
    logs = {}

    def capture(tag, fn, *args, **kw):
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*args, **kw)
        logs[tag] = buf.getvalue()
        return out

    ref = capture("jax", jmm.multimodal_video_mocap, JaxImgSmpl.from_params(prior_np),
                  JaxArrayMarkers(markers.copy()), _small_config(), jm,
                  print_options=["progress"], save_stages=True, frame_bucket=None)
    ours = capture("torch", tmm.multimodal_video_mocap, ImgSmpl.from_params(prior_np),
                   ArrayMarkers(markers.copy()), _small_config(), tm,
                   print_options=["progress"], save_stages=True, frame_bucket=None,
                   device="cpu")
    return ref, ours, logs


def _best_index(log):
    return int(re.search(r"best angle index (\d+)", log).group(1))


def test_solve_matches_jax_keys_shapes_chain_labels(solves):
    ref, ours, logs = solves
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert ours[k].shape == v.shape, k
    assert set(ours["stages"]) == set(ref["stages"])
    for stage in ref["stages"]:
        for k, v in ref["stages"][stage].items():
            assert ours["stages"][stage][k].shape == v.shape, (stage, k)
    np.testing.assert_array_equal(ours["chain"], ref["chain"])
    np.testing.assert_array_equal(ours["markers_labels"], ref["markers_labels"])
    assert _best_index(logs["torch"]) == _best_index(logs["jax"])
    assert ours["mocap_frame_rate"] == ref["mocap_frame_rate"]


def test_solve_matches_jax_parameters(solves):
    ref, ours, _ = solves
    for k in ("trans", "pose_body", "root_orient", "betas"):
        assert np.isfinite(ours[k]).all(), k
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-2, rtol=0, err_msg=k)
