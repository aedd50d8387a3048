"""The whole slice against the JAX package on the CPU: the synthetic export,
the file-based solve (``cli.test --batch 2`` here, sequential in
``test_torch_cli_sequential.py`` with the helpers defined here) and the
evaluation harness, each package driven through its ``main(argv)``.

Size: 2 sequences x 20 frames x 20 markers (V = 6890; ``prepare_sequence``
pads the frames to its 64-frame bucket in both packages), the shipped
config with the chamfer and marker stages capped at 20 iterations and the
hypothesis cascade's prune rounds scaled to the cap (5 and 10 iterations),
and no part fit: the part tournament takes minutes per package on the CPU at
64 frames, and ``tests/test_torch_batch_solver.py`` and
``tests/test_torch_pipeline.py`` hold it to the reference already.

Both solves read the JAX export, so their inputs are the same bytes.
Tolerances:
  * export: c3d points and ground truth within 1e-5 m (the surface points
    are float32 sums in another order), the prior's arrays within 1e-5,
    everything else equal;
  * solve: the same files, keys and shapes; markers, rate and gender equal;
    trans and betas within 1e-2 (m) and pose rotation-matrix entries within
    1.5e-2 (the batch solve's tolerances,
    ``tests/test_torch_batch_solver.py``), or within twice what the
    reference itself moves when its markers are scaled by 1 + 1e-6,
    whichever is larger.  That test applies the rule to rotations only; here
    the 20-iteration chamfer stage stops mid-descent with four hypotheses
    and 64 padded frames, and the reference moves its trans by up to
    8.6e-2 m under the perturbation, while the port lands 4.1e-2 from it;
  * evaluation on the same results: the position metrics within 1e-4 mm;
    the velocity metrics within 2e-3 mm/s plus 1e-6 relative (a 1 m
    position carries a float32 step of 6e-8 m, which x 30 Hz x 1000 is
    1.8e-3 mm/s).
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import contextlib
import copy
import csv
import glob
import json
import pickle
import shutil

import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch
import yaml

from uuo_mocap_tpu.cli import export_synthetic_c3d as jax_export
from uuo_mocap_tpu.cli import test as jax_cli
from uuo_mocap_tpu.data.c3d import read_c3d as jax_read_c3d
from uuo_mocap_tpu.eval import comparisons as jax_comparisons
from uuo_mocap_tpu.ops import rotations as jrot
from uuo_mocap_tpu_torch.cli import export_synthetic_c3d as export
from uuo_mocap_tpu_torch.cli import test as cli
from uuo_mocap_tpu_torch.data.c3d import write_c3d
from uuo_mocap_tpu_torch.data.pkl_io import load_pkl
from uuo_mocap_tpu_torch.eval import comparisons

EXPORT_ARGS = ["--dataset", "ds", "--subjects", "s1", "--sequences", "a", "b",
               "--num_markers", "20", "--num_frames", "20", "--seed", "3"]
CONFIG = """parent: configs/video_mocap.yaml
find_best_part_fits: false
stages:
  chamfer:
    num_iters: 20
  marker:
    num_iters: 20
parallel:
  lane_width: 16
  part_lane_width: 16
  pad_width: true
  hypothesis_prune:
    enabled: true
    at_iters: [5, 10]
    keep: [2, 1]
    frame_stride: 1
"""
PARAM_ATOL, ROT_ATOL = 1e-2, 1.5e-2
METHODS = ["moshpp", "hmr", "video_mocap"]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    jax_export.main(["--input_dir", str(root / "jax")] + EXPORT_ARGS)
    export.main(["--input_dir", str(root / "port"), "--cpu_only"] + EXPORT_ARGS)
    config = root / "small.yaml"
    config.write_text(CONFIG)
    return root, str(config)


def _run_dir(root, name, scale=None):
    """A copy of the JAX export to solve in (each run writes its own
    results), with the markers scaled by ``scale`` if given."""
    dst = root / name
    shutil.copytree(root / "jax", dst)
    if scale is not None:
        for path in glob.glob(str(dst / "**" / "*.c3d"), recursive=True):
            pts = jax_read_c3d(path, use_native=False)["points"][..., :3]
            write_c3d(path, pts * np.float32(scale), rate=30.0, units="m")
    return str(dst)


class SharedReferenceSolvers:
    """While active, the reference's solvers are built once per
    configuration and reused: ``cli.test`` and ``multimodal_video_mocap``
    build fresh ones per call, and a fresh solver traces every program anew.
    The runs differ in their data only (the markers scaled by 1 + 1e-6), and
    a solver's results depend on its inputs alone
    (``tests/test_torch_batch_solver.py`` reuses one for its scaled solve)."""

    def __init__(self):
        import uuo_mocap_tpu.parallel.batch_solver as jbs
        import uuo_mocap_tpu.pipeline.multimodal as jmm

        self._made = {}
        self._slots = [(jbs, "MultiSequenceSolver"), (jmm, "SolveStages"), (jmm, "PartFitter")]

    def _shared(self, cls):
        def build(model, config, *args, **kw):
            key = (cls, json.dumps(config, sort_keys=True, default=str))
            if key not in self._made:
                self._made[key] = cls(model, config, *args, **kw)
            return self._made[key]

        return build

    @contextlib.contextmanager
    def active(self):
        originals = [getattr(mod, name) for mod, name in self._slots]
        for (mod, name), cls in zip(self._slots, originals):
            setattr(mod, name, self._shared(cls))
        try:
            yield
        finally:
            for (mod, name), cls in zip(self._slots, originals):
                setattr(mod, name, cls)


def solve_runs(exported, tag, mode_args, port_args=()):
    """``cli.test`` of both packages on the JAX export, and of the JAX
    package on its markers scaled by 1 + 1e-6; ``port_args`` go to the
    port's run only.  -> {run: input_dir}."""
    root, config = exported
    dirs = {}
    shared = SharedReferenceSolvers()
    for name, main, extra, scale in ((f"jax_{tag}", jax_cli.main, [], None),
                                     (f"jax_{tag}_perturbed", jax_cli.main, [], 1 + 1e-6),
                                     (f"port_{tag}", cli.main, ["--cpu_only", *port_args], None)):
        dirs[name] = _run_dir(root, name, scale)
        with shared.active() if main is jax_cli.main else contextlib.nullcontext():
            main(["--config", config, "--dataset", "ds", "--input_dir", dirs[name],
                  "--synthetic", "--print_options"] + mode_args + extra)
    return dirs


@pytest.fixture(scope="module")
def batch_runs(exported):
    return solve_runs(exported, "batch", ["--batch", "2"])


def _rel_files(d, pattern):
    return sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, pattern), recursive=True))


def test_export_matches_jax(exported):
    root, _ = exported
    j, t = str(root / "jax"), str(root / "port")
    files = _rel_files(j, "**/*.*")
    assert files == _rel_files(t, "**/*.*") and len(files) == 6
    for rel in files:
        a, b = os.path.join(j, rel), os.path.join(t, rel)
        if rel.endswith(".c3d"):
            ra, rb = jax_read_c3d(a, use_native=False), jax_read_c3d(b, use_native=False)
            assert ra["points"].shape == (20, 20, 4)
            np.testing.assert_allclose(rb["points"], ra["points"], atol=1e-5, rtol=0)
            assert (ra["rate"], ra["units"], ra["labels"]) == (rb["rate"], rb["units"], rb["labels"])
            # the same header and parameter blocks, byte for byte
            assert open(a, "rb").read()[:1024] == open(b, "rb").read()[:1024]
        elif rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                if za[k].dtype.kind in "fc":
                    np.testing.assert_allclose(zb[k], za[k], atol=1e-5, rtol=0, err_msg=k)
                else:
                    np.testing.assert_array_equal(zb[k], za[k])
        else:  # the prior pkl: joblib's dump against the port's plain pickle
            pa, pb = joblib.load(a), load_pkl(b)
            assert sorted(pa) == sorted(pb) and len(pa) == 20
            for key in pa:
                fa, fb = pa[key], pb[key]
                assert fa.keys() == fb.keys() and fa["tracked_ids"] == fb["tracked_ids"]
                for k in ("global_orient", "body_pose", "betas"):
                    np.testing.assert_allclose(fb["smpl"][0][k], fa["smpl"][0][k], atol=1e-5, err_msg=k)
                np.testing.assert_allclose(fb["3d_joints"][0], fa["3d_joints"][0], atol=1e-5)
                np.testing.assert_array_equal(fb["2d_joints"][0], fa["2d_joints"][0])


def check_journal(path, stages, last_iters):
    """A journal ``cli.test --save_iterations`` wrote: read with ``pickle``
    alone, numpy arrays and Python scalars only, an entry and segments for
    every stage in ``stages``, and every segment's iterations a multiple of
    50 or its lane's last iteration (at most ``last_iters``)."""
    with open(path, "rb") as f:
        entries = pickle.load(f)

    def plain(v):
        if isinstance(v, dict):
            return all(plain(x) for x in v.values())
        if isinstance(v, list):
            return all(plain(x) for x in v)
        return isinstance(v, (np.ndarray, np.generic, int, float, str))

    assert plain(entries)
    for stage in stages:
        assert entries[stage] and entries[f"{stage}__segments"], stage
        last = {}
        for seg in entries[f"{stage}__segments"]:
            for lane, it in zip(seg["lanes"].tolist(), seg["iters"].tolist()):
                last[lane] = max(last.get(lane, 0), it)
        assert 0 < max(last.values()) <= last_iters, stage
        for seg in entries[f"{stage}__segments"]:
            for lane, it in zip(seg["lanes"].tolist(), seg["iters"].tolist()):
                assert it % 50 == 0 or it == last[lane], (stage, lane, it)
    return entries


def _rotations(poses):
    return np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(poses.reshape(poses.shape[0], 24, 3))))


def compare_outputs(dirs, tag, expected):
    """The port's run wrote the reference's ``*_stageii*.npz`` files, with
    its keys and shapes, markers, rate and gender."""
    d_ref, d_pert, d_out = dirs[f"jax_{tag}"], dirs[f"jax_{tag}_perturbed"], dirs[f"port_{tag}"]
    files = _rel_files(d_ref, "ds/results/video_mocap/**/*.npz")
    assert files == _rel_files(d_out, "ds/results/video_mocap/**/*.npz") == _rel_files(
        d_pert, "ds/results/video_mocap/**/*.npz")
    assert len(files) == expected
    for rel in files:
        za, zb = (np.load(os.path.join(d, rel)) for d in (d_ref, d_out))
        assert sorted(za.files) == sorted(zb.files) == sorted(
            ["poses", "betas", "trans", "mocap_frame_rate", "mocap_markers", "gender"])
        for k in za.files:
            assert za[k].shape == zb[k].shape, (rel, k)
        assert za["poses"].shape == (20, 72) and za["betas"].shape == (10,)
        np.testing.assert_array_equal(zb["mocap_markers"], za["mocap_markers"])
        assert float(zb["mocap_frame_rate"]) == float(za["mocap_frame_rate"])
        assert str(zb["gender"]) == str(za["gender"]) == "neutral"


def compare_params(dirs, tag, key):
    """``key`` (trans, betas or rotations) of every ``*_stageii*.npz`` of
    the port's run against the reference's, with the tolerances of the
    module docstring."""
    d_ref, d_pert, d_out = dirs[f"jax_{tag}"], dirs[f"jax_{tag}_perturbed"], dirs[f"port_{tag}"]
    for rel in _rel_files(d_ref, "ds/results/video_mocap/**/*.npz"):
        za, zb, zp = (np.load(os.path.join(d, rel)) for d in (d_ref, d_out, d_pert))
        if key == "rotations":
            ref, out, pert = (_rotations(z["poses"]) for z in (za, zb, zp))
            base = ROT_ATOL
        else:
            ref, out, pert, base = za[key], zb[key], zp[key], PARAM_ATOL
        moved, dist = float(np.abs(pert - ref).max()), float(np.abs(out - ref).max())
        print(f"{rel} {key}: port {dist:.3g}, reference under 1e-6 scaling {moved:.3g}")
        np.testing.assert_allclose(out, ref, atol=max(base, 2 * moved), rtol=0,
                                   err_msg=f"{rel} {key}")


def test_cli_batch_matches_jax(batch_runs):
    # 2 sequences x (final + chamfer, marker, marker_final stages)
    compare_outputs(batch_runs, "batch", expected=8)
    for key in ("trans", "betas", "rotations"):
        compare_params(batch_runs, "batch", key)


def _metrics_close(out, ref, where):
    assert out.keys() == ref.keys(), where
    for k in ref:
        if isinstance(ref[k], dict):
            _metrics_close(out[k], ref[k], f"{where}/{k}")
            continue
        if np.isnan(ref[k]):
            assert np.isnan(out[k]), f"{where}/{k}"
            continue
        velocity = "mpjve" in f"{where}/{k}"
        np.testing.assert_allclose(out[k], ref[k], atol=2e-3 if velocity else 1e-4,
                                   rtol=1e-6 if velocity else 0.0, err_msg=f"{where}/{k}")


def test_comparisons_match_jax(batch_runs, tmp_path):
    d = batch_runs["port_batch"]
    ref = jax_comparisons.run_comparisons(None, d, "ds", METHODS, synthetic="3_20",
                                          output_root=str(tmp_path / "jax"))
    out = comparisons.run_comparisons(None, d, "ds", METHODS, synthetic="3_20",
                                      output_root=str(tmp_path / "port"), device="cpu")
    assert set(out) == set(ref) == set(METHODS)
    _metrics_close(out, ref, "stats")
    assert ref["moshpp"]["mpjpe"]["mean"] == 0.0 and np.isfinite(out["video_mocap"]["m2s"]["mean"])
    for method in METHODS:
        ya = yaml.safe_load(open(tmp_path / "jax" / "synthetic_3_20" / f"{method}.yaml"))
        yb = yaml.safe_load(open(tmp_path / "port" / "synthetic_3_20" / f"{method}.yaml"))
        _metrics_close(yb, ya, f"{method}.yaml")
        ca = list(csv.reader(open(tmp_path / "jax" / "synthetic_3_20" / f"{method}.csv")))
        cb = list(csv.reader(open(tmp_path / "port" / "synthetic_3_20" / f"{method}.csv")))
        assert [r[0] for r in ca] == [r[0] for r in cb] and ca[0] == cb[0]


def test_comparisons_main_evaluates_the_port_results(batch_runs):
    stats = comparisons.main(["--input_dir", batch_runs["jax_batch"], "--dataset", "ds",
                              "--synthetic", "3_20", "--methods"] + METHODS + ["--cpu_only"])
    assert stats["video_mocap"]["mpjpe"]["mean"] < stats["hmr"]["mpjpe"]["mean"]
    assert os.path.exists(os.path.join(batch_runs["jax_batch"], "ds", "results", "stats", "ds",
                                       "synthetic_3_20", "video_mocap.yaml"))


def test_bucket_work_by_shape_matches_jax(tmp_path):
    shapes = [(130, 41), (20, 9), (64, 40), (65, 41), (20, 17), (128, 48)]
    work = []
    for i, (F, M) in enumerate(shapes):
        path = write_c3d(str(tmp_path / f"s{i}.c3d"), np.ones((F, M, 3), np.float32))
        work.append({"markers_file": path, "i": i})
    (tmp_path / "bad.c3d").write_bytes(b"not a c3d file at all")
    work.insert(2, {"markers_file": str(tmp_path / "bad.c3d"), "i": -1})
    work.insert(0, {"markers_file": str(tmp_path / "missing.c3d"), "i": -2})
    ref = [w["i"] for w in jax_cli.bucket_work_by_shape(copy.deepcopy(work))]
    assert [w["i"] for w in cli.bucket_work_by_shape(work)] == ref
    assert ref[-2:] == [-2, -1]


def test_port_clis_raise_without_a_gpu_unless_cpu_is_asked(exported):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    root, config = exported
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config", config, "--dataset", "ds", "--input_dir", str(root / "port"),
                  "--synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.main(["--input_dir", str(root / "none")] + EXPORT_ARGS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comparisons.main(["--input_dir", str(root / "port"), "--dataset", "ds", "--methods", "moshpp"])
    assert not os.path.exists(root / "port" / "ds" / "results")
    # --save_iterations (sequential) saves the iteration journal: one
    # sequence, one yaw hypothesis, 2-iteration stages
    small = root / "two_iterations.yaml"
    small.write_text(CONFIG.replace("num_iters: 20", "num_iters: 2")
                     + "num_root_orient_angles: 1\n")
    d = _run_dir(root, "port_journal")
    assert cli.main(["--config", str(small), "--dataset", "ds", "--input_dir", d, "--synthetic",
                     "--cpu_only", "--num_files", "0", "--save_iterations",
                     str(root / "it")]) == 1
    journal = root / "it" / "s1_a_iterations.pkl"
    check_journal(journal, ["chamfer", "marker", "marker_final_0"], 2)


def test_part_scores_ignore_frame_bucket_padding():
    """``cli.test`` pads every sequence to its 64-frame bucket with frames of
    zero (occluded) markers.  In the part fit's bidirectional score, the
    reference adds each padded frame's subtree vertices at the 1e10
    occlusion bias, which leaves no float32 bits for the real frames
    (ROADMAP C.4); the port drops frames without a valid marker from the
    reverse term, so the padded score is the unpadded one."""
    from uuo_mocap_tpu.ops import chamfer as jchamfer
    from uuo_mocap_tpu_torch.ops import chamfer as tchamfer

    rng = np.random.RandomState(12)
    F, pad, M, V = 6, 4, 12, 400
    x = rng.randn(F, M, 3).astype(np.float32)
    x[2, 5] = 0.0  # an occluded marker in a real frame
    y = rng.randn(F + pad, V, 3).astype(np.float32)
    x_pad = np.concatenate([x, np.zeros((pad, M, 3), np.float32)])
    masks = [(np.abs(a).sum(-1) != 0).astype(np.float32) for a in (x, x_pad)]
    y_mask = (rng.rand(V) > 0.5).astype(np.float32)
    ours, ours_pad = (float(tchamfer.masked_chamfer_vertex_subset(
        torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(m), torch.as_tensor(y_mask), False))
        for a, b, m in ((x, y[:F], masks[0]), (x_pad, y, masks[1])))
    ref = float(jchamfer.masked_chamfer_vertex_subset(
        jnp.asarray(x), jnp.asarray(y[:F]), jnp.asarray(masks[0]), jnp.asarray(y_mask), False))
    ref_pad = float(jchamfer.masked_chamfer_vertex_subset(
        jnp.asarray(x_pad), jnp.asarray(y), jnp.asarray(masks[1]), jnp.asarray(y_mask), False))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    np.testing.assert_allclose(ours_pad, ours, rtol=1e-6)
    assert ref_pad > 1e9 > 1e6 * ref  # the reference's padded score: the bias, not the fit
