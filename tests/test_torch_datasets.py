"""The port's training datasets and SMPL wrappers against the JAX package's,
on the CPU, on the same seeds.

Sizes: the synthetic body (V = 6890); windows of 8 frames x 12 markers;
raw AMASS-schema files of 40-240 frames written by the test; 64 surface
samples.  Tolerances: numpy-only code (``markers_noise``, the joint
helpers, ``SMPLHDataset``, the exported npz) bit for bit; whatever passes
through the SMPL forward (markers, joints, vertices, foot contacts'
inputs, closest points) within 1e-5 absolute, labels and contacts equal.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uuo_mocap_tpu.body import joints as jjoints
from uuo_mocap_tpu.body import smpl as jsmpl
from uuo_mocap_tpu.body.synthetic import export_synthetic_npz as jax_export
from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
from uuo_mocap_tpu.data import amass as jamass
from uuo_mocap_tpu.data import markers_noise as jnoise
from uuo_mocap_tpu.data import smplh_datasets as jsmplh
from uuo_mocap_tpu_torch.body import joints as tjoints
from uuo_mocap_tpu_torch.body import smpl as tsmpl
from uuo_mocap_tpu_torch.body.model import load_body_model
from uuo_mocap_tpu_torch.body.synthetic import export_synthetic_npz
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
from uuo_mocap_tpu_torch.data import amass as tamass
from uuo_mocap_tpu_torch.data import markers_noise as tnoise
from uuo_mocap_tpu_torch.data import smplh_datasets as tsmplh

ATOL = 1e-5


@pytest.fixture(scope="module")
def bodies():
    jm = jax_synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


def _close(ours, ref, what=""):
    ours = ours.detach().cpu().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=ATOL, err_msg=what)


def _same_sample(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        if np.issubdtype(np.asarray(ref[k]).dtype, np.integer):
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        else:
            _close(ours[k], ref[k], k)


def test_markers_noise_equals_reference():
    rng = np.random.RandomState(0)
    pts = (rng.randn(60, 12, 3) * 0.3 + [0, 0, 1.0]).astype(np.float32)
    cases = [
        ("markers_swap", dict(swap_probability=0.3, distance_threshold=0.6)),
        ("markers_tracking_loss", dict(probability=0.5, max_length=10)),
        ("markers_tracking_loss_second_block", dict(probability=0.5)),
        ("randomly_drop_markers", dict(frequency=30.0, num_drop=3)),
    ]
    for name, kwargs in cases:
        for seed in (None, 7):  # the default generator, and one given
            def rng():
                return None if seed is None else np.random.RandomState(seed)

            want = getattr(jnoise, name)(pts, rng=rng(), **kwargs)
            got = getattr(tnoise, name)(pts, rng=rng(), **kwargs)
            assert np.array_equal(got, want), (name, seed)
    assert tnoise.randomly_drop_markers(pts, 30.0) is pts  # num_drop 0


def _write_amass_tree(root, rng):
    """Two processed AMASS-schema files in a train sub-dataset, one in a
    valid one."""
    for sub, subject, F in (("ACCAD", "s1", 40), ("KIT", "s2", 25), ("SFU", "s3", 30)):
        d = os.path.join(root, sub, subject)
        os.makedirs(d)
        np.savez(os.path.join(d, "seq.npz"), poses=(rng.randn(F, 156) * 0.2).astype(np.float32),
                 trans=rng.randn(F, 3).astype(np.float32) * 0.1,
                 betas=rng.randn(16).astype(np.float32), mocap_frame_rate=30.0)


@pytest.mark.parametrize("mode", ["procedural", "npz"])
def test_dataset_mocap_and_motion_equal_reference(bodies, mode, tmp_path):
    jm, tm = bodies
    amass_dir = None
    if mode == "npz":
        amass_dir = str(tmp_path / "amass")
        _write_amass_tree(amass_dir, np.random.RandomState(3))
    kwargs = dict(amass_dir=amass_dir, sequence_length=8, stride=2, num_markers=12, seed=4)
    ref = jamass.DatasetMocap(jm, **kwargs)
    ours = tamass.DatasetMocap(tm, **kwargs)
    assert ours.files == ref.files and len(ours) == len(ref)
    if mode == "npz":
        assert len(ours.files) == 2  # the train split's sub-datasets
    for i in range(3):
        _same_sample(ours[i], ref[i])
    for split in ("train", "valid"):
        ref_m = jamass.DatasetSMPLHMotion(jm, amass_dir, split, sequence_length=8, seed=5)
        ours_m = tamass.DatasetSMPLHMotion(tm, amass_dir, split, sequence_length=8, seed=5)
        assert len(ours_m) == len(ref_m)
        for i in range(2):
            _same_sample(ours_m[i], ref_m[i])


def test_preprocess_amass_npz_equals_reference(bodies, tmp_path):
    jm, tm = bodies
    rng = np.random.RandomState(0)
    raw = str(tmp_path / "raw.npz")
    np.savez(raw, poses=rng.randn(240, 156) * 0.1, trans=rng.randn(240, 3) * 0.1,
             betas=rng.randn(16), mocap_framerate=120.0, gender="male")
    for body in (None, "body"):
        want = np.load(jamass.preprocess_amass_npz(
            raw, str(tmp_path / "ref" / "p.npz"), body=body and jm), allow_pickle=True)
        got = np.load(tamass.preprocess_amass_npz(
            raw, str(tmp_path / "ours" / "p.npz"), body=body and tm), allow_pickle=True)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["foot_contacts"].shape == (60, 2)


def test_augmentations_equal_reference():
    pos = np.random.RandomState(1).randn(5, 4, 3).astype(np.float32)
    for fn in ("apply_random_rotation_to_pos", "apply_random_translation_to_pos"):
        want = getattr(jamass, fn)(pos, np.random.RandomState(2))
        got = getattr(tamass, fn)(pos, np.random.RandomState(2))
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert np.array_equal(a, b), fn
    root = pos[:, 0]
    assert np.array_equal(tamass.world_to_local_pos(pos, root),
                          jamass.world_to_local_pos(pos, root))


@pytest.mark.parametrize("parts", [None, [16, 18, 20]])
def test_smplh_dataset_equals_reference(bodies, parts):
    jm, tm = bodies
    ref = jsmplh.SMPLHDataset(jm, parts=parts, seed=6)
    ours = tsmplh.SMPLHDataset(tm, parts=parts, seed=6)
    assert np.array_equal(ours.face_ids, ref.face_ids)
    for got, want in ((ours.sample(64), ref.sample(64)), (ours[0], ref[0])):
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


def test_smplh_diff_dataset_equals_reference(bodies):
    jm, tm = bodies
    ref = jsmplh.SMPLHDiffDataset(jm, pad=0.1, seed=2)
    ours = tsmplh.SMPLHDiffDataset(tm, pad=0.1, seed=2)
    _same_sample(ours.sample(64), ref.sample(64))
    _same_sample(ours[0], ref[0])


def test_smpl_inference_equals_reference(bodies, tmp_path):
    jm, tm = bodies
    rng = np.random.RandomState(9)
    from uuo_mocap_tpu_torch.ops.rotations import axis_angle_to_matrix

    aa = (rng.randn(2, 5, 24, 3) * 0.3).astype(np.float32)
    mats = axis_angle_to_matrix(torch.as_tensor(aa)).numpy()
    betas = rng.randn(2, 5, 10).astype(np.float32)
    trans = rng.randn(2, 5, 3).astype(np.float32)
    ref = jsmpl.SmplInference(jm)
    ours = tsmpl.SmplInference(tm)
    want = ref(jnp.asarray(mats[..., 1:, :, :]), jnp.asarray(betas),
               jnp.asarray(mats[..., :1, :, :]), jnp.asarray(trans))
    got = ours(*(torch.as_tensor(a) for a in (mats[..., 1:, :, :], betas, mats[..., :1, :, :],
                                               trans)))
    for k in ("joints", "vertices"):
        _close(got[k], want[k], k)
    assert np.array_equal(ours.faces, ref.faces) and np.array_equal(ours.parents, ref.parents)
    _close(ours.get_lbs_weights(), ref.get_lbs_weights())
    with pytest.raises(ValueError, match="10 beta"):
        ours(*(torch.as_tensor(a) for a in (mats[..., 1:, :, :], betas[..., :9],
                                             mats[..., :1, :, :], trans)))
    # a model by path: the exported synthetic npz
    path = export_synthetic_npz(str(tmp_path / "smpl.npz"))
    _close(tsmpl.SmplInference(path, device="cpu").model.v_template, jm.v_template)
    if not torch.cuda.is_available():  # the synthetic default: the card unless asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsmpl.SmplInference()
    assert tsmpl.SmplInference(device="cpu").model.device.type == "cpu"


@pytest.mark.parametrize("pose2rot", [True, False])
def test_smpl_inference_gender_equals_reference(pose2rot):
    rng = np.random.RandomState(4)
    N, F = 2, 3
    from uuo_mocap_tpu_torch.ops.rotations import axis_angle_to_matrix

    pose = (rng.randn(N, F, 69) * 0.3).astype(np.float32)
    root = (rng.randn(N, F, 3) * 0.3).astype(np.float32)
    if not pose2rot:
        pose = axis_angle_to_matrix(torch.as_tensor(pose.reshape(N, F, 23, 3))).numpy()
        root = axis_angle_to_matrix(torch.as_tensor(root)).numpy()
    betas = rng.randn(N, 10).astype(np.float32)
    trans = rng.randn(N, F, 3).astype(np.float32)
    onehot = np.array([[0.3, 0.7], [1.0, 0.0]], np.float32)
    args = (pose, betas, root, trans, onehot)
    want = jsmpl.SmplInferenceGender()(*(jnp.asarray(a) for a in args), pose2rot=pose2rot,
                                       compute_part_labels=True)
    got = tsmpl.SmplInferenceGender(device="cpu")(*(torch.as_tensor(a) for a in args),
                                                  pose2rot=pose2rot, compute_part_labels=True)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)
    with pytest.raises(ValueError, match="2 dimensions"):
        tsmpl.SmplInferenceGender(device="cpu")(*(torch.as_tensor(a) for a in args[:4]),
                                                torch.as_tensor(onehot[0]))


def test_joint_helpers_and_exported_npz_equal_reference(tmp_path):
    for j in tjoints.get_all_joint_ids():
        assert tjoints.get_joint_name(j) == jjoints.get_joint_name(j)
    assert tjoints.get_all_joint_ids() == jjoints.get_all_joint_ids()
    for gender in ("neutral", "female"):
        ours = np.load(export_synthetic_npz(str(tmp_path / f"ours_{gender}.npz"), gender))
        ref = np.load(jax_export(str(tmp_path / f"ref_{gender}.npz"), gender))
        assert sorted(ours.files) == sorted(ref.files)
        for k in ref.files:
            assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k
    model = load_body_model(str(tmp_path / "ours_neutral.npz"), device="cpu")
    arrays = body_model_arrays(jax_synthetic_body_model())
    for k, v in body_model_arrays(model).items():
        assert np.array_equal(v, arrays[k]), k
