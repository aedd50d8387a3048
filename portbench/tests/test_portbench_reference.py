"""The plain reference at tiny sizes against cases worked out by hand."""
import math

import numpy as np
import pytest
import torch

from portbench.reference import body, check
from portbench.reference.body import NUM_JOINTS, PARENTS


@pytest.fixture(scope="module")
def model():
    return body.model_tensors(body.build_arrays())


def rest(F=2, dtype=torch.float64):
    eye = torch.eye(3, dtype=dtype)
    return {"pose_body": eye.expand(F, 23, 3, 3).clone(), "betas": torch.zeros(1, 10, dtype=dtype),
            "root_orient": eye.expand(F, 1, 3, 3).clone(), "trans": torch.zeros(F, 3, dtype=dtype)}


def pose(model, p, ids=None):
    return body.lbs(model, p["pose_body"], p["betas"], p["root_orient"], p["trans"], ids)


def test_rest_pose_is_the_template_and_the_regressed_joints(model):
    out = pose(model, rest())
    assert torch.allclose(out["vertices"][0], model["v_template"], atol=1e-12)
    assert torch.allclose(out["joints"][0], model["j_regressor"] @ model["v_template"], atol=1e-12)


def test_translation_moves_every_vertex_and_joint(model):
    p = rest()
    p["trans"][1] = torch.tensor([0.3, -0.2, 1.0], dtype=torch.float64)
    out = pose(model, p)
    d = out["vertices"][1] - out["vertices"][0]
    assert torch.allclose(d, p["trans"][1].expand_as(d), atol=1e-12)


def test_a_quarter_turn_of_the_root_about_y(model):
    p = rest(F=1)
    p["root_orient"][0, 0] = body.axis_angle_to_matrix(torch.tensor([0.0, math.pi / 2, 0.0],
                                                                    dtype=torch.float64))
    j0 = pose(model, rest(F=1))["joints"][0]
    j1 = pose(model, p)["joints"][0]
    rel0, rel1 = j0 - j0[0], j1 - j1[0]
    # (x, y, z) -> (z, y, -x) about the pelvis, which stays where it is
    assert torch.allclose(rel1, torch.stack([rel0[:, 2], rel0[:, 1], -rel0[:, 0]], -1), atol=1e-12)
    assert torch.allclose(j1[0], j0[0], atol=1e-12)


def test_a_bent_joint_moves_only_its_subtree(model):
    p = rest(F=1)
    knee = 4  # left_knee: its subtree is the left ankle and foot
    p["pose_body"][0, knee - 1] = body.axis_angle_to_matrix(torch.tensor([1.0, 0.0, 0.0],
                                                                         dtype=torch.float64))
    j0, j1 = pose(model, rest(F=1))["joints"][0], pose(model, p)["joints"][0]
    moved = {j for j in range(NUM_JOINTS) if not torch.allclose(j0[j], j1[j], atol=1e-12)}
    subtree = {j for j in range(NUM_JOINTS) if j != knee and knee in _ancestors(j)}
    assert moved == subtree == {7, 10}


def _ancestors(j):
    out = []
    while PARENTS[j] >= 0:
        j = int(PARENTS[j])
        out.append(j)
    return out


def test_vertices_at_selected_ids_equal_the_dense_forward(model):
    g = torch.Generator().manual_seed(3)
    p = rest(F=3)
    p["pose_body"] = body.axis_angle_to_matrix(0.3 * torch.randn(3, 23, 3, generator=g,
                                                                 dtype=torch.float64))
    p["betas"] = torch.randn(1, 10, generator=g, dtype=torch.float64)
    ids = torch.tensor([0, 17, 4000, 6889])
    assert torch.allclose(pose(model, p, ids)["vertices"], pose(model, p)["vertices"][:, ids],
                          atol=1e-12)


def test_chamfer_score_by_hand(model):
    p = rest(F=1)
    verts = pose(model, p)["vertices"][0]
    markers = verts[[10, 2000, 5000]].clone().numpy()[None]  # [1, 3, 3]
    assert check.chamfer_score(model, markers, p) == 0.0
    markers[0, 1] += [0.001, 0.0, 0.0]  # 1 mm: well inside the vertex spacing
    markers = np.concatenate([markers, np.zeros((1, 1, 3))], axis=1)  # an occluded marker
    assert check.chamfer_score(model, markers, p) == pytest.approx(1e-6 / 3, rel=1e-9)


def test_mean_distances_and_the_pick_and_label_gaps_by_hand(model):
    p = rest(F=2)
    verts = pose(model, p)["vertices"][0]
    a, b = 100, 5000
    markers = np.stack([verts[[a, b]].numpy()] * 2)  # [2, 2, 3]: two markers on two vertices
    markers[1, 0] += [0.0, 0.002, 0.0]  # 2 mm off its vertex in the second frame
    d = check.mean_distances(model, markers, p)
    assert d.shape == (2, 6890)
    assert float(d[0, a]) == pytest.approx(1e-3, rel=1e-9) and float(d[1, b]) == 0.0
    assert int(d[0].argmin()) == a and int(d[1].argmin()) == b
    assert check.pick_gap_mm(d, [a, b]) == 0.0
    assert check.pick_gap_mm(d, [a, a]) == pytest.approx(float(d[1, a]) * 1e3, rel=1e-12)
    labels_v = check.vertex_labels(model)
    right = labels_v[[a, b]]
    assert check.label_gap_mm(d, labels_v, right) == 0.0
    other = labels_v != right[0]
    wrong = torch.stack([labels_v[other][int(d[0][other].argmin())], right[1]])
    want = (float(d[0][other].min()) - float(d[0, a])) * 1e3
    assert check.label_gap_mm(d, labels_v, wrong) == pytest.approx(want, rel=1e-12) and want > 0


def test_mpjpe_by_hand(model):
    p, q = rest(F=4), rest(F=4)
    q["trans"] = q["trans"] + torch.tensor([0.003, 0.004, 0.0], dtype=torch.float64)
    assert check.mpjpe_mm(model, p, p) == 0.0
    assert check.mpjpe_mm(model, q, p) == pytest.approx(5.0, rel=1e-9)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, -2.5], dtype=torch.float32)
    # 10 mantissa bits: 1 + 2^-11 is a tie and goes to the even 1.0, 1 + 3 * 2^-11 up to 1 + 2^-9
    want = torch.tensor([1.0, 1.0, 1.0 + 2**-9, 1.0 + 2**-10, -2.5], dtype=torch.float32)
    assert torch.equal(body._round_tf32(x), want)
    a = torch.tensor([[1.0 + 2**-12, 2.0]])
    assert torch.equal(body.matmul(a, torch.ones(2, 1), tf32=True), torch.tensor([[3.0]]))


def test_the_tf32_control_reads_far_above_float32(model):
    g = torch.Generator().manual_seed(4)
    p = rest(F=6)
    p["pose_body"] = body.axis_angle_to_matrix(0.4 * torch.randn(6, 23, 3, generator=g,
                                                                 dtype=torch.float64))
    markers = pose(model, p)["vertices"][:, ::170][:, :40].numpy() + 0.0095
    m32 = body.model_tensors(body.build_arrays(), torch.float32)
    ref = check.chamfer_score(model, markers, p)
    gap32 = abs(check.chamfer_score(m32, markers, p) - ref) / ref
    gap_tf32 = abs(check.chamfer_score(m32, markers, p, tf32=True) - ref) / ref
    assert gap32 < 1e-5 < gap_tf32
