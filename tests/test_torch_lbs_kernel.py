"""The dense LBS kernel (``ops/lbs_kernels.py``, ``csrc/lbs.cu``) and the
dispatch in ``body.model.lbs_forward``.

CPU cases (the synthetic body, V = 6890, at 2 x 3 rows; under 5 s with the
model's build): CPU and grad-enabled forwards keep the plain arithmetic bit
for bit and never reach the kernel; the card route's rest joints
(``j_template + j_shapedirs . betas``) match the plain route's
(``j_regressor @ v_shaped``) within 1e-6 m; the compact weight list gives
back ``lbs_weights`` exactly; and the kernel's tables, contracted in
PyTorch as the kernel contracts them, give the plain forward's vertices.

Card cases (marked ``cuda``; run with ``python -m pytest --noconftest -m
cuda tests/test_torch_lbs_kernel.py``): the kernel against the plain
arithmetic at L = 16, F = 450 (the part fit's working set) and at ragged
row and vertex tiles (111 rows; V = 6890 and an odd V = 301, a cut of the
body) with betas broadcast over frames.  Tolerance 5e-6 m: FP32 sums over
K = 218 (207 pose correctives, 10 betas and the template) and over a
vertex's weights, in another order than the plain chain's GEMMs.  Then the
rank kernel's picks on both vertex sets (>= 0.9999 equal, a differing
pick at most 1e-7 m^2 from the other: ``chip_smoke.py``'s gate), the
wrapper's refusals, and that a grad-enabled forward never launches it.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import pytest
import torch

from uuo_mocap_tpu_torch.body import model as bm
from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
from uuo_mocap_tpu_torch.ops import chamfer_kernels as CK
from uuo_mocap_tpu_torch.ops import lbs_kernels as K
from uuo_mocap_tpu_torch.ops.rotations import axis_angle_to_matrix
from uuo_mocap_tpu_torch.utils import tracing

TOL_M = 5e-6


def _inputs(g, L, F, dev="cpu"):
    """pose_body [L, F, 23, 3, 3], betas [L, 1, 10] (per lane, broadcast over
    frames), root [L, F, 1, 3, 3], trans [L, F, 3]."""
    pose = axis_angle_to_matrix(0.4 * torch.randn(L, F, 23, 3, generator=g))
    root = axis_angle_to_matrix(torch.randn(L, F, 1, 3, generator=g))
    betas = torch.randn(L, 1, 10, generator=g)
    trans = torch.randn(L, F, 3, generator=g)
    return tuple(t.to(dev) for t in (pose, betas, root, trans))


@pytest.fixture(scope="module")
def cpu_model():
    return synthetic_body_model(device="cpu")


# ------------------------------------------------------------------- CPU

def test_cpu_and_grad_calls_keep_the_plain_arithmetic(cpu_model):
    g = torch.Generator().manual_seed(0)
    pose, betas, root, trans = _inputs(g, 2, 3)
    launches, rows0, krows0 = (K.lbs_vertices_cuda.launches, tracing.dense_lbs_rows(),
                               tracing.dense_lbs_kernel_rows())
    plain = bm.lbs_forward_plain(cpu_model, pose, betas, root, trans)
    with torch.no_grad():
        out = bm.lbs_forward(cpu_model, pose, betas, root, trans)
    betas_g = betas.clone().requires_grad_(True)
    out_g = bm.lbs_forward(cpu_model, pose, betas_g, root, trans)
    for o in (out, out_g):
        assert set(o) == {"joints", "vertices"}
        assert o["joints"].shape == (2, 3, 45, 3) and o["vertices"].shape == (2, 3, 6890, 3)
        for k in o:
            assert torch.equal(o[k], plain[k]), k
    out_g["vertices"].sum().backward()
    assert betas_g.grad is not None and torch.isfinite(betas_g.grad).all()
    assert K.lbs_vertices_cuda.launches == launches
    assert tracing.dense_lbs_rows() - rows0 == 2 * 6
    assert tracing.dense_lbs_kernel_rows() == krows0


def test_pre_contracted_rest_joints_match_the_regressor(cpu_model):
    g = torch.Generator().manual_seed(1)
    betas = 2.0 * torch.randn(5, 10, generator=g)
    v_shaped = cpu_model.v_template + (betas @ cpu_model.shapedirs_flat).reshape(5, -1, 3)
    plain = cpu_model.j_regressor @ v_shaped
    card = cpu_model.j_template + torch.einsum("jdk,...k->...jd", cpu_model.j_shapedirs, betas)
    assert float((plain - card).abs().max()) <= 1e-6


def test_weight_list_gives_back_the_lbs_weights(cpu_model):
    w = cpu_model.lbs_weights
    joints, weights = K.weight_list(w)
    assert joints.dtype == torch.int32 and weights.dtype == w.dtype
    assert joints.shape == weights.shape == (w.shape[0], int((w != 0).sum(-1).max()))
    back = torch.zeros_like(w)
    back.scatter_add_(1, joints.long(), weights)
    assert torch.equal(back, w)
    # every nonzero weight kept once, in joint order; padding is (0, 0)
    assert torch.equal((weights != 0).sum(-1), (w != 0).sum(-1))
    j = torch.where(weights != 0, joints, torch.iinfo(torch.int32).max)
    assert bool((j[:, 1:] >= j[:, :-1]).all())
    assert bool((joints[weights == 0] == 0).all())


def test_tables_contracted_as_the_kernel_give_the_plain_vertices(cpu_model):
    """The kernel's arithmetic in PyTorch on its tables: one product of
    [pose_feature, betas, 1, 0...] with the basis, then each vertex's listed
    transforms (1e-5 m: the basis folds the template and shape term into
    the 224-deep sum)."""
    g = torch.Generator().manual_seed(2)
    pose, betas, root, trans = _inputs(g, 2, 3)
    N, V = 6, cpu_model.num_vertices
    tables = K.lbs_tables(cpu_model.v_template, cpu_model.shapedirs, cpu_model.posedirs,
                          cpu_model.lbs_weights)
    assert tables.basis.shape == (K.DEPTH, 3 * 54 * K.VERTEX_TILE)
    b = betas.expand(2, 3, 10).reshape(N, 10)
    jr = cpu_model.j_template + torch.einsum("jdk,...k->...jd", cpu_model.j_shapedirs, b)
    rot = torch.cat([root, pose], dim=-3).reshape(N, 24, 3, 3)
    _, A = bm._compose_kinematic_chain(rot, jr, cpu_model.parents, cpu_model.levels)
    row = torch.cat([(pose.reshape(N, 23, 3, 3) - torch.eye(3)).reshape(N, 207), b,
                     torch.ones(N, 1), torch.zeros(N, K.DEPTH - 218)], dim=1)
    v_posed = (row @ tables.basis)[:, :3 * V].reshape(N, V, 3)
    T = (tables.weights[None, :, :, None]
         * A.reshape(N, 24, 12)[:, tables.joints.long()]).sum(2).reshape(N, V, 3, 4)
    verts = (T[..., :3] @ v_posed[..., None])[..., 0] + T[..., 3] + trans.reshape(N, 1, 3)
    plain = bm.lbs_forward_plain(cpu_model, pose, betas, root, trans)["vertices"]
    assert float((verts - plain.reshape(N, V, 3)).abs().max()) <= 1e-5


# ------------------------------------------------------------------ card


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    K.build()
    return synthetic_body_model(device="cuda")


def _plain_vertices(model_t, pf, betas, aff, trans):
    """The plain chain's vertex arithmetic (``lbs_forward_plain``) from the
    kernel's inputs, for a model ``(v_template, shapedirs, posedirs,
    lbs_weights)`` of any V."""
    v_template, shapedirs, posedirs, lbs_weights = model_t
    N, V = pf.shape[0], v_template.shape[0]
    v_shaped = v_template + (betas @ shapedirs.reshape(3 * V, 10).T).reshape(N, V, 3)
    v_posed = v_shaped + (pf @ posedirs).reshape(N, V, 3)
    T = (lbs_weights @ aff).reshape(N, V, 3, 4)
    vx, vy, vz = v_posed[..., 0:1], v_posed[..., 1:2], v_posed[..., 2:3]
    return T[..., 0] * vx + T[..., 1] * vy + T[..., 2] * vz + T[..., 3] + trans[:, None, :]


@pytest.mark.cuda
@pytest.mark.parametrize("L, F", [(16, 450), (3, 37)])
def test_kernel_matches_the_plain_forward(card_model, L, F):
    g = torch.Generator().manual_seed(L * F)
    inputs = _inputs(g, L, F, "cuda")
    launches = K.lbs_vertices_cuda.launches
    with torch.no_grad():
        out = bm.lbs_forward(card_model, *inputs)
        plain = bm.lbs_forward_plain(card_model, *inputs)
    torch.cuda.synchronize()
    assert K.lbs_vertices_cuda.launches == launches + 1
    assert out["vertices"].shape == (L, F, 6890, 3) and out["vertices"].is_contiguous()
    assert float((out["vertices"] - plain["vertices"]).abs().max()) <= TOL_M
    assert float((out["joints"] - plain["joints"]).abs().max()) <= TOL_M


@pytest.mark.cuda
def test_kernel_at_an_odd_vertex_count(card_model):
    """V = 301 (odd, so rows start 4-byte aligned only, and a partial
    vertex tile) at 111 rows."""
    V, N = 301, 111
    m = card_model
    cut = (m.v_template[:V].contiguous(), m.shapedirs[:V].contiguous(),
           m.posedirs[:, :3 * V].contiguous(), m.lbs_weights[:V].contiguous())
    tables = K.lbs_tables(*cut)
    g = torch.Generator().manual_seed(3)
    pose, betas, root, trans = _inputs(g, 3, 37, "cuda")
    b = betas.expand(3, 37, 10).reshape(N, 10).contiguous()
    jr = m.j_template + torch.einsum("jdk,...k->...jd", m.j_shapedirs, b)
    rot = torch.cat([root, pose], dim=-3).reshape(N, 24, 3, 3)
    _, A = bm._compose_kinematic_chain(rot, jr, m.parents, m.levels)
    pf = (pose.reshape(N, 23, 3, 3) - torch.eye(3, device="cuda")).reshape(N, 207)
    aff, tr = A.reshape(N, 24, 12).contiguous(), trans.reshape(N, 3).contiguous()
    out = K.lbs_vertices_cuda(pf, b, aff, tr, tables)
    ref = _plain_vertices(cut, pf, b, aff, tr)
    assert float((out - ref).abs().max()) <= TOL_M


@pytest.mark.cuda
def test_rank_picks_agree_on_kernel_and_plain_vertices(card_model):
    L, F, M = 16, 450, 41
    g = torch.Generator().manual_seed(4)
    inputs = _inputs(g, L, F, "cuda")
    with torch.no_grad():
        verts = bm.lbs_forward(card_model, *inputs)["vertices"]
        plain = bm.lbs_forward_plain(card_model, *inputs)["vertices"]
        ids = torch.randint(0, 6890, (M,), generator=g).cuda()
        markers = plain[:, :, ids] + 0.01 * torch.randn(L, F, M, 3, generator=g).cuda()
        a = CK.rank_nearest(markers, verts)
        b = CK.rank_nearest(markers, plain)
        same = float((a == b).double().mean())
        d2 = lambda i: ((torch.gather(plain, 2, i[..., None].expand(L, F, M, 3)) - markers)
                        ** 2).sum(-1)
        gap = float((d2(a) - d2(b)).abs().max())
    assert same >= 0.9999, same
    assert gap <= 1e-7, gap


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card_model):
    N = 5
    pf = torch.zeros(N, 207, device="cuda")
    betas, aff = torch.zeros(N, 10, device="cuda"), torch.zeros(N, 24, 12, device="cuda")
    trans = torch.zeros(N, 3, device="cuda")
    tables = card_model.lbs_tables
    K.lbs_vertices_cuda(pf, betas, aff, trans, tables)
    with pytest.raises(ValueError, match="float32"):
        K.lbs_vertices_cuda(pf.double(), betas, aff, trans, tables)
    with pytest.raises(ValueError, match="contiguous"):
        K.lbs_vertices_cuda(torch.zeros(207, N, device="cuda").T, betas, aff, trans, tables)
    with pytest.raises(ValueError, match="CUDA"):
        K.lbs_vertices_cuda(pf.cpu(), betas, aff, trans, tables)


@pytest.mark.cuda
def test_grad_enabled_forward_never_launches_the_kernel(card_model):
    g = torch.Generator().manual_seed(5)
    pose, betas, root, trans = _inputs(g, 2, 4, "cuda")
    trans.requires_grad_(True)
    launches = K.lbs_vertices_cuda.launches
    out = bm.lbs_forward(card_model, pose, betas, root, trans)
    out["vertices"].sum().backward()
    torch.cuda.synchronize()
    assert K.lbs_vertices_cuda.launches == launches
    assert trans.grad is not None
