"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these need a GPU and nvcc and skip elsewhere (the plain
versions are held to the Pallas kernels by ``test_torch_chamfer.py``).
Run on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py`` (the root ``conftest.py`` imports JAX).
Tolerances: indices exactly except ties (random clouds have none), values
1e-5; the backward exactly, bit for bit: it writes each sum in the order
m = 0, 1, ... without atomics, as the CPU's ``index_add_`` does."""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import numpy as np
import pytest
import torch

from uuo_mocap_tpu_torch.ops import chamfer as tchamfer
from uuo_mocap_tpu_torch.ops import chamfer_kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    K.build()
    return torch.device("cuda")


def _cloud(g, *shape, dev):
    return torch.randn(*shape, 3, generator=g).to(dev) + torch.tensor([1.0, -2.0, 0.5], device=dev)


# M in {1, 17, 41, 64, 70} (70: 10 query groups of 7); odd L * F and
# V with 3V not a multiple of 4, so frames start at every 16-byte
# misalignment
@pytest.mark.parametrize("L, F, M, V, with_bias", [(3, 19, 17, 701, False), (3, 5, 41, 6890, True),
                                                   (1, 3, 70, 301, True), (1, 7, 1, 513, False),
                                                   (2, 3, 64, 1001, True), (1, 5, 41, 6890, False)])
def test_rank_kernel_matches_plain(dev, L, F, M, V, with_bias):
    g = torch.Generator().manual_seed(L * F + M)
    x, y = _cloud(g, L, F, M, dev=dev), _cloud(g, L, F, V, dev=dev)
    bias = ((torch.rand(L, V, generator=g) > 0.6).float() * 1e10).to(dev) if with_bias else None
    before = K.rank_nearest_cuda.launches
    idx = K.rank_nearest(x, y, bias)
    assert K.rank_nearest_cuda.launches == before + 1
    torch.testing.assert_close(idx.cpu(), K.rank_nearest_plain(x.cpu(), y.cpu(),
                                                               None if bias is None else bias.cpu()))


def test_rank_kernel_single_vertex_bias(dev):
    """A bias that leaves one vertex per lane: every query of the lane picks it."""
    L, F, M, V = 3, 7, 41, 6890
    g = torch.Generator().manual_seed(5)
    x, y = _cloud(g, L, F, M, dev=dev), _cloud(g, L, F, V, dev=dev)
    keep = torch.tensor([0, 4321, V - 1])
    bias = torch.full((L, V), 1e10)
    bias[torch.arange(L), keep] = 0.0
    idx = K.rank_nearest(x, y, bias.to(dev))
    assert (idx.cpu() == keep[:, None, None]).all()


def test_rank_kernel_refuses_a_frame_too_large_for_shared_memory(dev):
    """A frame the block cannot stage: the wrapper raises before launching,
    naming the shared memory the frame needs and the limit, and the next
    launch is clean."""
    x = torch.zeros(1, 1, 4, 3, device=dev)
    before = K.rank_nearest_cuda.launches
    with pytest.raises(RuntimeError, match="uuo_rank_nearest: a frame of 20000 vertices needs"):
        K.rank_nearest_cuda(x, torch.zeros(1, 1, 20000, 3, device=dev))
    assert K.rank_nearest_cuda.launches == before
    y = torch.randn(1, 1, 300, 3, device=dev)
    assert torch.equal(K.rank_nearest(x, y).cpu(), K.rank_nearest_plain(x.cpu(), y.cpu()))
    torch.cuda.synchronize()


@pytest.mark.parametrize("B, M, V", [(3, 41, 6890), (5, 70, 1000), (1, 300, 37), (7, 41, 2049)])
def test_backward_kernel_is_repeatable_and_exact(dev, B, M, V):
    """Odd B, ragged V tiles, many duplicate indices and some outside
    [0, V) (which add nothing): two launches are bitwise equal, and equal
    to the CPU plain version bit for bit."""
    rng = np.random.RandomState(B * M + V)
    idx = rng.randint(-3, V + 3, size=(B, M))
    idx[:, : M // 2] = rng.randint(0, min(V, 5), size=(B, M // 2))  # duplicates
    diff = rng.randn(B, M, 3).astype(np.float32)
    gw = rng.randn(B, M).astype(np.float32)
    args = [torch.as_tensor(a).to(dev) for a in (idx.astype(np.int32), diff, gw)]
    before = K.min_sqdist_backward_cuda.launches
    first = K.min_sqdist_backward(*args, V)
    second = K.min_sqdist_backward(*args, V)
    assert K.min_sqdist_backward_cuda.launches == before + 2
    inside = (idx >= 0) & (idx < V)
    ref = K.min_sqdist_backward_plain(torch.as_tensor(np.where(inside, idx, 0)),
                                      torch.as_tensor(diff * inside[..., None]),
                                      torch.as_tensor(gw * inside), V)
    for a, b, r in zip(first, second, ref):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), r)


def _body_cloud(g, *shape, dev):
    """Points at a body's scale (0.3 m spread around a hip-height centre),
    where a float32 key rounds by ~6e-8 m^2."""
    pts = torch.randn(*shape, 3, generator=g) * 0.3 + torch.tensor([0.4, 1.1, -0.2])
    return pts.to(dev)


def _assert_forward_matches_plain(x, y, bias, val, idx):
    """The forward's tolerances (chip_smoke.py): every pick that differs from
    the plain version's is a tie whose float64 d2 gap is <= 1e-7 m^2, and
    every value is within 1e-6 m^2 of the plain version's."""
    val_p, idx_p = K.min_sqdist_forward_plain(x.cpu(), y.cpu(), bias.cpu())
    idx = idx.cpu().long()

    def d2(i):
        yb = torch.gather(y.cpu().double(), 1, i[..., None].expand(*i.shape, 3))
        return ((x.cpu().double() - yb) ** 2).sum(-1) + torch.gather(bias.cpu().double(), 1, i)

    gap = (d2(idx) - d2(idx_p)).abs()
    assert bool((gap[idx != idx_p] <= 1e-7).all()), float(gap.max())
    np.testing.assert_allclose(val.cpu().numpy(), val_p.numpy(), atol=1e-6, rtol=0)


# few queries (M <= V): odd B at V = 6890 (frames start at every 16-byte
# misalignment), M = 1, and V = 20000, beyond one frame's shared memory
# (staged in chunks); many queries (M > V): 6890 against 41 with odd B
# (elements start off the 4-query grid), 1000 against 300, 3000 against
# 1500 (targets in two tiles), and M = 2000 > 1024 against V = 5000
@pytest.mark.parametrize("B, M, V", [(4, 41, 6890), (3, 6890, 41), (2, 50, 50), (2, 1000, 300),
                                     (5, 41, 6890), (3, 1, 6890), (2, 41, 20000), (5, 6890, 41),
                                     (2, 3000, 1500), (2, 2000, 5000)])
def test_min_sqdist_forward_kernel_matches_plain(dev, B, M, V):
    g = torch.Generator().manual_seed(B + M + V)
    x, y = _body_cloud(g, B, M, dev=dev), _body_cloud(g, B, V, dev=dev)
    bias = ((torch.rand(B, V, generator=g) > 0.7).float() * 1e10).to(dev)
    staged = M <= min(V, K.STAGED_MAX_M)
    before = K.launch_counts()
    val, idx = K.min_sqdist_forward_cuda(x, y, bias)
    after = K.launch_counts()
    assert after["min_sqdist_forward_cuda"] - before["min_sqdist_forward_cuda"] == int(staged)
    assert after["min_sqdist_forward_rev_cuda"] - before["min_sqdist_forward_rev_cuda"] == int(not staged)
    _assert_forward_matches_plain(x, y, bias, val, idx)


@pytest.mark.parametrize("B, M, V", [(3, 41, 6890), (3, 6890, 41)])
def test_min_sqdist_forward_kernel_single_target_bias(dev, B, M, V):
    """Every target but one per row carries the 1e10 bias: every query of
    the row picks that one, at its own distance."""
    g = torch.Generator().manual_seed(11 + M)
    x, y = _body_cloud(g, B, M, dev=dev), _body_cloud(g, B, V, dev=dev)
    keep = torch.tensor([0, V // 2, V - 1])
    bias = torch.full((B, V), 1e10)
    bias[torch.arange(B), keep] = 0.0
    val, idx = K.min_sqdist_forward_cuda(x, y, bias.to(dev))
    assert (idx.cpu().long() == keep[:, None]).all()
    _assert_forward_matches_plain(x, y, bias.to(dev), val, idx)


@pytest.mark.parametrize("B, M, V", [(3, 41, 6890), (3, 6890, 41)])
def test_min_sqdist_forward_kernel_unaligned_inputs(dev, B, M, V):
    """Inputs that do not start on 16 bytes (views one float into a
    buffer): both routes give what they give on aligned copies."""
    g = torch.Generator().manual_seed(17 + M)
    x, y = _body_cloud(g, B, M, dev=dev), _body_cloud(g, B, V, dev=dev)
    bias = ((torch.rand(B, V, generator=g) > 0.7).float() * 1e10).to(dev)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    val, idx = K.min_sqdist_forward_cuda(shifted(x), shifted(y), shifted(bias))
    val_a, idx_a = K.min_sqdist_forward_cuda(x, y, bias)
    assert torch.equal(idx, idx_a) and torch.equal(val, val_a)
    _assert_forward_matches_plain(x, y, bias, val, idx)


def test_min_sqdist_gradient_on_cuda_matches_cpu(dev):
    g = torch.Generator().manual_seed(7)
    x, y = _cloud(g, 3, 23, dev="cpu"), _cloud(g, 3, 300, dev="cpu")
    w = torch.randn(3, 23, generator=g)
    grads = []
    for d in ("cpu", dev):
        xt, yt = (t.to(d).detach().clone().requires_grad_(True) for t in (x, y))
        bt = torch.zeros(3, 300, device=d, requires_grad=True)
        (w.to(d) * tchamfer.min_sqdist(xt, yt, bt)).sum().backward()
        grads.append([t.grad.cpu() for t in (xt, yt, bt)])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=0)


def test_marker_to_surface_distance_on_cuda_matches_cpu(dev):
    """The m2s metric (plain PyTorch, frame chunks of 32) on the card against
    the CPU on the same body and markers: within 1e-6 m, per point and in
    the mean (elementwise float32 in both; no TF32 path)."""
    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.data.synthetic import generate_markers, random_pose_sequence
    from uuo_mocap_tpu_torch.ops.point_mesh import marker_to_surface_distance, point_mesh_distance

    model = synthetic_body_model(device="cpu")
    gt = random_pose_sequence(40, seed=3, device="cpu")
    markers = generate_markers(model, gt, num_markers=41, seed=4, position_noise=0.01).points
    with torch.no_grad():
        verts = lbs_forward(model, gt.pose_body, gt.betas, gt.root_orient, gt.trans)["vertices"]
    ref = marker_to_surface_distance(markers, verts, model.faces)
    out = marker_to_surface_distance(markers.to(dev), verts.to(dev), model.faces)
    assert out.device.type == "cuda"
    assert abs(float(out) - float(ref)) <= 1e-6
    d_ref = point_mesh_distance(markers[:5], verts[:5], model.faces)["distance"]
    d_out = point_mesh_distance(markers[:5].to(dev), verts[:5].to(dev), model.faces)["distance"]
    torch.testing.assert_close(d_out.cpu(), d_ref, atol=1e-6, rtol=0)
