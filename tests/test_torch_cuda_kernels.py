"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these need a GPU and nvcc and skip elsewhere (the plain
versions are held to the Pallas kernels by ``test_torch_chamfer.py``).
Run on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py`` (the root ``conftest.py`` imports JAX).
Tolerances: indices exactly except ties (random clouds have none), values
1e-5, the atomic backward 1e-5 (run-dependent summation order)."""
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


@pytest.mark.parametrize("L, F, M, V, with_bias", [(3, 19, 17, 700, False), (2, 5, 41, 6890, True),
                                                   (1, 2, 70, 300, True)])
def test_rank_kernel_matches_plain(dev, L, F, M, V, with_bias):
    g = torch.Generator().manual_seed(L * F + M)
    x, y = _cloud(g, L, F, M, dev=dev), _cloud(g, L, F, V, dev=dev)
    bias = ((torch.rand(L, V, generator=g) > 0.6).float() * 1e10).to(dev) if with_bias else None
    before = K.rank_nearest_cuda.launches
    idx = K.rank_nearest(x, y, bias)
    assert K.rank_nearest_cuda.launches == before + 1
    torch.testing.assert_close(idx.cpu(), K.rank_nearest_plain(x.cpu(), y.cpu(),
                                                               None if bias is None else bias.cpu()))


@pytest.mark.parametrize("B, M, V", [(4, 41, 6890), (3, 6890, 41), (2, 50, 50), (2, 1000, 300)])
def test_min_sqdist_forward_kernel_matches_plain(dev, B, M, V):
    g = torch.Generator().manual_seed(B + M + V)
    x, y = _cloud(g, B, M, dev=dev), _cloud(g, B, V, dev=dev)
    bias = ((torch.rand(B, V, generator=g) > 0.7).float() * 1e10).to(dev)
    val, idx = K.min_sqdist_forward_cuda(x, y, bias)
    val_p, idx_p = K.min_sqdist_forward_plain(x.cpu(), y.cpu(), bias.cpu())
    np.testing.assert_array_equal(idx.cpu().long().numpy(), idx_p.numpy())
    np.testing.assert_allclose(val.cpu().numpy(), val_p.numpy(), atol=1e-5, rtol=0)


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
