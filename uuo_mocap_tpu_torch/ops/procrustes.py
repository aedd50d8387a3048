"""Batched similarity (Procrustes) alignment (counterpart of
``uuo_mocap_tpu/ops/procrustes.py``): the (s, R, t) minimizing
||s R S1 + t - S2|| per batch element, applied to S1."""
from __future__ import annotations

import torch


def similarity_transform(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] x [B, N, 3] -> aligned S1 [B, N, 3]."""
    X1, X2 = S1.transpose(-1, -2), S2.transpose(-1, -2)  # [B, 3, N]
    mu1, mu2 = X1.mean(-1, keepdim=True), X2.mean(-1, keepdim=True)
    X1c, X2c = X1 - mu1, X2 - mu2
    var1 = (X1c * X1c).sum(dim=(-1, -2))  # [B]
    K = X1c @ X2c.transpose(-1, -2)  # [B, 3, 3]
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)
    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).expand(K.shape).clone()
    Z[..., -1, -1] = torch.sign(torch.linalg.det(U @ Vh))
    R = V @ Z @ U.transpose(-1, -2)
    trace = torch.diagonal(R @ K, dim1=-2, dim2=-1).sum(-1)
    scale = (trace / torch.clamp_min(var1, 1e-12))[..., None, None]
    t = mu2 - scale * (R @ mu1)
    return (scale * (R @ X1) + t).transpose(-1, -2)
