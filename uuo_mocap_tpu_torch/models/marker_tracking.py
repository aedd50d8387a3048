"""Experimental marker relabelling models (counterpart of
``uuo_mocap_tpu/models/marker_tracking.py``; the solve uses neither):
``PermutationLearningModel`` predicts a soft permutation per frame through
Sinkhorn normalisation, ``MarkerTrackingAttention`` runs self-attention
over the frame x marker tokens and classifies each token's marker id."""
from __future__ import annotations

import torch
from torch import nn

from uuo_mocap_tpu_torch.models.marker_segmenter import AttentionBlock


def sinkhorn(log_alpha: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Scores [..., M, M] -> a doubly stochastic matrix: ``iters`` rounds of
    log-domain normalisation, rows then columns."""
    for _ in range(iters):
        log_alpha = log_alpha - torch.logsumexp(log_alpha, dim=-1, keepdim=True)
        log_alpha = log_alpha - torch.logsumexp(log_alpha, dim=-2, keepdim=True)
    return torch.exp(log_alpha)


class PermutationLearningModel(nn.Module):
    """[N, F, M, 3] -> soft permutations [N, F, M, M]."""

    def __init__(self, num_markers: int = 41, latent_dim: int = 128):
        super().__init__()
        self.embed = nn.Linear(3 * num_markers, latent_dim)
        self.residual = nn.Linear(latent_dim, latent_dim)
        self.scores = nn.Linear(latent_dim, num_markers * num_markers)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        N, F, M, _ = points.shape
        x = points - points.mean(dim=2, keepdim=True)
        h = torch.relu(self.embed(x.reshape(N, F, M * 3)))
        h = h + torch.relu(self.residual(h))
        return sinkhorn(self.scores(h).reshape(N, F, M, M))


class MarkerTrackingAttention(nn.Module):
    """[N, F, M, 3] -> marker id logits [N, F, M, num_markers]: an embedding,
    ``num_layers`` attention blocks (4 heads) over the F x M tokens, a
    classifier."""

    def __init__(self, latent_dim: int = 64, num_layers: int = 2, num_markers: int = 41):
        super().__init__()
        self.embed = nn.Linear(3, latent_dim)
        self.blocks = nn.ModuleList(AttentionBlock(latent_dim) for _ in range(num_layers))
        self.classify = nn.Linear(latent_dim, num_markers)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        N, F, M, _ = points.shape
        x = self.embed(points).reshape(N, F * M, -1)
        for block in self.blocks:
            x = block(x)
        return self.classify(x).reshape(N, F, M, -1)
