"""Contrastive temporal-alignment embeddings (counterpart of
``uuo_mocap_tpu/models/motion_embedding.py``).

``MarkerEmbedding`` and ``JointEmbedding`` map a window of points (markers
or joints) to a unit 32-vector; ``TemporalAlignmentModel.compute_offset``
picks the clock offset between a marker and a joint stream whose windows
embed nearest, from one [Fm, Fj] similarity matmul.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from uuo_mocap_tpu_torch.models.marker_segmenter import temporal_conv


class _WindowEncoder(nn.Module):
    def __init__(self, latent_dim: int = 64, out_dim: int = 32):
        super().__init__()
        D = latent_dim
        self.point_in = nn.Linear(6, D)
        self.point_out = nn.Linear(D, D)
        self.convs = nn.ModuleList(nn.Conv1d(2 * D if i == 0 else D, D, 3, padding=1)
                                   for i in range(2))
        self.head = nn.Linear(2 * D, D)
        self.out = nn.Linear(D, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, W, K, 3] (a window of K points) -> [N, out_dim] unit vectors:
        centred positions and forward-difference velocities x 10 through a
        two-layer point MLP, max and mean over the points, two temporal
        convolutions, mean and max over time, a two-layer head."""
        x = x - x.mean(dim=(1, 2), keepdim=True)
        vel = torch.cat([x[:, 1:] - x[:, :-1], torch.zeros_like(x[:, :1])], dim=1)
        h = torch.relu(self.point_in(torch.cat([x, vel * 10.0], dim=-1)))
        h = torch.relu(self.point_out(h))  # [N, W, K, D]
        h = torch.cat([h.amax(dim=2), h.mean(dim=2)], dim=-1)  # [N, W, 2D]
        for conv in self.convs:
            h = temporal_conv(conv, h)
        h = torch.cat([h.mean(dim=1), h.amax(dim=1)], dim=-1)  # [N, 2D]
        e = self.out(torch.relu(self.head(h)))
        return e / torch.clamp_min(torch.linalg.norm(e, dim=-1, keepdim=True), 1e-8)


class MarkerEmbedding(_WindowEncoder):
    """Windows of unlabelled markers -> 32-vectors."""


class JointEmbedding(_WindowEncoder):
    """Windows of joints -> 32-vectors."""


def _windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """[F, K, 3] -> [F - W + 1, W, K, 3], every window of W frames."""
    return x.unfold(0, window, 1).permute(0, 3, 1, 2)


class TemporalAlignmentModel:
    """Synchronise a marker and a joint stream by embedding distances."""

    def __init__(self, marker_net: MarkerEmbedding, joint_net: JointEmbedding, window: int = 16):
        self.window = window
        self.marker_net = marker_net
        self.joint_net = joint_net

    def embed_markers(self, markers: torch.Tensor) -> torch.Tensor:
        """[F, M, 3] -> [F - W + 1, 32] sliding-window embeddings."""
        return self.marker_net(_windows(markers, self.window))

    def embed_joints(self, joints: torch.Tensor) -> torch.Tensor:
        return self.joint_net(_windows(joints, self.window))

    def compute_offset(self, markers: torch.Tensor, joints: torch.Tensor
                       ) -> Tuple[int, torch.Tensor]:
        """The offset k of the markers against the joints whose diagonal
        cost[i, i + k] (1 - cosine similarity) has the least mean, the first
        such k from -(Fm - 1) up, and the means of every k."""
        with torch.no_grad():
            cost = 1.0 - self.embed_markers(markers) @ self.embed_joints(joints).T
        Fm, Fj = cost.shape
        dev = cost.device
        offsets = torch.arange(-(Fm - 1), Fj, device=dev)
        i = torch.arange(max(Fm, Fj), device=dev)
        j = i[None] + offsets[:, None]  # [K, L]
        valid = (i[None] < Fm) & (j >= 0) & (j < Fj)
        vals = cost[i.clamp(max=Fm - 1)[None], j.clamp(0, Fj - 1)]
        means = (torch.where(valid, vals, torch.zeros_like(vals)).sum(dim=-1)
                 / valid.sum(dim=-1).clamp_min(1))
        return int(offsets[torch.argmin(means)]), means
