"""Multimodal (markers + video joints) part segmenter (counterpart of
``uuo_mocap_tpu/models/marker_segmenter_multimodal.py``): the marker branch
of ``MarkerSegmenter`` fused with an embedding of the HMR 22-joint stream,
whose max-pooled global feature conditions every marker's class."""
from __future__ import annotations

import torch
from torch import nn

from uuo_mocap_tpu_torch.models.marker_segmenter import (
    NUM_PARTS, MarkerSegmenter, temporal_conv, windowed_softmax)


class MarkerSegmenterMultimodal(MarkerSegmenter):
    def __init__(self, latent_dim: int = 128, num_classes: int = NUM_PARTS, num_joints: int = 22):
        super().__init__(latent_dim, num_classes)
        D = latent_dim
        self.joint_embed = nn.Linear(3 * num_joints, D)
        self.joint_conv = nn.Conv1d(D, D, 3, padding=1)
        self.fuse = nn.Linear(3 * D, D)

    def forward(self, points: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
        """points [N, F, M, 3], joints [N, F, J, 3] -> logits [N, M, C]."""
        N, F = joints.shape[:2]
        x = self.marker_features(points)
        j = (joints - joints.mean(dim=(1, 2), keepdim=True)).reshape(N, F, -1)
        j = temporal_conv(self.joint_conv, torch.relu(self.joint_embed(j)))
        j_global = j.amax(dim=1, keepdim=True).expand(x.shape)
        m_global = x.amax(dim=1, keepdim=True).expand(x.shape)
        fused = torch.cat([x, m_global, j_global], dim=-1)
        return self.classify_markers(torch.relu(self.fuse(fused)))

    def forward_sequence(self, points: torch.Tensor, joints: torch.Tensor, freq: float = 30.0,
                         target_freq: float = 30.0) -> torch.Tensor:
        """points [F, M, 3], joints [F, J, 3] -> probabilities [F, M, C]."""
        return windowed_softmax(self, (points, joints), freq, target_freq)
