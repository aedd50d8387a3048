"""Learned foot-contact detector over joint streams (counterpart of
``uuo_mocap_tpu/models/foot_contact_model.py``): three temporal
convolutions (k = 5, padded SAME) over the centred joint stream, then a
per-frame Dense to left / right contact logits."""
from __future__ import annotations

import torch
from torch import nn

from uuo_mocap_tpu_torch.models.marker_segmenter import temporal_conv


class FootContactModel(nn.Module):
    def __init__(self, latent_dim: int = 64, num_joints: int = 22):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(3 * num_joints if i == 0 else latent_dim, latent_dim, 5, padding=2)
            for i in range(3))
        self.head = nn.Linear(latent_dim, 2)

    def forward(self, joints: torch.Tensor) -> torch.Tensor:
        """joints [N, F, J, 3] -> logits [N, F, 2]."""
        N, F = joints.shape[:2]
        x = (joints - joints.mean(dim=(1, 2), keepdim=True)).reshape(N, F, -1)
        for conv in self.convs:
            x = temporal_conv(conv, x)
        return self.head(x)
