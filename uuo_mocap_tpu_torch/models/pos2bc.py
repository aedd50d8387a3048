"""Point -> soft assignment over the template's vertices (counterpart of
``uuo_mocap_tpu/models/pos2bc.py``): an MLP 3 -> 128 -> 1024 -> V."""
from __future__ import annotations

import torch
from torch import nn

from uuo_mocap_tpu_torch.body.model import NUM_VERTICES


class Pos2BC(nn.Module):
    def __init__(self, hidden: int = 128, wide: int = 1024, num_vertices: int = NUM_VERTICES):
        super().__init__()
        self.fc0 = nn.Linear(3, hidden)
        self.fc1 = nn.Linear(hidden, wide)
        self.fc2 = nn.Linear(wide, num_vertices)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[..., 3] -> [..., V] logits."""
        return self.fc2(torch.relu(self.fc1(torch.relu(self.fc0(x)))))
