"""Off-surface point -> displacement to the nearest surface point
(counterpart of ``uuo_mocap_tpu/models/pos_diff.py``): a Fourier encoding
of the point, then an MLP 51 -> 256 -> 256 -> 3."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def octave_frequencies(num_freqs: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """2^k * pi for k < num_freqs, rounded from float64."""
    return torch.as_tensor(2.0 ** np.arange(num_freqs) * np.pi, dtype=dtype, device=device)


def fourier_features(x: torch.Tensor, num_freqs: int,
                     freqs: torch.Tensor | None = None) -> torch.Tensor:
    """[..., D] -> [..., D * (1 + 2 * num_freqs)]: the identity, then sin and
    cos at the octave frequencies 2^k * pi.  The frequencies are rounded to
    float32 from float64 and multiply ``x[..., None]``, as the reference
    computes them: at 2^7 * pi (~402 rad) another order moves ``sin``.
    ``freqs``: those frequencies already on x's device (no host copy, as a
    CUDA graph capture requires)."""
    if num_freqs <= 0:
        return x
    if freqs is None:
        freqs = octave_frequencies(num_freqs, x.dtype, x.device)
    ang = x[..., None] * freqs  # [..., D, K]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.cat([x, enc.reshape(x.shape[:-1] + (-1,))], dim=-1)


class PosDiff(nn.Module):
    def __init__(self, hidden: int = 256, num_freqs: int = 8):
        super().__init__()
        self.num_freqs = num_freqs
        self.register_buffer("freqs", octave_frequencies(num_freqs), persistent=False)
        self.fc0 = nn.Linear(3 * (1 + 2 * num_freqs), hidden)
        self.fc1 = nn.Linear(hidden, hidden)
        self.fc2 = nn.Linear(hidden, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[..., 3] point -> [..., 3] displacement to the surface."""
        h = torch.relu(self.fc0(fourier_features(x, self.num_freqs, self.freqs)))
        h = torch.relu(self.fc1(h))
        return self.fc2(h)
