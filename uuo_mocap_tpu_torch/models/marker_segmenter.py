"""Per-marker body-part classifier (counterpart of
``uuo_mocap_tpu/models/marker_segmenter.py``).

Each marker's window of positions is featurized, embedded, convolved over
time and pooled; two rounds of marker self-attention over the cloud follow,
then a per-marker classifier over the 24 SMPL parts.  The layers keep
flax's conventions, so the shipped checkpoints carry over
(``convert.py``): LayerNorm eps 1e-6, convolutions padded SAME (1 on each
side for k = 3), max pooling VALID, attention written out as
softmax((q / sqrt(d)) k^T) v.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

NUM_PARTS = 24
WINDOW = 32
STRIDE = 4
POOLS = (4, 4, 2)
LAYER_NORM_EPS = 1e-6  # flax's default


def marker_window_features(points: torch.Tensor) -> torch.Tensor:
    """[N, F, M, 3] -> [N, F, M, 7]: the position centred on the window's
    cloud mean (3), the forward-difference velocity (3, zero in the last
    frame) and the height (y) above the window's lowest marker (1)."""
    center = points.mean(dim=(1, 2), keepdim=True)
    vel = torch.diff(points, dim=1, append=points[:, -1:])
    height = points[..., 1:2] - points[..., 1:2].amin(dim=(1, 2), keepdim=True)
    return torch.cat([points - center, vel, height], dim=-1)


class SelfAttention(nn.Module):
    """flax ``nn.SelfAttention``: per-head query, key and value projections,
    softmax((q / sqrt(d)) k^T) v, and an output projection."""

    def __init__(self, dim: int, num_heads: int = 4, qkv_features: int | None = None):
        super().__init__()
        qkv = qkv_features or dim
        self.num_heads, self.head_dim = num_heads, qkv // num_heads
        self.query = nn.Linear(dim, qkv)
        self.key = nn.Linear(dim, qkv)
        self.value = nn.Linear(dim, qkv)
        self.out = nn.Linear(qkv, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, T, D]
        heads = x.shape[:-1] + (self.num_heads, self.head_dim)
        q = self.query(x).reshape(heads) / math.sqrt(self.head_dim)
        k, v = self.key(x).reshape(heads), self.value(x).reshape(heads)
        w = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k), dim=-1)
        o = torch.einsum("nhqk,nkhd->nqhd", w, v)
        return self.out(o.reshape(x.shape[:-1] + (-1,)))


class AttentionBlock(nn.Module):
    """x = LN(x + attention(x)); x = LN(x + ff_out(relu(ff_in(x))))."""

    def __init__(self, dim: int):
        super().__init__()
        self.attn = SelfAttention(dim, num_heads=4, qkv_features=dim)
        self.norm0 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.ff_in = nn.Linear(dim, 2 * dim)
        self.ff_out = nn.Linear(2 * dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm0(x + self.attn(x))
        return self.norm1(x + self.ff_out(torch.relu(self.ff_in(x))))


def temporal_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """relu(conv) over the frame axis of feature-last x [B, F, D] (odd k,
    padded SAME).  While the weights take gradients it runs as one GEMM of
    the k shifted copies of x: on an H100 cuDNN's FP32 weight gradient at
    a segmenter's training shapes (an FFT algorithm) took 14 ms of a 16.5
    ms step, where the whole step takes 2.2 ms in the GEMM form (PERF.md,
    PR 9).  Inference keeps cuDNN's convolution."""
    if not (torch.is_grad_enabled() and conv.weight.requires_grad):
        return torch.relu(conv(x.transpose(1, 2))).transpose(1, 2)
    k, F = conv.kernel_size[0], x.shape[1]
    xp = nn.functional.pad(x, (0, 0, k // 2, k // 2))
    cols = torch.cat([xp[:, j:j + F] for j in range(k)], dim=-1)  # [B, F, k D]
    w = conv.weight.permute(0, 2, 1).reshape(conv.out_channels, -1)  # [out, k in]
    return torch.relu(nn.functional.linear(cols, w, conv.bias))


def windowed_softmax(net: nn.Module, streams: Sequence[torch.Tensor], freq: float,
                     target_freq: float) -> torch.Tensor:
    """Full-sequence inference (``marker_segmenter.py:81-103``): windows of
    WINDOW frames sampled every STRIDE x max(int(freq // target_freq), 1)
    frames, one window per span of WINDOW such strides, a short last window
    padded by repeating its last frame; each window's softmax is written
    over every frame of its span.  streams: [F, ...] each (markers, and the
    joints for the multimodal net) -> [F, M, C] probabilities.  The windows
    run as one batch."""
    F = streams[0].shape[0]
    full_stride = STRIDE * max(int(freq // target_freq), 1)
    span = full_stride * WINDOW

    def window(x, start):
        w = x[start:start + span:full_stride]
        if w.shape[0] < WINDOW:
            w = torch.cat([w, w[-1:].expand((WINDOW - w.shape[0],) + w.shape[1:])])
        return w

    batch = [torch.stack([window(x, s) for s in range(0, F, span)]) for x in streams]
    probs = torch.softmax(net(*batch), dim=-1)  # [windows, M, C]
    return probs[torch.arange(F, device=probs.device) // span]


class MarkerSegmenter(nn.Module):
    def __init__(self, latent_dim: int = 128, num_classes: int = NUM_PARTS):
        super().__init__()
        D = latent_dim
        self.embed = nn.Linear(7, D)
        self.convs = nn.ModuleList(nn.Conv1d(D, D, 3, padding=1) for _ in POOLS)
        self.fuse = nn.Linear(2 * D, D)
        self.blocks = nn.ModuleList(AttentionBlock(D) for _ in range(2))
        self.head = nn.Linear(D, 2 * D)
        self.classify = nn.Linear(2 * D, num_classes)

    def marker_features(self, points: torch.Tensor) -> torch.Tensor:
        """points [N, F, M, 3] -> per-marker features [N, M, D]: embedding,
        the temporal tower (conv, relu, max pool) and the mean over time."""
        N, F, M, _ = points.shape
        x = torch.relu(self.embed(marker_window_features(points)))
        x = x.transpose(1, 2).reshape(N * M, F, -1)
        for conv, pool in zip(self.convs, POOLS):
            x = temporal_conv(conv, x)
            x = nn.functional.max_pool1d(x.transpose(1, 2), pool).transpose(1, 2)
        return x.mean(dim=1).reshape(N, M, -1)

    def classify_markers(self, x: torch.Tensor) -> torch.Tensor:
        """Fused features [N, M, D] -> logits [N, M, C]."""
        for block in self.blocks:
            x = block(x)
        return self.classify(torch.relu(self.head(x)))

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        """points [N, F, M, 3] -> logits [N, M, num_classes]."""
        x = self.marker_features(points)
        g = x.amax(dim=1, keepdim=True).expand(x.shape)
        return self.classify_markers(torch.relu(self.fuse(torch.cat([x, g], dim=-1))))

    def forward_sequence(self, points: torch.Tensor, freq: float = 30.0,
                         target_freq: float = 30.0) -> torch.Tensor:
        """points [F, M, 3] -> per-frame class probabilities [F, M, C]."""
        return windowed_softmax(self, (points,), freq, target_freq)
