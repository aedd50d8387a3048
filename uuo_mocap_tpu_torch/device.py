"""Device selection and float32 policy for the port.

Entry points default to the card.  The CPU runs only when the caller asks
for it with ``device="cpu"`` (the tests do); with no GPU and no explicit
CPU request, ``resolve_device`` raises instead of falling back silently.
"""
from __future__ import annotations

import torch

# Full-FP32 matmuls and convolutions, explicitly.  TF32 keeps ~10 mantissa
# bits; the TPU reference measured what a one-pass (bf16-class) distance
# cross term does to the nearest-vertex ranking — 34% agreement with the
# FP32 argmin and a failed accuracy gate (uuo_mocap_tpu/pipeline/
# stages.py:111-131).  The LBS blend matmuls stay FP32 for the same reason.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises when a
    CUDA device is requested and none is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "uuo_mocap_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
