"""Device placement helpers (counterpart of ``uuo_mocap_tpu/utils/tensor.py``)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from uuo_mocap_tpu_torch.device import resolve_device


def _to(x: Any, device: torch.device) -> Any:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def dict2device(tree: Dict[str, Any], device: Optional[Any] = None) -> Dict[str, Any]:
    """Move every tensor or numpy-array leaf of a dict (nested dicts, lists
    and tuples included) onto ``device`` (default: the card, through
    ``resolve_device``, which raises without one); other leaves stay."""
    return _to(tree, resolve_device(device))
