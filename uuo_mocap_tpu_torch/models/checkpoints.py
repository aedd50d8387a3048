"""Model checkpoints (counterpart of ``uuo_mocap_tpu/models/checkpoints.py``).

Checkpoints are the flax msgpack files ``<root>/<name>/final/model.msgpack``
that both packages' training loops write; the port reads and writes them
with its own codec (``models/msgpack_io.py``) and converts between its
modules and the params tree with ``convert.py``.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from uuo_mocap_tpu_torch.models.msgpack_io import packb, unpackb


def checkpoint_path(root: str, name: str) -> str:
    return os.path.join(root, name, "final", "model.msgpack")


def save_params(variables: Dict[str, Any], root: str, name: str) -> str:
    """Write a variables tree (nested dicts of numpy arrays, e.g.
    ``convert.to_flax(module)``) to ``<root>/<name>/final/model.msgpack``,
    each leaf in the dtype it is given; returns the path."""
    path = checkpoint_path(root, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(variables))
    return path


def _as_float32(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _as_float32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def load_params(root: str, name: str) -> Dict[str, Any]:
    """The checkpoint's variables tree ({"params": {...}}) as nested dicts of
    float32 numpy arrays: leaves stored downcast (the Pos2BC checkpoint is
    float16) are cast back, as the reference casts them to its float32
    template.  A missing file raises ``FileNotFoundError``."""
    with open(checkpoint_path(root, name), "rb") as f:
        return _as_float32(unpackb(f.read()))
