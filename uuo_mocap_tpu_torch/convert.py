"""Carry model weights and solver state across from numpy arrays.

``body_model_from_numpy`` takes the arrays of a JAX ``BodyModel`` (or of the
port's own synthetic model) as numpy and builds the port's model on a
device, so both packages can be held to the same tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import PARENTS, BodyModel
from uuo_mocap_tpu_torch.device import resolve_device
from uuo_mocap_tpu_torch.pipeline.stages import SmplParams

BODY_MODEL_ARRAYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights")


def body_model_from_numpy(arrays: Mapping[str, Any], device=None,
                          gender: str = "neutral") -> BodyModel:
    """``arrays``: v_template [V, 3], shapedirs [V, 3, 10], posedirs
    [207, V*3], j_regressor [24, V], lbs_weights [V, 24], faces [T, 3] and
    optionally parents [24] -> the port's ``BodyModel`` on ``device``."""
    dev = resolve_device(device)
    tensors = {k: torch.as_tensor(np.array(arrays[k], np.float32), device=dev)
               for k in BODY_MODEL_ARRAYS}
    parents = arrays.get("parents")
    return BodyModel(**tensors, faces=np.asarray(arrays["faces"], np.int32),
                     parents=PARENTS if parents is None else np.asarray(parents, np.int32),
                     gender=gender)


def body_model_arrays(model: Any) -> Dict[str, np.ndarray]:
    """The numpy arrays ``body_model_from_numpy`` takes, read from any object
    with the model's attributes (a JAX ``BodyModel`` or the port's)."""
    out = {}
    for k in BODY_MODEL_ARRAYS:
        v = getattr(model, k)
        out[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    out["faces"] = np.asarray(model.faces)
    out["parents"] = np.asarray(model.parents)
    return out


def smpl_params_from_numpy(params: Any, device=None) -> SmplParams:
    """(pose_body, betas, root_orient, trans) as numpy (any object with
    those fields) -> the port's ``SmplParams`` of float32 tensors."""
    dev = resolve_device(device)
    return SmplParams(*(torch.as_tensor(np.array(getattr(params, k), np.float32), device=dev)
                        for k in SmplParams._fields))
