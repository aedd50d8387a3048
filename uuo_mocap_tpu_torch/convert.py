"""Carry model weights and solver state across from numpy arrays.

``body_model_from_numpy`` takes the arrays of a JAX ``BodyModel`` (or of the
port's own synthetic model) as numpy and builds the port's model on a
device, so both packages can be held to the same tensors.

The ``*_from_flax`` functions take a flax variables tree of numpy arrays
({"params": {...}}, as ``models.checkpoints.load_params`` returns it or a
flax ``init`` makes it) and build the port's module on a device, for
inference (eval mode, no parameter gradients).  flax names a module's
layers by type in the order they are created, not called: in each
attention block the outer Dense of ``Dense(D)(relu(Dense(2D)(x)))`` is
created first, so ``Dense_{k}`` is the 2D -> D layer applied second and
``Dense_{k+1}`` the D -> 2D layer applied first.  flax ``Dense.kernel`` is
[in, out] (torch: [out, in]); ``Conv.kernel`` is [k, in, out] (torch:
[out, in, k]); attention's query / key / value kernels are [D, H, Dh] with
biases [H, Dh], its output kernel [H, Dh, D].
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

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


def _copy(param: torch.Tensor, value: np.ndarray) -> None:
    value = torch.as_tensor(np.array(value, np.float32))
    if value.shape != param.shape:
        raise ValueError(
            f"checkpoint shape {tuple(value.shape)} != the module's {tuple(param.shape)}")
    param.data.copy_(value)


def _dense(layer: nn.Linear, p: Mapping[str, Any]) -> None:
    """flax Dense / DenseGeneral (kernel [in..., out...]) -> torch Linear."""
    kernel = np.asarray(p["kernel"])
    _copy(layer.weight, kernel.reshape(layer.in_features, layer.out_features).T)
    _copy(layer.bias, np.asarray(p["bias"]).reshape(-1))


def _conv(layer: nn.Conv1d, p: Mapping[str, Any]) -> None:
    _copy(layer.weight, np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    _copy(layer.bias, p["bias"])


def _layer_norm(layer: nn.LayerNorm, p: Mapping[str, Any]) -> None:
    _copy(layer.weight, p["scale"])
    _copy(layer.bias, p["bias"])


def _inference(module: nn.Module, device) -> nn.Module:
    return module.to(resolve_device(device)).eval().requires_grad_(False)


def _params(variables: Mapping[str, Any]) -> Mapping[str, Any]:
    if "params" not in variables:
        raise ValueError(
            f"expected a flax variables tree with 'params', got keys {list(variables)}")
    return variables["params"]


def _segmenter_from_flax(module, p: Mapping[str, Any], fuse_index: int) -> None:
    """The layers both segmenters share; ``fuse_index`` is the fusion
    Dense's index (1 in the marker-only net, 2 in the multimodal one, whose
    Dense_1 embeds the joints)."""
    _dense(module.embed, p["Dense_0"])
    for i, conv in enumerate(module.convs):
        _conv(conv, p[f"Conv_{i}"])
    _dense(module.fuse, p[f"Dense_{fuse_index}"])
    for b, block in enumerate(module.blocks):
        att = p[f"SelfAttention_{b}"]
        for name in ("query", "key", "value", "out"):
            _dense(getattr(block.attn, name), att[name])
        _layer_norm(block.norm0, p[f"LayerNorm_{2 * b}"])
        _dense(block.ff_out, p[f"Dense_{fuse_index + 1 + 2 * b}"])  # created first
        _dense(block.ff_in, p[f"Dense_{fuse_index + 2 + 2 * b}"])
        _layer_norm(block.norm1, p[f"LayerNorm_{2 * b + 1}"])
    _dense(module.head, p[f"Dense_{fuse_index + 5}"])
    _dense(module.classify, p[f"Dense_{fuse_index + 6}"])


def marker_segmenter_from_flax(variables: Mapping[str, Any], device=None):
    """A ``MarkerSegmenter`` from its flax variables (width and classes read
    from the kernels)."""
    from uuo_mocap_tpu_torch.models.marker_segmenter import MarkerSegmenter

    p = _params(variables)
    D = int(np.shape(p["Dense_0"]["kernel"])[1])
    module = MarkerSegmenter(D, int(np.shape(p["Dense_7"]["kernel"])[1]))
    _segmenter_from_flax(module, p, fuse_index=1)
    return _inference(module, device)


def marker_segmenter_multimodal_from_flax(variables: Mapping[str, Any], device=None):
    """A ``MarkerSegmenterMultimodal`` from its flax variables; Dense_1
    (3 J -> D) and Conv_3 are the joint branch."""
    from uuo_mocap_tpu_torch.models.marker_segmenter_multimodal import MarkerSegmenterMultimodal

    p = _params(variables)
    D = int(np.shape(p["Dense_0"]["kernel"])[1])
    joints_in = int(np.shape(p["Dense_1"]["kernel"])[0])
    module = MarkerSegmenterMultimodal(D, int(np.shape(p["Dense_8"]["kernel"])[1]),
                                       num_joints=joints_in // 3)
    _segmenter_from_flax(module, p, fuse_index=2)
    _dense(module.joint_embed, p["Dense_1"])
    _conv(module.joint_conv, p["Conv_3"])
    return _inference(module, device)


def pos2bc_from_flax(variables: Mapping[str, Any], device=None):
    from uuo_mocap_tpu_torch.models.pos2bc import Pos2BC

    p = _params(variables)
    shapes = [np.shape(p[f"Dense_{i}"]["kernel"]) for i in range(3)]
    module = Pos2BC(hidden=int(shapes[0][1]), wide=int(shapes[1][1]),
                    num_vertices=int(shapes[2][1]))
    for i in range(3):
        _dense(getattr(module, f"fc{i}"), p[f"Dense_{i}"])
    return _inference(module, device)


def pos_diff_from_flax(variables: Mapping[str, Any], device=None):
    from uuo_mocap_tpu_torch.models.pos_diff import PosDiff

    p = _params(variables)
    d_in, hidden = np.shape(p["Dense_0"]["kernel"])
    module = PosDiff(hidden=int(hidden), num_freqs=(int(d_in) // 3 - 1) // 2)
    for i in range(3):
        _dense(getattr(module, f"fc{i}"), p[f"Dense_{i}"])
    return _inference(module, device)
