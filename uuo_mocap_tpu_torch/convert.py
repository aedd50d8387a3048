"""Carry model weights and solver state across from numpy arrays.

``body_model_from_numpy`` takes the arrays of a JAX ``BodyModel`` (or of the
port's own synthetic model) as numpy and builds the port's model on a
device, so both packages can be held to the same tensors.

The ``*_from_flax`` functions take a flax variables tree of numpy arrays
({"params": {...}}, as ``models.checkpoints.load_params`` returns it or a
flax ``init`` makes it) and build the port's module on a device, for
inference (eval mode, no parameter gradients) or, with ``trainable=True``,
for training.  ``to_flax`` goes back: any of these modules -> its flax
variables tree, which the JAX package's ``load_params`` restores.  Both
directions read one layout per module: its flax names beside its layers.
flax names a module's layers by type in the order they are created, not
called: in ``Dense(D)(relu(Dense(2D)(x)))`` the outer Dense is created
first, so ``Dense_{k}`` is the 2D -> D layer applied second and
``Dense_{k+1}`` the D -> 2D layer applied first.  flax ``Dense.kernel`` is
[in, out] (torch: [out, in]); ``Conv.kernel`` is [k, in, out] (torch:
[out, in, k]); attention's query / key / value kernels are [D, H, Dh] with
biases [H, Dh], its output kernel [H, Dh, D].
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from uuo_mocap_tpu_torch.body.model import PARENTS, BodyModel
from uuo_mocap_tpu_torch.device import resolve_device
from uuo_mocap_tpu_torch.models.marker_segmenter import AttentionBlock, SelfAttention
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


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _dense_from(layer: nn.Linear, p: Mapping[str, Any]) -> None:
    """flax Dense / DenseGeneral (kernel [in..., out...]) -> torch Linear."""
    kernel = np.asarray(p["kernel"])
    _copy(layer.weight, kernel.reshape(layer.in_features, layer.out_features).T)
    _copy(layer.bias, np.asarray(p["bias"]).reshape(-1))


def _dense_to(layer: nn.Linear, kernel_shape=None, bias_shape=None) -> Dict[str, np.ndarray]:
    kernel = _numpy(layer.weight).T
    bias = _numpy(layer.bias)
    return {"kernel": kernel.reshape(kernel_shape or kernel.shape),
            "bias": bias.reshape(bias_shape or bias.shape)}


def _attention_to(attn: SelfAttention) -> Dict[str, Any]:
    heads = (attn.num_heads, attn.head_dim)
    out = {name: _dense_to(getattr(attn, name), (getattr(attn, name).in_features,) + heads, heads)
           for name in ("query", "key", "value")}
    out["out"] = _dense_to(attn.out, heads + (attn.out.out_features,))
    return out


def _attention_from(attn: SelfAttention, p: Mapping[str, Any]) -> None:
    heads = np.shape(p["query"]["kernel"])[1]
    if heads != attn.num_heads:
        raise ValueError(f"checkpoint attention has {heads} heads, the module {attn.num_heads}")
    for name in ("query", "key", "value", "out"):
        _dense_from(getattr(attn, name), p[name])


def _layer_from(layer: nn.Module, p: Mapping[str, Any]) -> None:
    if isinstance(layer, nn.Linear):
        _dense_from(layer, p)
    elif isinstance(layer, nn.Conv1d):
        _copy(layer.weight, np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
        _copy(layer.bias, p["bias"])
    elif isinstance(layer, nn.LayerNorm):
        _copy(layer.weight, p["scale"])
        _copy(layer.bias, p["bias"])
    else:
        _attention_from(layer, p)


def _layer_to(layer: nn.Module) -> Dict[str, Any]:
    if isinstance(layer, nn.Linear):
        return _dense_to(layer)
    if isinstance(layer, nn.Conv1d):
        return {"kernel": np.ascontiguousarray(np.transpose(_numpy(layer.weight), (2, 1, 0))),
                "bias": _numpy(layer.bias)}
    if isinstance(layer, nn.LayerNorm):
        return {"scale": _numpy(layer.weight), "bias": _numpy(layer.bias)}
    return _attention_to(layer)


Layout = List[Tuple[str, nn.Module]]


def _block_layout(block: AttentionBlock, b: int, first_dense: int) -> Layout:
    """An attention block's layers, the b-th block of its module, whose
    first Dense is ``Dense_{first_dense}`` (created before its input layer)."""
    return [(f"SelfAttention_{b}", block.attn), (f"LayerNorm_{2 * b}", block.norm0),
            (f"Dense_{first_dense + 2 * b}", block.ff_out),
            (f"Dense_{first_dense + 1 + 2 * b}", block.ff_in),
            (f"LayerNorm_{2 * b + 1}", block.norm1)]


def _segmenter_layout(module) -> Layout:
    """Both segmenters: the multimodal net's Dense_1 (3 J -> D) and Conv_3
    are its joint branch, so its fusion Dense is Dense_2, not Dense_1."""
    from uuo_mocap_tpu_torch.models.marker_segmenter_multimodal import MarkerSegmenterMultimodal

    layout = [("Dense_0", module.embed)] + [(f"Conv_{i}", c) for i, c in enumerate(module.convs)]
    fuse = 1
    if isinstance(module, MarkerSegmenterMultimodal):
        layout += [("Dense_1", module.joint_embed), ("Conv_3", module.joint_conv)]
        fuse = 2
    layout.append((f"Dense_{fuse}", module.fuse))
    for b, block in enumerate(module.blocks):
        layout += _block_layout(block, b, fuse + 1)
    return layout + [(f"Dense_{fuse + 5}", module.head), (f"Dense_{fuse + 6}", module.classify)]


def _layout(module: nn.Module) -> Layout:
    from uuo_mocap_tpu_torch.models.foot_contact_model import FootContactModel
    from uuo_mocap_tpu_torch.models.marker_segmenter import MarkerSegmenter
    from uuo_mocap_tpu_torch.models.marker_tracking import (
        MarkerTrackingAttention, PermutationLearningModel)
    from uuo_mocap_tpu_torch.models.motion_embedding import _WindowEncoder
    from uuo_mocap_tpu_torch.models.pos2bc import Pos2BC
    from uuo_mocap_tpu_torch.models.pos_diff import PosDiff

    if isinstance(module, MarkerSegmenter):
        return _segmenter_layout(module)
    if isinstance(module, (Pos2BC, PosDiff)):
        return [(f"Dense_{i}", getattr(module, f"fc{i}")) for i in range(3)]
    if isinstance(module, FootContactModel):
        return [(f"Conv_{i}", c) for i, c in enumerate(module.convs)] + [("Dense_0", module.head)]
    if isinstance(module, _WindowEncoder):  # out = Dense(32)(relu(Dense(D)(h))): out first
        return [("Dense_0", module.point_in), ("Dense_1", module.point_out),
                ("Conv_0", module.convs[0]), ("Conv_1", module.convs[1]),
                ("Dense_2", module.out), ("Dense_3", module.head)]
    if isinstance(module, PermutationLearningModel):
        return [("Dense_0", module.embed), ("Dense_1", module.residual),
                ("Dense_2", module.scores)]
    if isinstance(module, MarkerTrackingAttention):
        layout = [("Dense_0", module.embed)]
        for b, block in enumerate(module.blocks):
            layout += _block_layout(block, b, 1)
        return layout + [(f"Dense_{1 + 2 * len(module.blocks)}", module.classify)]
    raise TypeError(f"no flax layout for {type(module).__name__}")


def to_flax(module: nn.Module) -> Dict[str, Any]:
    """Any module these builders make -> its flax variables tree
    ({"params": {...}} of float32 numpy arrays, flax's names and shapes)."""
    return {"params": {name: _layer_to(layer) for name, layer in _layout(module)}}


def _params(variables: Mapping[str, Any]) -> Mapping[str, Any]:
    if "params" not in variables:
        raise ValueError(
            f"expected a flax variables tree with 'params', got keys {list(variables)}")
    return variables["params"]


def from_flax(module: nn.Module, variables: Mapping[str, Any], device=None,
              trainable: bool = False) -> nn.Module:
    """``module`` (already built at the tree's widths) with the variables
    tree's weights, on ``device``; frozen in eval mode unless ``trainable``."""
    p = _params(variables)
    layout = _layout(module)
    missing = sorted({name for name, _ in layout} - set(p))
    if missing:
        raise ValueError(f"flax params lack {missing} for {type(module).__name__}")
    for name, layer in layout:
        _layer_from(layer, p[name])
    module = module.to(resolve_device(device))
    return module.train().requires_grad_(True) if trainable else module.eval().requires_grad_(False)


def _shape(p: Mapping[str, Any], name: str) -> Tuple[int, ...]:
    return tuple(int(d) for d in np.shape(p[name]["kernel"]))


def marker_segmenter_from_flax(variables: Mapping[str, Any], device=None, trainable: bool = False):
    """A ``MarkerSegmenter`` from its flax variables (width and classes read
    from the kernels)."""
    from uuo_mocap_tpu_torch.models.marker_segmenter import MarkerSegmenter

    p = _params(variables)
    module = MarkerSegmenter(_shape(p, "Dense_0")[1], _shape(p, "Dense_7")[1])
    return from_flax(module, variables, device, trainable)


def marker_segmenter_multimodal_from_flax(variables: Mapping[str, Any], device=None,
                                          trainable: bool = False):
    from uuo_mocap_tpu_torch.models.marker_segmenter_multimodal import MarkerSegmenterMultimodal

    p = _params(variables)
    module = MarkerSegmenterMultimodal(_shape(p, "Dense_0")[1], _shape(p, "Dense_8")[1],
                                       num_joints=_shape(p, "Dense_1")[0] // 3)
    return from_flax(module, variables, device, trainable)


def pos2bc_from_flax(variables: Mapping[str, Any], device=None, trainable: bool = False):
    from uuo_mocap_tpu_torch.models.pos2bc import Pos2BC

    p = _params(variables)
    shapes = [_shape(p, f"Dense_{i}") for i in range(3)]
    module = Pos2BC(hidden=shapes[0][1], wide=shapes[1][1], num_vertices=shapes[2][1])
    return from_flax(module, variables, device, trainable)


def pos_diff_from_flax(variables: Mapping[str, Any], device=None, trainable: bool = False):
    from uuo_mocap_tpu_torch.models.pos_diff import PosDiff

    d_in, hidden = _shape(_params(variables), "Dense_0")
    module = PosDiff(hidden=hidden, num_freqs=(d_in // 3 - 1) // 2)
    return from_flax(module, variables, device, trainable)


def foot_contact_from_flax(variables: Mapping[str, Any], device=None, trainable: bool = False):
    from uuo_mocap_tpu_torch.models.foot_contact_model import FootContactModel

    _, d_in, latent = _shape(_params(variables), "Conv_0")
    return from_flax(FootContactModel(latent, d_in // 3), variables, device, trainable)


def motion_embedding_from_flax(variables: Mapping[str, Any], device=None,
                               trainable: bool = False, joints: bool = False):
    """A ``MarkerEmbedding`` (or, with ``joints``, a ``JointEmbedding``)."""
    from uuo_mocap_tpu_torch.models.motion_embedding import JointEmbedding, MarkerEmbedding

    p = _params(variables)
    cls = JointEmbedding if joints else MarkerEmbedding
    module = cls(_shape(p, "Dense_0")[1], _shape(p, "Dense_2")[1])
    return from_flax(module, variables, device, trainable)


def permutation_model_from_flax(variables: Mapping[str, Any], device=None,
                                trainable: bool = False):
    from uuo_mocap_tpu_torch.models.marker_tracking import PermutationLearningModel

    d_in, latent = _shape(_params(variables), "Dense_0")
    return from_flax(PermutationLearningModel(d_in // 3, latent), variables, device, trainable)


def marker_tracking_attention_from_flax(variables: Mapping[str, Any], device=None,
                                        trainable: bool = False):
    from uuo_mocap_tpu_torch.models.marker_tracking import MarkerTrackingAttention

    p = _params(variables)
    layers = sum(1 for k in p if k.startswith("SelfAttention_"))
    module = MarkerTrackingAttention(_shape(p, "Dense_0")[1], layers,
                                     _shape(p, f"Dense_{1 + 2 * layers}")[1])
    return from_flax(module, variables, device, trainable)
