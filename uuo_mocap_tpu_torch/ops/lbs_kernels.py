"""The dense SMPL forward's vertices on Hopper: build, ctypes binding, the
model's tables and the wrapper.

The CUDA source is ``csrc/lbs.cu``, compiled for ``sm_90a`` on first use
into ``_build/`` (``chamfer_kernels.compiled``: keyed by the source's
content hash) and loaded with ``ctypes``.  Nothing is compiled when this
module is imported.

The kernel replaces no TPU kernel (the JAX package leaves the dense forward
to XLA): ``body.model.lbs_forward`` takes it for no-grad float32 CUDA calls,
and keeps its plain arithmetic, ``body.model.lbs_forward_plain``, for CPU
tensors and for forwards that need gradients.  It is bound by arithmetic:
9.8 MFLOP a row at V = 6890 (``FLOP_PER_ROW``).
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional, Tuple

import torch

from uuo_mocap_tpu_torch.ops.chamfer_kernels import _PKG_DIR, _check, _raise_on, _stream, compiled

SOURCE = os.path.join(_PKG_DIR, "csrc", "lbs.cu")
# the kernel's basis: rows [0, 207) posedirs, [207, 217) shapedirs, 217
# v_template, zeros to DEPTH; columns 3 V padded to whole tiles of
# VERTEX_TILE vertices (csrc/lbs.cu's kDepth and kVerts)
DEPTH = 224
VERTEX_TILE = 128
NUM_POSE_FEATURES = 207
NUM_BETAS = 10
NUM_JOINTS = 24


class _Library:
    """The compiled kernel, loaded once per process."""

    lib: Optional[ctypes.CDLL] = None
    path: Optional[str] = None
    log: str = ""  # nvcc's output (ptxas -v) of the build of the loaded library


def build() -> ctypes.CDLL:
    """Compile ``csrc/lbs.cu`` if its library is not built yet, load it,
    declare the C signatures and check the tile constants against this
    module's.  Returns the loaded library."""
    if _Library.lib is not None:
        return _Library.lib
    path, _Library.log = compiled(SOURCE, "uuo_lbs")
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.uuo_lbs_vertices.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
    lib.uuo_lbs_basis_ld.argtypes = [i]
    for fn in (lib.uuo_lbs_vertices, lib.uuo_lbs_basis_ld, lib.uuo_lbs_depth):
        fn.restype = ctypes.c_int
    if lib.uuo_lbs_depth() != DEPTH or lib.uuo_lbs_basis_ld(1) != 3 * VERTEX_TILE:
        raise RuntimeError(f"{path}: tile constants differ from ops/lbs_kernels.py's")
    _Library.lib, _Library.path = lib, path
    return lib


def flop_per_row(V: int, width: int) -> int:
    """The arithmetic one row needs: the pose correctives (2 x 207 x 3V),
    the shape term (2 x 10 x 3V), skinning over ``width`` weights a vertex
    (2 x 12 x width x V) and the 3x4 transform (2 x 12 x V FLOP, counting
    its 9 multiplies and 3 adds of T[:, 3] as 12 multiply-adds).  At V = 6890
    and 4 weights: 9.8 MFLOP."""
    return 2 * 3 * V * (NUM_POSE_FEATURES + NUM_BETAS) + 2 * 12 * V * width + 2 * 12 * V


class LbsTables(NamedTuple):
    """A body model's tensors as the kernel reads them (built once per
    model): ``basis`` [DEPTH, 3 V padded] and each vertex's nonzero LBS
    weights, ``joints`` [V, W] int32 and ``weights`` [V, W] float32, W the
    most any vertex has, padded with (joint 0, weight 0)."""

    basis: torch.Tensor
    joints: torch.Tensor
    weights: torch.Tensor


def weight_list(lbs_weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[V, J] LBS weights -> (joints [V, W] int32, weights [V, W]): each
    vertex's nonzero weights in joint order, W the most nonzeros any vertex
    has (at least 1), padded with joint 0 and weight 0.  Only weights that
    are exactly zero are left out."""
    nz = lbs_weights != 0
    W = max(int(nz.sum(-1).max()), 1)
    # nonzero joints first, each group in joint order (a stable sort)
    order = torch.sort((~nz).to(torch.int8), dim=-1, stable=True).indices[:, :W]
    w = torch.gather(lbs_weights, -1, order)
    keep = torch.gather(nz, -1, order)
    return (torch.where(keep, order, 0).to(torch.int32).contiguous(),
            torch.where(keep, w, 0.0).contiguous())


def lbs_tables(v_template: torch.Tensor, shapedirs: torch.Tensor, posedirs: torch.Tensor,
               lbs_weights: torch.Tensor) -> LbsTables:
    """v_template [V, 3], shapedirs [V, 3, 10], posedirs [207, 3V],
    lbs_weights [V, 24] -> the kernel's tables, on their device."""
    V = v_template.shape[0]
    cols = 3 * (-(-V // VERTEX_TILE) * VERTEX_TILE)
    basis = torch.zeros((DEPTH, cols), dtype=torch.float32, device=v_template.device)
    basis[:NUM_POSE_FEATURES, :3 * V] = posedirs
    basis[NUM_POSE_FEATURES:NUM_POSE_FEATURES + NUM_BETAS, :3 * V] = \
        shapedirs.reshape(3 * V, NUM_BETAS).T
    basis[NUM_POSE_FEATURES + NUM_BETAS, :3 * V] = v_template.reshape(3 * V)
    return LbsTables(basis, *weight_list(lbs_weights))


def lbs_vertices_cuda(pose_feature: torch.Tensor, betas: torch.Tensor, aff: torch.Tensor,
                      trans: torch.Tensor, tables: LbsTables) -> torch.Tensor:
    """Kernel ``uuo_lbs_vertices``: pose_feature [N, 207], betas [N, 10],
    aff [N, 24, 12] (each joint's rest-relative 3x4 transform, row-major),
    trans [N, 3], the model's ``tables`` -> vertices [N, V, 3] float32.

    Replaces no TPU kernel (see csrc/lbs.cu): the no-grad dense forward's
    vertices as one kernel instead of the plain chain's GEMMs, broadcasts
    and [N, V, 3, 4] skinning tensor.  Bound by arithmetic, 9.8 MFLOP a row
    (``flop_per_row``).  Counts its ``launches`` and ``rows``."""
    N = pose_feature.shape[0]
    V, W = tables.joints.shape
    _check(pose_feature, "pose_feature", torch.float32, (N, NUM_POSE_FEATURES))
    _check(betas, "betas", torch.float32, (N, NUM_BETAS))
    _check(aff, "aff", torch.float32, (N, NUM_JOINTS, 12))
    _check(trans, "trans", torch.float32, (N, 3))
    _check(tables.basis, "basis", torch.float32, (DEPTH, 3 * (-(-V // VERTEX_TILE) * VERTEX_TILE)))
    _check(tables.joints, "joints", torch.int32, (V, W))
    _check(tables.weights, "weights", torch.float32, (V, W))
    for t, name in ((aff, "aff"), (tables.basis, "basis")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    out = torch.empty((N, V, 3), dtype=torch.float32, device=pose_feature.device)
    lib = build()
    err = lib.uuo_lbs_vertices(pose_feature.data_ptr(), betas.data_ptr(), aff.data_ptr(),
                               trans.data_ptr(), tables.basis.data_ptr(), tables.joints.data_ptr(),
                               tables.weights.data_ptr(), out.data_ptr(), N, V, W,
                               _stream(pose_feature))
    _raise_on(err, "uuo_lbs_vertices")
    lbs_vertices_cuda.launches += 1
    lbs_vertices_cuda.rows += N
    return out


lbs_vertices_cuda.launches = 0
lbs_vertices_cuda.rows = 0
