"""Hopper nearest-vertex kernels: build, ctypes binding, wrappers, and the
plain PyTorch version of each.

The CUDA sources live in ``csrc/chamfer.cu`` and are compiled with ``nvcc``
for ``sm_90a`` on first use into ``_build/`` (keyed by the source's content
hash), then loaded with ``ctypes``.  Nothing is compiled when this module is
imported.

Each kernel has
  * a wrapper (``*_cuda``) that checks device, dtype, shape and contiguity,
    allocates the outputs, launches on ``torch.cuda.current_stream()``,
    raises when the launch is refused, and counts its launches in a plain
    int attribute ``launches``;
  * a plain PyTorch version (``*_plain``) with the reference's arithmetic,
    used for CPU tensors and by ``chip_smoke.py``'s comparison (the kernels
    leave each query's constant |x|^2 out of the scan and add it to the
    winner, so their picks differ only on near-ties);
  * a dispatcher that picks by the tensor's device: CPU tensors go to the
    plain version, CUDA tensors to the kernel (never a silent fallback).

Counterparts (``uuo_mocap_tpu/ops/chamfer_pallas.py``):
  rank_nearest        <- ``_rank_kernel`` / ``ranked_nearest_pallas``
  min_sqdist_forward  <- ``_kernel`` / ``min_sqdist_pallas``
  min_sqdist_backward <- ``_bwd_kernel`` / ``make_min_grad_y``
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "chamfer.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# elements of one plain-version distance block: bounds the [.., M, V]
# tensor the plain versions materialize (256 MB of float32)
_PLAIN_BLOCK = 1 << 26


class _Library:
    """The compiled kernels, loaded once per process."""

    lib: Optional[ctypes.CDLL] = None
    path: Optional[str] = None
    log: str = ""  # nvcc's output of the build this process ran (ptxas -v)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build() -> ctypes.CDLL:
    """Compile ``csrc/chamfer.cu`` if its library is not built yet, load it,
    and declare the C signatures.  Returns the loaded library."""
    if _Library.lib is not None:
        return _Library.lib
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libuuo_chamfer_{digest}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
        _Library.log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.uuo_rank_nearest.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.uuo_min_sqdist_fwd.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.uuo_min_sqdist_bwd.argtypes = [p, p, p, p, p, i, i, i, p]
    for fn in (lib.uuo_rank_nearest, lib.uuo_min_sqdist_fwd, lib.uuo_min_sqdist_bwd):
        fn.restype = ctypes.c_int
    _Library.lib, _Library.path = lib, path
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------- rank kernel

def rank_nearest_cuda(markers: torch.Tensor, verts: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel ``uuo_rank_nearest``: markers [L, F, M, 3], verts [L, F, V, 3],
    bias [L, V] or None -> idx [L, F, M] int32.

    Replaces ``_rank_kernel`` (uuo_mocap_tpu/ops/chamfer_pallas.py:195-284).
    One block per (lane, frame); bound on the H100 by FP32 issue rate at the
    main path's shapes (see csrc/chamfer.cu)."""
    L, F, M, _ = markers.shape
    V = verts.shape[2]
    _check(markers, "markers", torch.float32, (L, F, M, 3))
    _check(verts, "verts", torch.float32, (L, F, V, 3))
    if bias is not None:
        _check(bias, "bias", torch.float32, (L, V))
    idx = torch.empty((L, F, M), dtype=torch.int32, device=markers.device)
    lib = build()
    err = lib.uuo_rank_nearest(markers.data_ptr(), verts.data_ptr(),
                               None if bias is None else bias.data_ptr(), idx.data_ptr(),
                               L * F, F, M, V, _stream(markers))
    _raise_on(err, "uuo_rank_nearest")
    rank_nearest_cuda.launches += 1
    return idx


rank_nearest_cuda.launches = 0


def _frame_chunk(F: int, per_frame: int) -> int:
    return max(1, min(F, _PLAIN_BLOCK // max(per_frame, 1)))


def rank_nearest_plain(markers: torch.Tensor, verts: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rank kernel's function in PyTorch: centered on each frame's
    vertex centroid, d2 = (|x|^2 + (|y|^2 + bias)) - 2 x.y, lowest index on
    ties.  [L, F, M, 3], [L, F, V, 3], [L, V] | None -> [L, F, M] int64."""
    L, F, M, _ = markers.shape
    V = verts.shape[2]
    C = _frame_chunk(F, L * M * V)
    out = []
    for f0 in range(0, F, C):
        x, y = markers[:, f0:f0 + C], verts[:, f0:f0 + C]
        c = y.mean(dim=-2, keepdim=True)
        x, y = x - c, y - c
        x2 = (x * x).sum(-1)[..., :, None]
        w = (y * y).sum(-1)
        if bias is not None:
            w = w + bias[:, None, :]
        d = (x2 + w[..., None, :]) - 2.0 * (x @ y.transpose(-1, -2))
        out.append(d.argmin(dim=-1))
    return torch.cat(out, dim=1)


def rank_nearest(markers: torch.Tensor, verts: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nearest vertex per (lane, frame, marker), no gradient: the kernel on
    CUDA tensors, the plain version on CPU tensors.  -> [L, F, M] int64."""
    if markers.device.type == "cuda":
        return rank_nearest_cuda(markers.contiguous(), verts.contiguous(),
                                 None if bias is None else bias.contiguous()).long()
    return rank_nearest_plain(markers, verts, bias)


# ------------------------------------------------------ min_sqdist forward

def min_sqdist_forward_cuda(x: torch.Tensor, y: torch.Tensor,
                            bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``uuo_min_sqdist_fwd``: x [B, M, 3], y [B, V, 3], bias [B, V]
    -> (min d2 + bias clamped >= 0 [B, M] float32, argmin [B, M] int32).

    Replaces ``_kernel`` (uuo_mocap_tpu/ops/chamfer_pallas.py:33-122)
    without its M <= 64 limit: few queries split the targets across a block,
    many queries (the 6890-vertices-against-41-markers reverse direction)
    get a thread each.  FP32-rate bound at the main path's shapes."""
    B, M, _ = x.shape
    V = y.shape[1]
    _check(x, "x", torch.float32, (B, M, 3))
    _check(y, "y", torch.float32, (B, V, 3))
    _check(bias, "bias", torch.float32, (B, V))
    val = torch.empty((B, M), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, M), dtype=torch.int32, device=x.device)
    lib = build()
    err = lib.uuo_min_sqdist_fwd(x.data_ptr(), y.data_ptr(), bias.data_ptr(), val.data_ptr(),
                                 idx.data_ptr(), B, M, V, _stream(x))
    _raise_on(err, "uuo_min_sqdist_fwd")
    min_sqdist_forward_cuda.launches += 1
    return val, idx


min_sqdist_forward_cuda.launches = 0


def min_sqdist_forward_plain(x: torch.Tensor, y: torch.Tensor,
                             bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in PyTorch (``min_sqdist_pallas``'s):
    centered on the y centroid, min and argmin of (|x|^2 + (|y|^2 + bias))
    - 2 x.y, the value clamped >= 0.  -> ([B, M], [B, M] int64)."""
    B, M, _ = x.shape
    V = y.shape[1]
    C = _frame_chunk(B, M * V)
    vals, idxs = [], []
    for b0 in range(0, B, C):
        xc, yc = x[b0:b0 + C], y[b0:b0 + C]
        c = yc.mean(dim=-2, keepdim=True)
        xc, yc = xc - c, yc - c
        x2 = (xc * xc).sum(-1)[..., :, None]
        w = (yc * yc).sum(-1) + bias[b0:b0 + C]
        d = (x2 + w[..., None, :]) - 2.0 * (xc @ yc.transpose(-1, -2))
        v, i = d.min(dim=-1)
        vals.append(v.clamp_min(0.0))
        idxs.append(i)
    return torch.cat(vals), torch.cat(idxs)


def min_sqdist_forward(x: torch.Tensor, y: torch.Tensor,
                       bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, argmin) over targets by device: kernel on CUDA, plain on CPU.
    -> ([B, M] float32, [B, M] int64)."""
    if x.device.type == "cuda":
        val, idx = min_sqdist_forward_cuda(x.contiguous(), y.contiguous(), bias.contiguous())
        return val, idx.long()
    return min_sqdist_forward_plain(x, y, bias)


# ----------------------------------------------------- min_sqdist backward

def min_sqdist_backward_cuda(idx: torch.Tensor, diff: torch.Tensor, g: torch.Tensor,
                             V: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``uuo_min_sqdist_bwd``: idx [B, M] int32, diff [B, M, 3],
    g [B, M] -> dy [B, V, 3] (-sum of diff per selected target), dbias
    [B, V] (sum of g per selected target).

    Replaces ``_bwd_kernel`` (uuo_mocap_tpu/ops/chamfer_pallas.py:125-189):
    the TPU's one-hot matmul becomes an atomic scatter into zeroed outputs,
    so the summation order (and the last bits of a sum of several rows)
    varies from run to run.  Bound by writing the [B, V] outputs."""
    B, M = idx.shape
    _check(idx, "idx", torch.int32, (B, M))
    _check(diff, "diff", torch.float32, (B, M, 3))
    _check(g, "g", torch.float32, (B, M))
    dy = torch.zeros((B, V, 3), dtype=torch.float32, device=idx.device)
    dbias = torch.zeros((B, V), dtype=torch.float32, device=idx.device)
    lib = build()
    err = lib.uuo_min_sqdist_bwd(idx.data_ptr(), diff.data_ptr(), g.data_ptr(), dy.data_ptr(),
                                 dbias.data_ptr(), B, M, V, _stream(idx))
    _raise_on(err, "uuo_min_sqdist_bwd")
    min_sqdist_backward_cuda.launches += 1
    return dy, dbias


min_sqdist_backward_cuda.launches = 0


def min_sqdist_backward_plain(idx: torch.Tensor, diff: torch.Tensor, g: torch.Tensor,
                              V: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's scatter in PyTorch (``index_add_``, the XLA scatter of
    ``uuo_mocap_tpu/ops/chamfer.py:171-174``)."""
    B, M = idx.shape
    rows = (torch.arange(B, device=idx.device)[:, None] * V + idx.long()).reshape(-1)
    dy = torch.zeros((B * V, 3), dtype=diff.dtype, device=diff.device)
    dy.index_add_(0, rows, -diff.reshape(-1, 3))
    dbias = torch.zeros((B * V,), dtype=g.dtype, device=g.device)
    dbias.index_add_(0, rows, g.reshape(-1))
    return dy.reshape(B, V, 3), dbias.reshape(B, V)


def min_sqdist_backward(idx: torch.Tensor, diff: torch.Tensor, g: torch.Tensor,
                        V: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy, dbias) by device: kernel on CUDA, plain on CPU."""
    if idx.device.type == "cuda":
        return min_sqdist_backward_cuda(idx.to(torch.int32).contiguous(), diff.contiguous(),
                                        g.contiguous(), V)
    return min_sqdist_backward_plain(idx, diff, g, V)


KERNELS = (rank_nearest_cuda, min_sqdist_forward_cuda, min_sqdist_backward_cuda)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
