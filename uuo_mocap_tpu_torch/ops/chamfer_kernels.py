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
    int attribute ``launches`` (the forward counts its many-query route in
    ``launches_rev``; ``launch_counts()`` reads them all);
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
import functools
import hashlib
import os
import re
import shutil
import subprocess
from typing import List, Optional, Tuple

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
    log: str = ""  # nvcc's output (ptxas -v) of the build of the loaded library


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def compiled(source: str, stem: str) -> Tuple[str, str]:
    """Compile the CUDA file ``source`` with ``NVCC_FLAGS`` into
    ``_build/lib<stem>_<hash>.so`` unless that library is built already
    (keyed by the source's content and the flags; a concurrent build
    replaces it atomically).  nvcc's output (ptxas -v) is kept beside the
    library (``*.log``).  Returns (the library's path, that output)."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if not (os.path.exists(path) and os.path.exists(f"{path}.log")):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {source}:\n{proc.stdout}{proc.stderr}")
        with open(f"{tmp}.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(f"{tmp}.log", f"{path}.log")
        os.replace(tmp, path)
    with open(f"{path}.log") as f:
        return path, f.read()


def build() -> ctypes.CDLL:
    """Compile ``csrc/chamfer.cu`` if its library is not built yet
    (``compiled``), load it, and declare the C signatures; ``_Library.log``
    holds nvcc's output of its build, whichever process built it.  Returns
    the loaded library."""
    if _Library.lib is not None:
        return _Library.lib
    path, _Library.log = compiled(SOURCE, "uuo_chamfer")
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.uuo_rank_nearest.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.uuo_min_sqdist_fwd.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_longlong, p]
    lib.uuo_min_sqdist_fwd_rev.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.uuo_min_sqdist_bwd.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.uuo_staged_smem.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_longlong),
                                    ctypes.POINTER(ctypes.c_longlong)]
    for fn in (lib.uuo_rank_nearest, lib.uuo_min_sqdist_fwd, lib.uuo_min_sqdist_fwd_rev,
               lib.uuo_min_sqdist_bwd, lib.uuo_staged_smem):
        fn.restype = ctypes.c_int
    _Library.lib, _Library.path = lib, path
    return lib


def ptxas_usage(log: str) -> List[dict]:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log (``_Library.log``): [{"kernel", "registers", "spill_stores",
    "spill_loads"}] in the log's order; kernel names as ptxas gives them
    (mangled)."""
    rows: List[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            rows.append(dict(kernel=m.group(1), registers=None, spill_stores=0, spill_loads=0))
            continue
        if not rows:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows[-1]["spill_stores"], rows[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[-1]["registers"] = int(m.group(1))
    return rows


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
    One block per (lane, frame): the frame is staged once in shared memory,
    each lane holds a few queries in registers (``nearest_staged`` in
    csrc/chamfer.cu, the forward's few-query kernel without its value).  The
    staged frame takes 16 bytes per vertex, so V is limited to about 14,000
    on an H100; a larger V raises before the launch."""
    L, F, M, _ = markers.shape
    V = verts.shape[2]
    _check(markers, "markers", torch.float32, (L, F, M, 3))
    _check(verts, "verts", torch.float32, (L, F, V, 3))
    if bias is not None:
        _check(bias, "bias", torch.float32, (L, V))
    need, limit = _staged_smem(M, V, markers.device.index or 0)
    if need > limit:
        raise RuntimeError(
            f"uuo_rank_nearest: a frame of {V} vertices needs {need} B of shared memory "
            f"(16 B per vertex, staged whole), more than the {limit} B a block may have")
    idx = torch.empty((L, F, M), dtype=torch.int32, device=markers.device)
    lib = build()
    err = lib.uuo_rank_nearest(markers.data_ptr(), verts.data_ptr(),
                               None if bias is None else bias.data_ptr(), idx.data_ptr(),
                               L * F, F, M, V, _stream(markers))
    _raise_on(err, "uuo_rank_nearest")
    rank_nearest_cuda.launches += 1
    return idx


rank_nearest_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _staged_smem(M: int, V: int, device: int) -> Tuple[int, int]:
    """(dynamic shared memory the staged kernel asks for to stage a whole
    frame, the most a block of the device may have beside the kernel's
    static arrays), in bytes."""
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    _raise_on(build().uuo_staged_smem(M, V, device, ctypes.byref(need), ctypes.byref(limit)),
              "uuo_staged_smem")
    return need.value, limit.value


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

# the few-query route (the staged kernel) takes M <= min(V, STAGED_MAX_M);
# any other M goes to the many-query kernel
STAGED_MAX_M = 1024


def min_sqdist_forward_cuda(x: torch.Tensor, y: torch.Tensor,
                            bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``uuo_min_sqdist_fwd`` / ``uuo_min_sqdist_fwd_rev``: x [B, M, 3],
    y [B, V, 3], bias [B, V] -> (min d2 + bias clamped >= 0 [B, M] float32,
    argmin [B, M] int32).

    Replaces ``_kernel`` (uuo_mocap_tpu/ops/chamfer_pallas.py:33-122)
    without its M <= 64 limit, by two routes, each with its own launch
    count: few queries (M <= V, M <= ``STAGED_MAX_M``; ``launches``) run
    the rank kernel's design with a value output, the frame staged once in
    shared memory (in chunks when it does not fit) and the queries in
    registers; many queries (the 6890-vertices-against-41-markers reverse
    direction; ``launches_rev``) give each thread four consecutive queries
    against targets staged once per block and element (see
    csrc/chamfer.cu)."""
    B, M, _ = x.shape
    V = y.shape[1]
    _check(x, "x", torch.float32, (B, M, 3))
    _check(y, "y", torch.float32, (B, V, 3))
    _check(bias, "bias", torch.float32, (B, V))
    val = torch.empty((B, M), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, M), dtype=torch.int32, device=x.device)
    lib = build()
    args = (x.data_ptr(), y.data_ptr(), bias.data_ptr(), val.data_ptr(), idx.data_ptr(), B, M, V)
    if M <= min(V, STAGED_MAX_M):
        _, limit = _staged_smem(M, V, x.device.index or 0)
        _raise_on(lib.uuo_min_sqdist_fwd(*args, limit, _stream(x)), "uuo_min_sqdist_fwd")
        min_sqdist_forward_cuda.launches += 1
    else:
        _raise_on(lib.uuo_min_sqdist_fwd_rev(*args, _stream(x)), "uuo_min_sqdist_fwd_rev")
        min_sqdist_forward_cuda.launches_rev += 1
    return val, idx


min_sqdist_forward_cuda.launches = 0
min_sqdist_forward_cuda.launches_rev = 0


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
    the TPU's one-hot matmul becomes a scatter without atomics that writes
    every output element once, each sum taken in the order m = 0, 1, ...,
    so it repeats bit for bit and equals ``min_sqdist_backward_plain`` on
    the CPU.  Indices outside [0, V) add nothing.  Bound by writing the
    [B, V] outputs."""
    B, M = idx.shape
    _check(idx, "idx", torch.int32, (B, M))
    _check(diff, "diff", torch.float32, (B, M, 3))
    _check(g, "g", torch.float32, (B, M))
    dy = torch.empty((B, V, 3), dtype=torch.float32, device=idx.device)
    dbias = torch.empty((B, V), dtype=torch.float32, device=idx.device)
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


# launch counters: name -> (wrapper, attribute); the forward counts each
# route on its own
COUNTERS = {
    "rank_nearest_cuda": (rank_nearest_cuda, "launches"),
    "min_sqdist_forward_cuda": (min_sqdist_forward_cuda, "launches"),
    "min_sqdist_forward_rev_cuda": (min_sqdist_forward_cuda, "launches_rev"),
    "min_sqdist_backward_cuda": (min_sqdist_backward_cuda, "launches"),
}


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}
