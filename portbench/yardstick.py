"""The benchmark's arithmetic: the card's published peaks, the roofline
bound of a nearest-vertex kernel call from its shapes, the device's busy
time from a profiler trace, and a short digest of arrays.

Frozen copies (commit 1ed4835): ``HBM_BYTES_PER_S``, ``FP32_FLOP_PER_S``,
``FLOPS_PER_PAIR``, ``bound`` and ``digest`` from ``chip_smoke.py:191-321``.
The per-call byte and operation counts follow ``chip_smoke.py``'s kernel
checks (``:466-468``, ``:525-527``, ``:558-559``).  ``union_s`` replaces
``tools/profile_torch_path.py:82-88``'s busy time (device time summed over
the profiler's CUDA events) by the union of the device ops' intervals, which
counts an overlap once.
"""
from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# what a nearest-vertex scan needs per (query, target) pair: (|t|^2 + bias)
# - 2 q.t as 3 FMAs on a pre-scaled query (the compare is not counted, so
# the bound is a floor)
FLOPS_PER_PAIR = 6
# the backward's operations per (row, query): a 3-vector and a scalar added
FLOPS_PER_BWD_QUERY = 4


def bound(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time in ms the card could take: bytes at HBM bandwidth or
    operations at the FP32 rate, whichever is longer, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rank_call_bound_ms(L: int, F: int, M: int, V: int, with_bias: bool) -> float:
    """``rank_nearest``: markers [L, F, M, 3], verts [L, F, V, 3], bias
    [L, V] read once, int32 picks [L, F, M] written once."""
    nbytes = 4 * (L * F * M * 3 + L * F * V * 3 + (L * V if with_bias else 0) + L * F * M)
    return bound(nbytes, FLOPS_PER_PAIR * L * F * M * V)[0]


def forward_call_bound_ms(B: int, M: int, V: int) -> float:
    """``min_sqdist_forward``: x [B, M, 3], y [B, V, 3], bias [B, V] read
    once, values and int32 picks [B, M] written once."""
    nbytes = 4 * (B * M * 3 + B * V * 3 + B * V) + 8 * B * M
    return bound(nbytes, FLOPS_PER_PAIR * B * M * V)[0]


def backward_call_bound_ms(B: int, M: int, V: int) -> float:
    """``min_sqdist_backward``: idx, diff [B, M, 3] and g [B, M] read once,
    dy [B, V, 3] and dbias [B, V] written once."""
    nbytes = B * M * (4 + 12 + 4) + B * V * (12 + 4)
    return bound(nbytes, FLOPS_PER_BWD_QUERY * B * M)[0]


def digest(*arrays) -> str:
    """A short hash of the arrays' bytes (tensors or numpy)."""
    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().numpy() if hasattr(a, "detach") else a
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def union_s(intervals: List[Tuple[int, int]]) -> float:
    """Seconds covered by [start, end) intervals in nanoseconds, overlaps
    counted once."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9
