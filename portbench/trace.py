"""The traced window (``--trace 1``): the window's solves under
``torch.profiler`` with the spans of ``system.instrumented``, reduced to a
per-name summary (the full trace of a solve runs to hundreds of thousands of
kernels and is not kept).

The host side records the ``record_function`` ranges alone, not every
PyTorch op: a 2-window clean solve launches 1.7 million kernels, and with
every op recorded a run that traced one more solve after its window took
312-320 s of its 360."""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Tuple

from portbench import system, yardstick

OUTSIDE = "batch_solver (outside the spans)"
SPAN_NAMES = {s for _, _, s in system.STAGE_SPANS} | set(system.DISPATCHERS)


@contextlib.contextmanager
def _user_spans_only():
    """Have the profiler record user ranges (``RecordScope.USER_SCOPE``) and
    no op: its ``_enable_profiler`` given that scope for the context."""
    import torch.autograd.profiler as autograd_profiler
    from torch._C._profiler import RecordScope

    enable = autograd_profiler._enable_profiler

    def user_scope(config, activities, *_):
        return enable(config, activities, {RecordScope.USER_SCOPE})

    autograd_profiler._enable_profiler = user_scope
    try:
        yield
    finally:
        autograd_profiler._enable_profiler = enable


@contextlib.contextmanager
def traced(solver, device: str):
    """The window under the profiler, with the spans of
    ``system.instrumented``: yields a dict that holds, once the context has
    closed and been given ``window_s``, the window's summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    calls: List[float] = []
    summary: Dict = {}
    with system.instrumented(solver, calls):
        if device == "cuda":
            torch.cuda.synchronize()
        with _user_spans_only(), profile(activities=activities) as prof:
            yield summary
        t_read = time.perf_counter()
    summary.update(summarize(prof.profiler.kineto_results.events(), summary["window_s"], calls))
    summary["read_s"] = time.perf_counter() - t_read


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


def summarize(events, wall_s: float, call_bounds_s: List[float]) -> Dict:
    """Device ops and host spans of the raw profiler events -> busy seconds
    (the union of device ops), kernel launches, time by kernel name, the
    nearest kernels' time against the dispatchers' bounds, and the idle gaps
    between device ops by the innermost span the host was in."""
    device: List[Tuple[int, int]] = []
    by_name: Dict[str, List[float]] = {}
    spans: List[Tuple[int, int, str]] = []
    launches = 0
    for e in events:
        name = e.name()
        if e.device_type().name == "CUDA":
            if e.is_user_annotation() or name in SPAN_NAMES:
                continue
            s, d = e.start_ns(), e.duration_ns()
            device.append((s, s + d))
            row = by_name.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += d / 1e9
            launches += _is_kernel(name)
        elif name in SPAN_NAMES:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    nearest_s = sum(t for n, (_, t) in by_name.items()
                    if any(k in n for k in system.NEAREST_KERNELS))
    return {"window_s": wall_s, "busy_s": yardstick.union_s(device), "kernel_launches": launches,
            "by_name": sorted(([n, c, t] for n, (c, t) in by_name.items()), key=lambda r: -r[2]),
            "nearest_kernel_s": nearest_s, "nearest_bound_s": sum(call_bounds_s),
            "idle_gaps": idle_by_span(device, spans)}


def idle_by_span(device: List[Tuple[int, int]], spans: List[Tuple[int, int, str]]
                 ) -> List[List]:
    """Seconds of every gap between device ops, summed by the innermost
    span open on the host when the gap began, longest first."""
    spans = sorted(spans)
    parent, stack = [-1] * len(spans), []
    for i, (s, e, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] < s:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    starts = [s for s, _, _ in spans]
    out: Dict[str, float] = {}
    last_end = None
    for s, e in sorted(device):
        if last_end is not None and s > last_end:
            i = bisect.bisect_right(starts, last_end) - 1
            while i >= 0 and spans[i][1] < last_end:
                i = parent[i]
            name = spans[i][2] if i >= 0 else OUTSIDE
            out[name] = out.get(name, 0.0) + (s - last_end) / 1e9
        last_end = e if last_end is None else max(last_end, e)
    return sorted(([n, t] for n, t in out.items()), key=lambda r: -r[1])
