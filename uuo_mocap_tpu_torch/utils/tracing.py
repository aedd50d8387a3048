"""The program's tracing: named spans on the profiler's timeline, a count of
the host's waits on the device, and the one stage timer.

Spans are ``torch.profiler.record_function`` ranges, opened only while a
profiler records; otherwise ``span`` hands back one shared null context, so
an untraced solve pays one check per span (about 0.2 us on an x86 server
core, where a ``record_function`` with no profiler costs 12-16 us).  The
profiler puts these ranges on the clock of its device records, so a reader
of the trace can put each idle gap of the device down to the innermost span
open on the host when the gap began.  Every name starts with ``PREFIX``:

  uuo.solve              one solve (``MultiSequenceSolver.solve_prepared``,
                         ``multimodal_video_mocap``): the root span
  uuo.stage.<name>       a stage timer (``stage``), e.g. ``uuo.stage.chamfer``
  uuo.part_fit.<phase>   the part fit's phases (setup, descend_prune,
                         score_prune, survivor_gather, descend_final,
                         score_final, relabel, assemble)
  uuo.lbfgs.init         the L-BFGS initial evaluation and state
  uuo.lbfgs.direction    the two-loop recursion
  uuo.lbfgs.line_search  the strong-Wolfe search; its self time is the
                         host dispatching the search's state machine
  uuo.lbfgs.eval         one closure call (forward and backward)
  uuo.lbfgs.grad         its ``torch.autograd.grad``: the backward's dispatch
  uuo.lbfgs.refill       the streaming working set's write-back and gather
  uuo.sync               a host read or copy that waits for the device
                         (``sync``), counted by ``sync_count``
  uuo.lbs.dense          one dense LBS forward (``body.model.lbs_forward``)

Beside ``sync_count``, two counters of the dense LBS forward's rows (the
product of its batch dims): ``dense_lbs_rows`` by either route, and
``dense_lbs_kernel_rows`` through the hand-written kernel
(``ops.lbs_kernels``).
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, Optional, TypeVar

import torch
from torch.profiler import record_function

PREFIX = "uuo."

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_syncs = 0
_dense_rows = 0
_dense_kernel_rows = 0

T = TypeVar("T")


def span(name: str):
    """A ``record_function`` range named ``PREFIX + name`` while a profiler
    records, else a shared null context."""
    if not _profiling():
        return _NULL
    return record_function(PREFIX + name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return run
    return wrap


def sync(read: Callable[..., T], *args, **kw) -> T:
    """``read(*args, **kw)``, a call that waits for the device (a read to the
    host, a copy from pageable host memory, a synchronize), inside a
    ``uuo.sync`` span and counted.  It adds no wait of its own."""
    global _syncs
    _syncs += 1
    with span("sync"):
        return read(*args, **kw)


def sync_count() -> int:
    """``sync`` calls made in this process so far (callers take differences)."""
    return _syncs


def count_dense_lbs(rows: int, kernel: bool) -> None:
    """Count a dense LBS forward of ``rows`` rows; ``kernel``: it ran
    through the hand-written kernel."""
    global _dense_rows, _dense_kernel_rows
    _dense_rows += rows
    if kernel:
        _dense_kernel_rows += rows


def dense_lbs_rows() -> int:
    """Dense LBS rows computed in this process so far, by either route."""
    return _dense_rows


def dense_lbs_kernel_rows() -> int:
    """Of those, the rows the hand-written kernel computed."""
    return _dense_kernel_rows


@contextlib.contextmanager
def stage(name: str, times: Dict[str, float], device: Optional[torch.device] = None):
    """Time a stage into ``times[name]`` (seconds on the host's clock, summed
    over calls) inside a ``uuo.stage.<name>`` span.  On a CUDA ``device`` the
    time ends in a synchronize, so it holds the stage's device work."""
    t0 = time.time()
    with span("stage." + name):
        yield
        if device is not None and device.type == "cuda":
            sync(torch.cuda.synchronize, device)
    times[name] = times.get(name, 0.0) + time.time() - t0
