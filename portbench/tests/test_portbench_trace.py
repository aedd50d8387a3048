"""The traced window's reduction (``trace.summarize``) on a fixed list of
profiler events that holds the program's own spans, and the readers of the
program's L-BFGS counters.

The program's ``uuo.*`` ranges, host side and device side, leave every key
of ``summarize`` as it is without them, to the byte: the literal below is
what it gives on these events with the program's ranges taken out."""
import json

import pytest

from portbench import trace
from portbench.manifest import reader


class _Kind:
    def __init__(self, name):
        self.name = name


class _Event:
    """The part of a profiler event ``summarize`` reads (times in ns)."""

    def __init__(self, name, kind, start, end, annotation=False):
        self._name, self._kind = name, _Kind(kind)
        self._start, self._end, self._annotation = start, end, annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._kind

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def is_user_annotation(self):
        return self._annotation


NEAREST = "void nearest_staged<7, false>(float const*)"
ELEMENTWISE = "void at::native::elementwise_kernel<128, 2>"
GEMM = "sm80_xmma_gemm_f32f32"
EVENTS = [
    _Event("stages.chamfer_stage_lanes", "CPU", 0, 1000, True),
    _Event("rank_nearest", "CPU", 100, 150, True),
    _Event("stages.chamfer_stage_lanes", "CUDA", 0, 1000),
    _Event("uuo.solve", "CPU", 0, 2000, True),
    _Event("uuo.stage.chamfer", "CPU", 5, 1000, True),
    _Event("uuo.lbfgs.line_search", "CPU", 200, 600, True),
    _Event("uuo.sync", "CPU", 300, 400, True),
    _Event("uuo.lbfgs.eval", "CPU", 450, 550, True),
    _Event("uuo.lbfgs.grad", "CPU", 500, 540, True),
    _Event("uuo.lbfgs.eval", "CUDA", 450, 550, True),
    _Event(NEAREST, "CUDA", 10, 250),
    _Event(ELEMENTWISE, "CUDA", 260, 320),
    _Event(ELEMENTWISE, "CUDA", 380, 410),
    _Event(NEAREST, "CUDA", 470, 505),
    _Event(GEMM, "CUDA", 520, 560),
    _Event(GEMM, "CUDA", 1500, 1600),
    _Event("Memcpy HtoD (Pageable -> Device)", "CUDA", 2100, 2200),
    _Event(ELEMENTWISE, "CUDA", 2300, 2400),
    _Event("aten::add", "CPU", 2300, 2310),
]
BEFORE = ('{"window_s": 0.5, "busy_s": 7.05e-07, "kernel_launches": 7, "by_name": [["' + NEAREST
          + '", 2, 2.7499999999999996e-07], ["' + ELEMENTWISE + '", 3, 1.8999999999999998e-07], '
          '["' + GEMM + '", 2, 1.3999999999999998e-07], ["Memcpy HtoD (Pageable -> Device)", 1, '
          '1e-07]], "nearest_kernel_s": 2.7499999999999996e-07, "nearest_bound_s": 1.25e-07, '
          '"idle_gaps": [["stages.chamfer_stage_lanes", 1.085e-06], ["batch_solver (outside the '
          'spans)", 6e-07]]}')


@pytest.mark.parametrize("program", [False, True], ids=["without", "with_program_spans"])
def test_the_programs_spans_leave_the_summary_as_it_was(program):
    events = [e for e in EVENTS if program or not e.name().startswith("uuo.")]
    assert json.dumps(trace.summarize(events, 0.5, [1e-7, 2.5e-8])) == BEFORE


def _stats(syncs, ls_evals, iterations, exhausted, lane_iters):
    return {"width": 64, "lanes": 64, "device_evals": 640, "host_syncs": syncs,
            "ls_evals": ls_evals, "iterations": iterations, "ls_exhausted": exhausted,
            "lane_iters": lane_iters}


def _record(with_trace=True, with_counters=True):
    stats = [{"part_fit": _stats(30, 25, 20, 3, 300), "chamfer": _stats(50, 45, 40, 1, 900)},
             {"part_fit": _stats(20, 30, 20, 6, 300), "chamfer": _stats(60, 60, 40, 0, 1000)}]
    if not with_counters:
        stats = [{k: {"width": 64, "device_evals": 640} for k in s} for s in stats]
    record = {"solves": [{"wall_s": 10.0, "stage_times_s": {}, "eval_stats": s, "frames": 7200}
                         for s in stats], "peak_bytes": 0, "setup_s": 1.0}
    if with_trace:
        record["trace"] = {"busy_s": 12.0, "window_s": 20.0, "kernel_launches": 100}
    return record


@pytest.mark.parametrize("name, value", [
    ("lbfgs_syncs_per_solve", (30 + 50 + 20 + 60) / 2),
    ("ls_evals_per_iter", (25 + 45 + 30 + 60) / (20 + 40 + 20 + 40)),
    ("ls_exhausted_pct", 100.0 * (3 + 1 + 6 + 0) / (300 + 900 + 300 + 1000)),
])
def test_each_reader_of_the_programs_counters(name, value):
    read = reader(name)
    assert read(_record()) == pytest.approx(value, rel=1e-12)
    assert read(_record(with_trace=False)) == pytest.approx(value, rel=1e-12)
    assert read(_record(with_counters=False)) is None
