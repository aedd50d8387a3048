"""The port's tracing (``utils/tracing.py``) and the L-BFGS counters it feeds.

CPU: spans cost nothing without a profiler and nest under one; ``sync``
counts; ``BatchedLbfgs.last_run_stats``'s counters hold together on the
lockstep and the streaming paths, and the results are bit for bit the same
with the profiler on and off.  Card (marked ``cuda``, skips elsewhere):
``host_syncs`` against the syncs PyTorch's sync debug mode reports.  This
file imports no JAX; run it on the card with ``python -m pytest
--noconftest -m cuda tests/test_torch_tracing.py``."""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uuo_mocap_tpu_torch.solver.lbfgs import BatchedLbfgs, LbfgsOptions
from uuo_mocap_tpu_torch.utils import tracing


def _rosen(p, lane, shared, *aux):
    x = p["x"] * lane["scale"]
    return (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1 - x[:, :-1]) ** 2).sum(-1)


def _problem(L=7, n=5, device="cpu"):
    rng = np.random.RandomState(11)
    params0 = {"x": torch.as_tensor(rng.randn(L, n).astype(np.float32), device=device)}
    lane = {"scale": torch.as_tensor((0.5 + rng.rand(L, 1)).astype(np.float32), device=device)}
    return params0, lane


def _solver(max_width, with_prepare, max_ls=25, lr=1.0):
    calls = [0]

    def fun(*args):
        calls[0] += 1
        return _rosen(*args)

    prepare = (lambda p, lane, shared: p["x"].abs().sum(-1)) if with_prepare else None
    solver = BatchedLbfgs(fun, LbfgsOptions(max_iter=12, max_ls=max_ls, lr=lr),
                          max_width=max_width, prepare=prepare)
    return solver, calls


def _spans(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(tracing.PREFIX)]


def test_a_span_is_the_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert tracing.span("lbfgs.eval") is tracing.span("solve")
    with tracing.span("solve"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.span("solve") is not tracing.span("solve")


def test_sync_counts_each_call_and_returns_the_read():
    before = tracing.sync_count()
    assert tracing.sync(int, torch.tensor(3)) == 3
    assert tracing.sync(float, torch.tensor(0.5)) == 0.5
    assert tracing.sync_count() == before + 2


def test_the_stage_timer_sums_and_spans():
    times = {}
    before = tracing.sync_count()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with tracing.stage("chamfer", times, torch.device("cpu")):
                tracing.sync(bool, torch.ones(1).any())
    assert set(times) == {"chamfer"} and times["chamfer"] > 0
    assert tracing.sync_count() == before + 2  # the CPU stage adds no synchronize
    spans = _spans(prof)
    stages = [s for s in spans if s[0] == "uuo.stage.chamfer"]
    syncs = [s for s in spans if s[0] == "uuo.sync"]
    assert len(stages) == 2 and len(syncs) == 2
    assert all(any(a <= s0 and s1 <= b for _, a, b in stages) for _, s0, s1 in syncs)


@pytest.mark.parametrize("max_width", [None, 3], ids=["lockstep", "streaming"])
def test_lbfgs_spans_nest_under_the_profiler_and_change_nothing(max_width):
    params0, lane = _problem()
    plain, _ = _solver(max_width, False)
    p_off, r_off = plain.run(params0, lane, {})
    traced, _ = _solver(max_width, False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p_on, r_on = traced.run(params0, lane, {})
    assert torch.equal(p_on["x"], p_off["x"])
    for a, b in zip(r_on, r_off):
        assert torch.equal(a, b)
    assert traced.last_run_stats == plain.last_run_stats

    spans = _spans(prof)
    names = {n for n, _, _ in spans}
    assert {"uuo.lbfgs.init", "uuo.lbfgs.direction", "uuo.lbfgs.line_search", "uuo.lbfgs.eval",
            "uuo.lbfgs.grad", "uuo.sync"} <= names
    assert ("uuo.lbfgs.refill" in names) == (max_width is not None)

    def inside(name, parents):
        outer = [(a, b) for n, a, b in spans if n in parents]
        return all(any(a <= s and e <= b for a, b in outer) for n, s, e in spans if n == name)

    assert inside("uuo.lbfgs.grad", {"uuo.lbfgs.eval"})
    assert inside("uuo.lbfgs.eval", {"uuo.lbfgs.init", "uuo.lbfgs.line_search"})
    evals = sum(n == "uuo.lbfgs.eval" for n, _, _ in spans)
    st = traced.last_run_stats
    assert evals == st["device_evals"] // st["width"] - st["iterations"]
    assert sum(n == "uuo.sync" for n, _, _ in spans) == st["host_syncs"]


@pytest.mark.parametrize("max_width, with_prepare", [(None, False), (3, False), (3, True)],
                         ids=["lockstep", "streaming", "streaming_prepare"])
def test_lbfgs_counters_hold_together(max_width, with_prepare):
    params0, lane = _problem()
    solver, calls = _solver(max_width, with_prepare)
    before = tracing.sync_count()
    _, res = solver.run(params0, lane, {})
    st = solver.last_run_stats
    W, it = st["width"], st["iterations"]
    assert W == (7 if max_width is None else 3) and it > 0
    assert st["device_evals"] == W * (calls[0] + it)
    inits = 1 if max_width is None else 3  # one initial evaluation per pool chunk
    assert st["ls_evals"] == calls[0] - inits - (it if with_prepare else 0)
    assert it <= st["ls_evals"] <= solver.opts.max_ls * it
    assert st["lane_iters"] == int(res.num_iters.sum()) <= W * it
    assert st["lane_evals"] == int(res.num_evals.sum())
    assert 0 <= st["ls_exhausted"] <= st["lane_iters"]
    assert st["host_syncs"] == tracing.sync_count() - before > it


@pytest.mark.parametrize("max_width", [None, 3], ids=["lockstep", "streaming"])
def test_a_line_search_cut_to_two_evaluations_runs_out(max_width):
    """A first step ten times too long: two evaluations do not find a
    strong-Wolfe point."""
    params0, lane = _problem()
    solver, _ = _solver(max_width, False, max_ls=2, lr=10.0)
    solver.run(params0, lane, {})
    st = solver.last_run_stats
    assert 0 < st["ls_exhausted"] <= st["lane_iters"]
    assert st["ls_evals"] <= 2 * st["iterations"]


@pytest.mark.cuda
@pytest.mark.parametrize("max_width", [None, 3], ids=["lockstep", "streaming"])
def test_host_syncs_match_the_sync_debug_mode_on_the_card(max_width):
    """Every wait the run makes on the device goes through ``sync``: the
    warnings of ``torch.cuda.set_sync_debug_mode("warn")`` (a read to the
    host, a copy from pageable host memory) are as many as ``host_syncs``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sync debug mode watches CUDA streams)")
    params0, lane = _problem(device="cuda")
    solver, _ = _solver(max_width, False)
    solver.run(params0, lane, {})  # warm: lazy CUDA set-up syncs once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solver.run(params0, lane, {})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    synced = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(synced) == solver.last_run_stats["host_syncs"], [str(w.message) for w in synced[:3]]
