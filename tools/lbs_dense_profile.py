#!/usr/bin/env python3
"""Device time of the dense LBS forward in a benchmark cell's solves, on the card.

    python3 tools/lbs_dense_profile.py --workload random41.gappy.b16 --seed N \
        [--solves 2] [--tree DIR] [--label NAME]

Builds the cell's inputs, the program and its warm-up as ``portbench/run.py``
does, then traces ``--solves`` solves under ``torch.profiler`` (user ranges
only, as the benchmark's traced run) and prints one JSON line per solve:
the device's busy seconds, the seconds of device work inside the
``uuo.lbs.dense`` ranges (device ops clipped to each range's device-side
window), the ranges' count, the dense rows, and the kernels inside those
windows by time.  ``--tree`` imports ``uuo_mocap_tpu_torch`` from another
checkout (e.g. the parent commit unpacked with ``git archive`` into the
gitignored ``bench_trees/``); a tree whose ``lbs_forward`` opens no such
range gets one by wrapping ``lbs_forward`` wherever a module of the package
imported it.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN = "uuo.lbs.dense"


def _wrap_lbs_forward(counts: dict) -> None:
    """Give a package without the span a ``uuo.lbs.dense`` range around
    every ``lbs_forward`` call, and count its rows."""
    import functools

    import torch
    from torch.profiler import record_function

    import uuo_mocap_tpu_torch.body.model as bm

    orig = bm.lbs_forward

    @functools.wraps(orig)
    def spanned(model, pose_body, betas, root_orient, trans):
        if isinstance(model, bm.BodyModel):
            counts["rows"] += int(torch.Size(trans.shape[:-1]).numel())
        with record_function(SPAN):
            return orig(model, pose_body, betas, root_orient, trans)

    for name, mod in list(sys.modules.items()):
        if name.startswith("uuo_mocap_tpu_torch") and getattr(mod, "lbs_forward", None) is orig:
            mod.lbs_forward = spanned


def _dense_windows(events):
    """(device ops [(start, end, name)], the span's device-side windows)."""
    ops, windows = [], []
    for e in events:
        if e.device_type().name != "CUDA":
            continue
        s, d = e.start_ns(), e.duration_ns()
        if e.is_user_annotation():
            if e.name() == SPAN:
                windows.append((s, s + d))
        elif not e.name().startswith("uuo."):
            ops.append((s, s + d, e.name()))
    return sorted(ops), sorted(windows)


def reduce(events) -> dict:
    from portbench import yardstick

    ops, windows = _dense_windows(events)
    starts = [w[0] for w in windows]
    by_name: dict = {}
    inside = 0.0
    for s, e, name in ops:
        i = bisect.bisect_right(starts, e) - 1
        while i >= 0 and windows[i][1] > s:
            lo, hi = max(s, windows[i][0]), min(e, windows[i][1])
            if hi > lo:
                inside += (hi - lo) / 1e9
                row = by_name.setdefault(name[:90], [0, 0.0])
                row[0] += 1
                row[1] += (hi - lo) / 1e9
            i -= 1
    return {"busy_s": yardstick.union_s([(s, e) for s, e, _ in ops]), "dense_s": inside,
            "dense_ranges": len(windows),
            "dense_kernels": sorted(([n, c, t] for n, (c, t) in by_name.items()),
                                    key=lambda r: -r[2])[:12]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--solves", type=int, default=2)
    ap.add_argument("--tree", default=None, help="checkout to import uuo_mocap_tpu_torch from")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, system, trace, traffic as traffic_mod
    from portbench.manifest import Manifest
    from portbench.reference import body

    import uuo_mocap_tpu_torch
    from uuo_mocap_tpu_torch.utils import tracing

    manifest = Manifest.load(ROOT)
    cell = manifest.cell(args.workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    cfg = system.solve_config(config, traffic)
    arrays = harness.body_arrays(os.path.join(ROOT, ".cache", "portbench"))
    pool = traffic_mod.make_pool(traffic, config, body.model_tensors(arrays),
                                 arrays["faces"].astype(np.int64), args.seed)
    model = system.build_model(arrays, "cuda")
    system.build_kernels("cuda")
    solver = system.make_solver(model, cfg, "cuda")
    preps = [system.prepare(b, int(config["markers"]["columns"]), float(config["frame_rate_hz"]))
             for b in pool]
    counts = {"rows": 0}
    own_span = hasattr(tracing, "dense_lbs_rows")
    if not own_span:
        _wrap_lbs_forward(counts)

    def rows() -> int:
        return tracing.dense_lbs_rows() if own_span else counts["rows"]

    def kernel_rows():
        return tracing.dense_lbs_kernel_rows() if own_span else None

    system.warm_up(solver, preps[0])
    torch.cuda.synchronize()
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    for k in range(1, min(args.solves, len(pool) - 1) + 1):
        r0, k0 = rows(), kernel_rows()
        with trace._user_spans_only(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = system.solve(solver, preps[k])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        red = reduce(prof.profiler.kineto_results.events())
        k1 = kernel_rows()
        print(json.dumps({
            "label": args.label, "tree": os.path.dirname(uuo_mocap_tpu_torch.__file__),
            "workload": args.workload, "seed": args.seed, "solve": k, "card": power,
            "traced_solve_s": wall, "stage_times_s": out["stage_times_s"],
            "dense_rows": rows() - r0,
            "dense_kernel_rows": None if k1 is None else k1 - k0, **red}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
