"""One run of a cell: inputs from the seed, the program built and warmed,
the measured window (traced with ``--trace 1``), the check of every
answer, and the result line.  ``run.py`` is the command; the tests call
``run`` directly with ``device="cpu"`` at a tiny size."""
from __future__ import annotations

import contextlib
import gc
import hashlib
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from portbench import correctness, system, traffic as traffic_mod
from portbench.manifest import Manifest, reader
from portbench.reference import body

# kernel names in the breakdown are cut to this length (templated names run to
# hundreds of characters)
NAME_CHARS = 160
# top-level module names that no run may have loaded once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "uuo_mocap_tpu")


class ForbiddenModules(RuntimeError):
    pass


def forbidden_loaded() -> List[str]:
    """The top-level names in ``sys.modules`` that are forbidden, compared
    whole (``uuo_mocap_tpu_torch`` is not ``uuo_mocap_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def body_arrays(cache_dir: Optional[str]) -> Dict[str, np.ndarray]:
    """The synthetic body's arrays, built once per checkout and kept under
    ``cache_dir`` keyed by the builder's source."""
    if cache_dir is None:
        return body.build_arrays()
    with open(body.__file__, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"body_arrays_{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    arrays = body.build_arrays()
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return arrays


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def run(manifest: Manifest, workload: str, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, log: Callable[[str], None], cache_dir: Optional[str] = None,
        solve: Callable = system.solve, control: bool = False) -> Dict[str, Any]:
    """One run -> the result dict, its ``checks`` last.  ``solve`` is the
    window's call (the tests put a broken one in its place); ``control``
    judges the reference in TF32 in the program's place
    (``correctness.readings``)."""
    import torch

    cell = manifest.cell(workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(workload)
    cfg = system.solve_config(config, traffic)

    arrays = body_arrays(cache_dir)
    pool = traffic_mod.make_pool(traffic, config, body.model_tensors(arrays),
                                 arrays["faces"].astype(np.int64), seed)
    model = system.build_model(arrays, device)
    system.build_kernels(device)
    solver = system.make_solver(model, cfg, device)
    preps = [system.prepare(b, int(config["markers"]["columns"]), float(config["frame_rate_hz"]))
             for b in pool]
    system.warm_up(solver, preps[0])
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s: pool of {len(pool) - 1} batches + the warm-up batch")

    # ---- the measured window: solves back to back, a new one only while it
    #      can be expected to end within ``seconds``; traced with ``trace``
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    solved, records, summary = [], [], None
    with contextlib.ExitStack() as stack:
        if trace:
            from portbench import trace as trace_mod

            summary = stack.enter_context(trace_mod.traced(solver, device))
        k = 1
        t0 = time.perf_counter()
        while k < len(pool):
            before = system.launch_counts()
            ts = time.perf_counter()
            out = solve(solver, preps[k])
            _sync(device)
            te = time.perf_counter()
            after = system.launch_counts()
            records.append({"wall_s": te - ts, "stage_times_s": dict(out["stage_times_s"]),
                            "eval_stats": out["eval_stats"], "frames": pool[k].frames,
                            "kernel_calls": {n: after[n] - before[n] for n in after}})
            solved.append((pool[k], system.answers(out)))
            log(f"solve {k}: {te - ts:.3f} s, stages {out['stage_times_s']}")
            k += 1
            elapsed = te - t0
            if elapsed + elapsed / len(records) > seconds:
                break
        else:
            log(f"the pool's {len(pool) - 1} batches ended before the window did")
        window_s = te - t0
        if summary is not None:
            summary["window_s"] = window_s
        t_stop = time.perf_counter()
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    if summary is not None:
        log(f"traced window: busy {summary['busy_s']:.3f} s, {summary['kernel_launches']} "
            f"kernels, the profiler stopped and its trace was read in "
            f"{time.perf_counter() - t_stop:.1f} s")

    found = forbidden_loaded()
    if found:
        raise ForbiddenModules(f"modules loaded that no run may load: {found}")

    # ---- the check, once the program's state is freed
    del solver, model, preps, out
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    hypotheses = int(cfg["num_root_orient_angles"])
    reads = correctness.readings(solved, arrays, device, hypotheses, control=control)
    correct, failed, checks = correctness.judge(reads, limits)
    for r in reads:
        if r["structure"]:
            log(f"batch {r['batch']} window {r['window']}: {r['structure']}")
    log(f"checked {len(reads)} windows in {time.perf_counter() - t_check:.1f} s; "
        + ", ".join(f"{n} max {max((r.get(n, 0.0) for r in reads), default=0.0):.4g}"
                    for n in ("mpjpe_mm", "prior_residual_mm", "prior_mpjpe_mm")))

    frames = sum(r["frames"] for r in records)
    if trace:
        record = {"solves": records, "trace": summary, "peak_bytes": peak, "setup_s": setup_s}
        metrics = {}
        for m in manifest.metrics_for(workload, "per_layer"):
            value = reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"frames_per_s": frames / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.metrics_for(workload, "end_to_end")}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(reads), "failed": failed, "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": [[n[:NAME_CHARS], t]
                                              for n, _, t in summary["by_name"][:10]],
                               "idle_gaps": summary["idle_gaps"][:10]}
    result["checks"] = checks
    log(f"window {window_s:.3f} s, {len(records)} solves, {frames} frames")
    return result
