#!/usr/bin/env python3
"""The benchmark of uuo_mocap_tpu_torch's batch solve on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the run makes its inputs from the
seed, builds and warms the program, solves batches back to back for
``--seconds`` seconds, checks every answer against the plain reference
(``portbench/correctness.py``), and prints one JSON line last on standard
output: the end-to-end metrics with ``--trace 0``, the per-layer metrics with
``--trace 1``.  Each number compared is printed beside its limit as the last
lines on standard error, and under ``checks`` at the end of the JSON line.
Exits non-zero, printing no result, without the GPUs the cell asks for, or
when JAX, flax or the JAX package was loaded.  See ``portbench/README.md``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache", "portbench")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches live in the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    sys.path.insert(0, ROOT)
    from portbench import harness
    from portbench.manifest import Manifest

    manifest = Manifest.load(ROOT)
    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    try:
        result = harness.run(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START, log, cache_dir=CACHE)
    except harness.ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
