#!/usr/bin/env python3
"""The readings that ``portbench/limits/<workload>.json``'s limits are set
from, at a cell's own size on the card, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 13 ... [--faults 3]

For each seed, batch 1 of that seed's pool is solved through the timed path
and read by the check (``correctness.readings``) as the program's answer
(the lower readings), and with the reference in TF32 in the program's place
(the control).  For the first ``--faults`` seeds each fault of
``portbench/faults.py`` is read too (those that alter a sound solve's output
from that output).  The sound answer, the control and each fault are also
judged against the cell's limits (``correctness.judge``), as a run would
be.  Prints one JSON line per seed and a summary (the largest sound
reading, the smallest control and fault readings of each number, and
whether each was judged correct on every seed) last; ``--out`` also writes
them.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


NUMBERS = ("score_gap", "residual_mm", "label_gap_mm", "pick_gap_mm")


def worst(reads, name):
    return max((r[name] for r in reads if name in r), default=float("nan"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=ROOT, help="the checkout whose BENCHMARK.json to read")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from portbench import correctness, faults, harness, system, traffic as traffic_mod
    from portbench.manifest import Manifest
    from portbench.reference import body

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    man = Manifest.load(args.root)
    cell = man.cell(args.workload)
    limits = man.limits(args.workload)
    config, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    cfg = system.solve_config(config, traffic)
    arrays = harness.body_arrays(os.path.join(ROOT, ".cache", "portbench"))
    model64 = body.model_tensors(arrays)
    faces = arrays["faces"].astype(np.int64)
    model = system.build_model(arrays, args.device)
    system.build_kernels(args.device)
    solver = system.make_solver(model, cfg, args.device)
    columns, freq = int(config["markers"]["columns"]), float(config["frame_rate_hz"])
    hyp = int(cfg["num_root_orient_angles"])

    def batch(seed, k):
        b = traffic_mod.make_batch(traffic, config, model64, faces, seed, k)
        return b, system.prepare(b, columns, freq)

    system.warm_up(solver, batch(args.seeds[0], 0)[1])
    rows = []
    for i, seed in enumerate(args.seeds):
        b, preps = batch(seed, 1)
        t = time.perf_counter()
        out = system.solve(solver, preps)
        if args.device == "cuda":
            torch.cuda.synchronize()
        solve_s = time.perf_counter() - t
        ans = [(b, system.answers(out))]
        sound = correctness.readings(ans, arrays, args.device, hyp)
        control = correctness.readings(ans, arrays, args.device, hyp, control=True)
        row = {"seed": seed, "solve_s": solve_s,
               "sound": {n: worst(sound, n) for n in NUMBERS + ("mpjpe_mm", "prior_residual_mm")},
               "control": {n: worst(control, n) for n in NUMBERS},
               "correct": {"sound": correctness.judge(sound, limits)[0],
                           "control": correctness.judge(control, limits)[0]}}
        if i < args.faults:
            row["faults"] = {}
            for name, fn in faults.FAULTS.items():
                broken = (faults.OUTPUT_FAULTS[name](out) if name in faults.OUTPUT_FAULTS
                          else fn(solver, preps))
                fr = correctness.readings([(b, system.answers(broken))], arrays, args.device, hyp)
                row["faults"][name] = {n: worst(fr, n) for n in NUMBERS}
                row["faults"][name]["structure"] = max(len(r["structure"]) for r in fr)
                row["correct"][name] = correctness.judge(fr, limits)[0]
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": args.seeds,
               "lower": {n: max(r["sound"][n] for r in rows) for n in NUMBERS},
               "control_upper": {n: min(r["control"][n] for r in rows) for n in NUMBERS},
               "fault_upper": {f: {n: min(r["faults"][f][n] for r in rows if "faults" in r)
                                   for n in NUMBERS}
                               for f in faults.FAULTS if any("faults" in r for r in rows)},
               "ever_correct": {k: sorted({r["correct"][k] for r in rows if k in r["correct"]})
                                for k in rows[0]["correct"]},
               "mpjpe_max_mm": max(r["sound"]["mpjpe_mm"] for r in rows),
               "gpu": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
               "seconds": time.perf_counter() - T_START}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
