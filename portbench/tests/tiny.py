"""A tiny copy of the benchmark for CPU tests: the manifest and its files
copied to a temporary root, each traffic mix cut to 2 windows of 24 frames
and each stage to 2 iterations (lane widths 8), so that a whole run of the
harness takes seconds on the CPU."""
from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_ITERS = 2
# the limits at this size, read on the CPU (calibrate.py --root): sound runs'
# residuals 20.2-26.1 mm against 48.5 mm with every stage left unchanged, and
# score gaps of 6.5e-7-2.2e-6 against the TF32 control's 6.0e-4-9.2e-4
TINY_LIMITS = {"structure": {"limit": 0}, "score_gap": {"limit": 1e-4},
               "residual_mm": {"limit": 36.0}, "label_gap_mm": {"limit": 1.0},
               "pick_gap_mm": {"limit": 1.0}}


def tiny_root(tmp: str, pool_batches: int = 3) -> str:
    """``tmp`` filled with BENCHMARK.json and a cut copy of portbench's
    configs, traffic and limits (the code and metric readers are the
    repository's own) -> the root to pass to ``Manifest.load``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), os.path.join(tmp, "BENCHMARK.json"))
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(tmp, "portbench", sub), exist_ok=True)
        for name in os.listdir(os.path.join(REPO, "portbench", sub)):
            with open(os.path.join(REPO, "portbench", sub, name)) as f:
                data = json.load(f)
            if sub == "configs":
                for stage in ("part", "chamfer", "marker"):
                    data["solve"]["stages"][stage]["num_iters"] = TINY_ITERS
                data["solve"]["parallel"]["part_prune"]["at_iters"] = 1
            elif sub == "limits":
                data = TINY_LIMITS
            elif sub == "traffic":
                data.update(sequences_per_solve=2, frames=24, pool_batches=pool_batches)
                data["solver"]["parallel"].update(lane_width=8, part_lane_width=8)
            with open(os.path.join(tmp, "portbench", sub, name), "w") as f:
                json.dump(data, f)
    return tmp
