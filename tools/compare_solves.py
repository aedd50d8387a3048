#!/usr/bin/env python3
"""Solve chip_smoke.py's sequence with the ports of several trees on one
GPU, each solve in a fresh process, and compare the work each one did.

    python3 tools/compare_solves.py [--tree LABEL=DIR ...]

This checkout is the tree ``this``; another one (for example the parent
commit unpacked from ``git archive`` into a directory that .gitignore
lists; it needs ``uuo_mocap_tpu_torch/``) is named with ``--tree
parent=DIR``.  Every tree solves the same sequence
(``chip_smoke.make_sequence``: 450 frames x 41 markers, the shipped
``configs/video_mocap.yaml``, 4 yaw hypotheses) with its own
``uuo_mocap_tpu_torch``, in the order given and then reversed (parent,
this, this, parent).  Each solve prints one JSON line: the wall time, the
stage times, for every stage call its L-BFGS lane evaluations and kernel
launches, the totals, and digests of the markers and of the output.  Two
solves did the same work bit for bit iff their digests match.  Prints the
nvidia-smi line before and after.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import multiprocessing
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded by path (a tree may hold its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def solve_tree(label: str, tree: str) -> dict:
    """One solve with ``tree``'s port; run in a process of its own."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.data.config import load_config
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.pipeline import part_fit, stages
    from uuo_mocap_tpu_torch.pipeline.multimodal import multimodal_video_mocap

    cs = _chip_smoke()
    calls = []  # one record per stage call, in order

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            before = K.launch_counts()
            out = fn(*args, **kwargs)
            after = K.launch_counts()
            if hasattr(out, "lbfgs_evals"):
                evals = int(out.lbfgs_evals)
            else:
                evals = int(out[1].num_evals.sum())
            calls.append(dict(stage=name, lane_evals=evals,
                              **{k: after[k] - before[k] for k in after}))
            return out
        return wrapper

    part_fit.PartFitter.__call__ = counted("part_fit", part_fit.PartFitter.__call__)
    for name in ("chamfer_stage_batched", "marker_stage_batched"):
        setattr(stages.SolveStages, name, counted(name, getattr(stages.SolveStages, name)))

    K.build()
    model = synthetic_body_model(device="cuda")
    _, markers, prior = cs.make_sequence(model)
    cfg = load_config(os.path.join(HERE, "configs", "video_mocap.yaml"))
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out = multimodal_video_mocap(ImgSmpl.from_params(prior), ArrayMarkers(markers.cpu().numpy()),
                                 cfg, model, frame_bucket=None, device="cuda")
    torch.cuda.synchronize()
    return dict(tree=label, solve_s=time.time() - t0, stage_times_s=out["stage_times_s"],
                stage_calls=calls, lane_evals=out["lbfgs_evals"], launches=K.launch_counts(),
                markers_digest=cs.digest(markers),
                output_digest=cs.digest(*(out[k] for k in ("trans", "root_orient", "pose_body",
                                                           "betas"))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                    help="another checkout to solve with beside this one")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("compare_solves: no CUDA device available", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    print(f"gpu: {cs.gpu_line()}", flush=True)
    trees = [("this", HERE)] + [tuple(t.split("=", 1)) for t in args.tree]
    order = trees + trees[::-1]
    runs = []
    ctx = multiprocessing.get_context("spawn")
    for label, tree in order:
        with concurrent.futures.ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
            rec = pool.submit(solve_tree, label, tree).result()
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    for label, _ in trees:
        mine = [r for r in runs if r["tree"] == label]
        print(f"{label}: solves {[round(r['solve_s'], 2) for r in mine]} s, lane evaluations "
              f"{sorted({r['lane_evals'] for r in mine})}, rank launches "
              f"{sorted({r['launches']['rank_nearest_cuda'] for r in mine})}, output digests "
              f"{sorted({r['output_digest'] for r in mine})}", flush=True)
    print(f"gpu: {cs.gpu_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
