#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the Hopper kernels from
   ``uuo_mocap_tpu_torch/csrc`` with nvcc and prints the build time.
2. Kernel phase: every kernel against its plain PyTorch version on the card,
   at the main path's shapes (V = 6890 vertices, F = 450 frames, M = 41
   markers): index agreement (exact, except ties whose squared-distance gap
   is <= 3e-6 m^2), value error, kernel / plain / bound times in ms.
3. Path phase: one synthetic 450 x 41 sequence solved through
   ``multimodal_video_mocap(device="cuda")`` on the shipped
   ``configs/video_mocap.yaml`` (4 yaw hypotheses), with every launch count
   reset just before and read just after; outputs must be finite, of the
   reference's shapes, and within the random layout's 35 mm per-sequence
   MPJPE gate.  Then the dense-gradient chamfer stage (the same stage with
   ``single_directional: false``, the path that differentiates min_sqdist
   and so launches the backward kernel) runs a few iterations.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# what the function needs per (query, target) pair: (|t|^2 + bias) - 2 q.t as
# 3 FMAs on a pre-scaled query, |q|^2 added once per query after the argmin
# (the compare-and-select is not counted, so the bound is a floor)
FLOPS_PER_PAIR = 6
TIE_GAP_M2 = 3e-6  # a disagreement is a tie when the two picks' d2 differ by no more
BWD_TOL = 1e-5  # atomics sum in run-dependent order; values are O(1) sums of a few rows
# forward value error against the plain version, m^2: a marker-to-vertex d2 is
# ~9e-5 (9.5 mm); float32 rounding of the O(1) centered terms measured <= 3.6e-7
FWD_VAL_TOL = 1e-6
SEED = 0
F_FRAMES, N_MARKERS = 450, 41
MPJPE_GATE_MM = 35.0  # the random layout's per-sequence gate


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def digest(*arrays) -> str:
    """A short hash of the arrays' bytes (tensors or numpy)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().numpy() if hasattr(a, "detach") else a
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def pick_gap(q, t, bias, idx_a, idx_b):
    """|d2(pick a) - d2(pick b)| in float64 for [B, M] picks of queries
    q [B, M, 3] against targets t [B, V, 3] (+ bias [B, V])."""
    import torch

    def d2(idx):
        tb = torch.gather(t.double(), 1, idx.long()[..., None].expand(*idx.shape, 3))
        val = ((q.double() - tb) ** 2).sum(-1)
        if bias is not None:
            val = val + torch.gather(bias.double(), 1, idx.long())
        return val

    return (d2(idx_a) - d2(idx_b)).abs()


def make_sequence(model, device="cuda"):
    """The sequence every chip run solves: 450 frames x 41 markers with 5 %
    occlusion, yawed and travelling, and a prior perturbed as ``bench.py``
    perturbs it.  -> (ground truth SmplParams, markers [F, M, 3], prior)."""
    from uuo_mocap_tpu_torch.data.synthetic import (
        generate_markers, perturb_params, random_pose_sequence)

    gt = random_pose_sequence(F_FRAMES, seed=SEED, yaw=0.9, travel=0.5, device=device)
    markers = generate_markers(model, gt, num_markers=N_MARKERS, seed=SEED + 1,
                               occlusion_rate=0.05).points.contiguous()
    prior = perturb_params(gt, seed=SEED + 2, pose_noise=0.05, trans_noise=0.08, betas_noise=0.2)
    return gt, markers, prior


def kernel_phase(model, gt, markers):
    import torch

    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.ops import rotations as rot
    from uuo_mocap_tpu_torch.pipeline.part_fit import enumerate_subtree_masks

    F, M, V = F_FRAMES, N_MARKERS, model.num_vertices
    results = {}

    def lanes_verts(L):
        angles = torch.arange(L, device="cuda", dtype=torch.float32) * (2 * torch.pi / L)
        root = rot.rot_z(angles[:, None, None, None].expand(L, F, 1, 1)) @ gt.root_orient
        with torch.no_grad():
            return lbs_forward(model, gt.pose_body, gt.betas, root,
                               gt.trans.expand(L, F, 3))["vertices"].contiguous()

    # ---- rank kernel: the chamfer closure (L = 4, no bias) and the part
    #      closure (L = 8, subtree exclusion bias)
    masks, _ = enumerate_subtree_masks(model, num_bones=11)
    for L, with_bias in ((4, False), (8, True)):
        verts = lanes_verts(L)
        mk = markers[None].expand(L, F, M, 3).contiguous()
        bias = None
        if with_bias:
            bias = ((1.0 - torch.as_tensor(masks[:L], device="cuda")) * 1e10).contiguous()
        idx_k = K.rank_nearest_cuda(mk, verts, bias)
        torch.cuda.synchronize()
        idx_p = K.rank_nearest_plain(mk, verts, bias)
        B = L * F
        qb, tb = mk.reshape(B, M, 3), verts.reshape(B, V, 3)
        bb = None if bias is None else bias[:, None, :].expand(L, F, V).reshape(B, V)
        gap = pick_gap(qb, tb, bb, idx_k.reshape(B, M), idx_p.reshape(B, M))
        agree = float((idx_k.long() == idx_p).float().mean())
        max_gap = float(gap.max())
        require(max_gap <= TIE_GAP_M2, f"rank L={L}: disagreement beyond a tie (gap {max_gap})")
        ms = time_ms(lambda: K.rank_nearest_cuda(mk, verts, bias), 20)
        plain_ms = time_ms(lambda: K.rank_nearest_plain(mk, verts, bias), 3, warmup=1)
        nbytes = mk.numel() * 4 + verts.numel() * 4 + (0 if bias is None else bias.numel() * 4) + B * M * 4
        b_ms, b_by = bound(nbytes, B * M * V * FLOPS_PER_PAIR)
        print(f"rank L={L} bias={with_bias}: agreement {agree:.6f}, max tie gap {max_gap:.3g} m^2, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        results[f"rank_L{L}"] = dict(max_abs_err=max_gap, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None, agreement=agree)
        del verts

    # ---- min_sqdist forward: part-fit scoring, both directions (S = 8 lanes)
    L = 8
    verts = lanes_verts(L).reshape(L * F, V, 3)
    B = L * F
    x = markers[None].expand(L, F, M, 3).reshape(B, M, 3).contiguous()
    vbias = ((1.0 - torch.as_tensor(masks[:L], device="cuda")) * 1e10)[:, None, :].expand(
        L, F, V).reshape(B, V).contiguous()
    occluded = (markers.abs().sum(-1) == 0).float() * 1e10  # [F, M]
    mbias = occluded[None].expand(L, F, M).reshape(B, M).contiguous()
    for name, q, t, b in (("fwd", x, verts, vbias), ("rev", verts, x, mbias)):
        val_k, idx_k = K.min_sqdist_forward_cuda(q, t, b)
        torch.cuda.synchronize()
        val_p, idx_p = K.min_sqdist_forward_plain(q, t, b)
        gap = pick_gap(q, t, b, idx_k, idx_p)
        max_gap = float(gap.max())
        val_err = float((val_k - val_p).abs().max())
        agree = float((idx_k.long() == idx_p).float().mean())
        require(max_gap <= TIE_GAP_M2, f"min_sqdist {name}: disagreement beyond a tie ({max_gap})")
        require(val_err <= FWD_VAL_TOL, f"min_sqdist {name}: value error {val_err}")
        ms = time_ms(lambda: K.min_sqdist_forward_cuda(q, t, b), 10)
        plain_ms = time_ms(lambda: K.min_sqdist_forward_plain(q, t, b), 3, warmup=1)
        Mq, Vt = q.shape[1], t.shape[1]
        nbytes = (q.numel() + t.numel() + b.numel()) * 4 + B * Mq * 8
        b_ms, b_by = bound(nbytes, B * Mq * Vt * FLOPS_PER_PAIR)
        print(f"min_sqdist {name} B={B} M={Mq} V={Vt}: agreement {agree:.6f}, max tie gap "
              f"{max_gap:.3g}, max value err {val_err:.3g}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        results[f"min_sqdist_{name}"] = dict(max_abs_err=val_err, ms=ms, plain_ms=plain_ms,
                                            bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                            agreement=agree)
    del verts

    # ---- min_sqdist backward: the dense chamfer closure's shape (A = 4 lanes)
    B = 4 * F
    g = torch.Generator(device="cuda").manual_seed(SEED)
    idx = torch.randint(0, V, (B, M), device="cuda", generator=g, dtype=torch.int32)
    diff = torch.randn((B, M, 3), device="cuda", generator=g)
    gw = torch.randn((B, M), device="cuda", generator=g)
    dy_k, db_k = K.min_sqdist_backward_cuda(idx, diff, gw, V)
    torch.cuda.synchronize()
    dy_p, db_p = K.min_sqdist_backward_plain(idx, diff, gw, V)
    err = max(float((dy_k - dy_p).abs().max()), float((db_k - db_p).abs().max()))
    require(err <= BWD_TOL, f"min_sqdist backward: error {err}")
    ms = time_ms(lambda: K.min_sqdist_backward_cuda(idx, diff, gw, V), 20)
    plain_ms = time_ms(lambda: K.min_sqdist_backward_plain(idx, diff, gw, V), 5)
    rows = (torch.arange(B, device="cuda")[:, None] * V + idx.long()).reshape(-1)
    src = torch.cat([-diff.reshape(-1, 3), gw.reshape(-1, 1)], dim=1)
    lib_ms = time_ms(lambda: torch.zeros((B * V, 4), device="cuda").index_add_(0, rows, src), 20)
    nbytes = B * M * (4 + 12 + 4) + B * V * (12 + 4)
    b_ms, b_by = bound(nbytes, B * M * 4)
    print(f"min_sqdist backward B={B} M={M} V={V}: max err {err:.3g}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    results["min_sqdist_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms)
    return results


def path_phase(model, gt, markers, prior):
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.data.config import load_config
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.ops import rotations as rot
    from uuo_mocap_tpu_torch.ops.geometry import get_marker_mask
    from uuo_mocap_tpu_torch.pipeline.multimodal import multimodal_video_mocap
    from uuo_mocap_tpu_torch.pipeline.stages import SolveStages

    cfg = load_config(os.path.join(HERE, "configs", "video_mocap.yaml"))
    F, M = F_FRAMES, N_MARKERS
    img = ImgSmpl.from_params(prior)
    mocap = ArrayMarkers(markers.cpu().numpy())

    K.reset_launch_counts()
    t0 = time.time()
    out = multimodal_video_mocap(img, mocap, cfg, model, frame_bucket=None, device="cuda")
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    main_counts = K.launch_counts()
    print(f"main path launches: {main_counts}", flush=True)
    print(f"solve {solve_s:.2f} s, stage times {out['stage_times_s']}, "
          f"L-BFGS evals {out['lbfgs_evals']}, chain {[int(c) for c in out['chain']]}", flush=True)
    # bitwise fingerprints: two runs repeat exactly iff these match
    print(f"digests: markers {digest(markers)}, output "
          f"{digest(*(out[k] for k in ('trans', 'root_orient', 'pose_body', 'betas')))}", flush=True)
    require(main_counts["rank_nearest_cuda"] > 0, "the main path never launched the rank kernel")
    require(main_counts["min_sqdist_forward_cuda"] > 0,
            "the main path never launched the min_sqdist forward kernel")

    shapes = {"trans": (F, 3), "root_orient": (F, 1, 3, 3), "pose_body": (F, 23, 3, 3),
              "betas": (F, 10), "markers_labels": (F, M)}
    for k, shp in shapes.items():
        require(out[k].shape == shp, f"{k}: shape {out[k].shape} != {shp}")
        require(bool(np.isfinite(out[k]).all()), f"{k}: non-finite values")
    require("chain" in out and "mocap_markers" in out, "output dict lacks chain / mocap_markers")

    def joints(pose, betas, root, trans):
        with torch.no_grad():
            return lbs_forward(model, pose, betas, root, trans)["joints"][:, :22]

    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    j_s = joints(dev(out["pose_body"]), dev(out["betas"]), dev(out["root_orient"]), dev(out["trans"]))
    j_gt = joints(gt.pose_body, gt.betas, gt.root_orient, gt.trans)
    mpjpe = float(torch.linalg.norm(j_s - j_gt, dim=-1).mean()) * 1e3
    print(f"MPJPE vs generating ground truth: {mpjpe:.2f} mm (gate {MPJPE_GATE_MM} mm)", flush=True)
    require(mpjpe <= MPJPE_GATE_MM, f"MPJPE {mpjpe:.2f} mm above the gate")

    # ---- dense-gradient chamfer stage: differentiates min_sqdist (backward kernel)
    cfg_d = copy.deepcopy(cfg)
    cfg_d["stages"]["chamfer"]["single_directional"] = False
    cfg_d["stages"]["chamfer"]["num_iters"] = 3
    stages = SolveStages(model, cfg_d)
    mk = markers
    A = 4
    angles = torch.arange(A, device="cuda", dtype=torch.float32) * (2 * torch.pi / A)
    root = dev(out["root_orient"])
    root0 = rot.normalize_rotation(rot.rot_z(angles[:, None, None, None].expand(A, F, 1, 1)) @ root)
    K.reset_launch_counts()
    t0 = time.time()
    _, res = stages.chamfer_stage_batched(
        mk, get_marker_mask(mk), prior.pose_body, prior.betas, dev(out["pose_body"]),
        dev(out["betas"][:1]), root0, dev(out["trans"]),
        torch.zeros(M, dtype=torch.long, device="cuda"))
    torch.cuda.synchronize()
    dense_counts = K.launch_counts()
    print(f"dense chamfer stage ({int(res.num_iters.max())} iterations, "
          f"{time.time() - t0:.2f} s) launches: {dense_counts}", flush=True)
    require(dense_counts["min_sqdist_backward_cuda"] > 0,
            "the dense chamfer stage never launched the backward kernel")
    require(bool(torch.isfinite(res.f).all()), "dense chamfer stage: non-finite loss")
    return main_counts, dense_counts, mpjpe


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K

    line = gpu_line()
    print(f"gpu: {line}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    K.build()
    print(f"kernel build: {time.time() - t0:.2f} s ({K._Library.path})", flush=True)
    for ln in K._Library.log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"  ptxas: {ln.strip()}")

    model = synthetic_body_model(device="cuda")
    gt, markers, prior = make_sequence(model)

    kres = kernel_phase(model, gt, markers)
    main_counts, dense_counts, _ = path_phase(model, gt, markers, prior)
    launches = {"rank_nearest_cuda": main_counts["rank_nearest_cuda"],
                "min_sqdist_forward_cuda": main_counts["min_sqdist_forward_cuda"],
                # not on the shipped config's path: counted on the dense stage
                "min_sqdist_backward_cuda": dense_counts["min_sqdist_backward_cuda"]}
    src = "uuo_mocap_tpu_torch/csrc/chamfer.cu"
    table = [
        dict(name="rank_nearest", route="cuda", source=src,
             replaces="uuo_mocap_tpu/ops/chamfer_pallas.py:195",
             launches=launches["rank_nearest_cuda"], **kres["rank_L4"]),
        dict(name="min_sqdist_forward", route="cuda", source=src,
             replaces="uuo_mocap_tpu/ops/chamfer_pallas.py:33",
             launches=launches["min_sqdist_forward_cuda"], **kres["min_sqdist_fwd"]),
        dict(name="min_sqdist_backward", route="cuda", source=src,
             replaces="uuo_mocap_tpu/ops/chamfer_pallas.py:125",
             launches=launches["min_sqdist_backward_cuda"], **kres["min_sqdist_bwd"]),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in table]}))
    print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
