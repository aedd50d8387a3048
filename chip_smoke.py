#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the Hopper kernels from
   ``uuo_mocap_tpu_torch/csrc`` with nvcc and prints the build time.
2. Kernel phase: every kernel against its plain PyTorch version on the card,
   at the main path's shapes (V = 6890 vertices, F = 450 frames, M = 41
   markers; the forward in both directions, markers against vertices and
   back): index agreement (at least 0.9999, and every disagreement a tie
   whose squared-distance gap is <= 1e-7 m^2), value error, the backward
   bit for bit (two launches, and the CPU plain version), kernel / plain /
   bound times in ms; each kernel instantiation's registers and spill bytes
   from ptxas (every one listed in EXPECTED_KERNELS, none spilling).  The
   batch path's widest shapes are held the same way: rank at L = 16 lanes x
   450 frames with the subtree bias (the part fit's working set) and the
   forward at the first hypothesis cull (16 lanes x 450 frames).
3. Batch phase (the main path): four synthetic 450 x 41 sequences made as
   ``bench.py:_make_batch_inner`` makes its random-layout batch (seed0 =
   2000), solved by ``MultiSequenceSolver(device="cuda").solve_prepared``
   on ``configs/video_mocap.yaml`` with ``bench.py``'s parallel settings
   (lane width 16, padded widths, the hypothesis cascade 50,150 / keep 2,1,
   the part tournament 15 / keep 2) but frame stride 1 in both hypothesis
   rounds, where bench.py strides the first round by 2: with betas shared
   by a lane's frames the strided round lands this batch 0.17 mm over the
   median gate (``tools/batch_variants.py``, PERF.md).  Every launch count
   is reset just before and read just after; the rank kernel and both
   forward routes must launch.  Outputs must be finite, of the reference's
   shapes, with betas the same in every frame, and the per-sequence MPJPE
   within ``bench.py``'s random-layout gates (mean and median <= 25 mm, max
   <= 35 mm).  Prints the solve time, frames per second, stage times, L-BFGS
   evaluation counts, the winning hypotheses, launches per stage call and
   an output digest.
4. The cmu_41 batch (bench.py's second layout, its gates 12 / 18 mm), as 3.
5. Full-surface phase: the random batch through ``MultiSequenceSolver`` with
   ``full_surface_config()`` (``FULL_SURFACE`` merged into 3.'s config): the
   root stage with every root loss and both chamfer directions, the part
   fit's dense path with the ground, foot and velocity losses, barycentric
   correspondences picked per part; the chamfer and marker stages as
   shipped.  Gates: outputs finite and of the reference's shapes,
   ``stages["root"]`` present, the root stage launched the backward and
   both forward routes; per sequence the chamfer stage's MPJPE <= 60 mm and
   the output's below 1.5 x the prior's (not 35 mm: on the synthetic mesh
   the configuration itself ends at 70-142 mm, in the JAX package too,
   ROADMAP C.7).  Prints stage
   times, evaluations, launches per stage call, the peak device memory and
   a digest.  Its launch counts are the kernels line's.
6. Single-sequence phase: one synthetic 450 x 41 sequence solved through
   ``multimodal_video_mocap(device="cuda")`` on the shipped
   ``configs/video_mocap.yaml`` (4 yaw hypotheses), with every launch count
   reset just before and read just after (the forward counts its few-query
   and many-query routes apart, and both must launch); outputs must be
   finite, of the reference's shapes, and within the random layout's 35 mm
   per-sequence MPJPE gate.  Then the dense-gradient chamfer stage (the
   same stage with ``single_directional: false`` and the dense branch's
   ``part_chamfer`` and ``ground`` terms, the path that differentiates
   min_sqdist and so launches the backward kernel) runs a few iterations.
7. CLI phase: the user's entry points in a temporary directory (export,
   ``cli.test --batch 4`` and sequential, ``eval.comparisons``).

The kernel phase also holds the forward at the root stage's part-chamfer
shapes (4 sequences x 450 frames: the largest and the smallest part with
markers, its vertices against the markers with the other parts' markers
biased away, and back) and the backward at a part's vertex count and at the
dense part fit's 16-lane working set.

Prints each solve's launch counts as a ``{"<phase>_launches": {...}}`` line,
then a ``{"kernels": [...]}`` line (launches from the full-surface phase,
which runs every kernel), the nvidia-smi line, and last
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
# a disagreement is a tie when the two picks' d2 differ by no more: float32
# rounding of the centered keys; the largest gaps read on an H100 are
# 2.03e-8 m^2 (rank L = 4) and 1.98e-8 m^2 (the forward's reverse direction)
TIE_GAP_M2 = 1e-7
# least share of picks equal to the plain version's (the readings are
# 0.999980-1.0: ties are rare)
AGREE_MIN = 0.9999
# forward value error against the plain version, m^2: a marker-to-vertex d2 is
# ~9e-5 (9.5 mm); float32 rounding of the O(1) centered terms measured <= 3.6e-7
FWD_VAL_TOL = 1e-6
SEED = 0
# every kernel instantiation in csrc/chamfer.cu, as its mangled name shows
# it: the staged kernel for Q = 1-7 queries per lane, for the rank pass (no
# value) and the few-query forward (value; whole frame, or in chunks); the
# many-query forward; the backward
EXPECTED_KERNELS = ([f"nearest_stagedILi{q}ELb{v}ELb{c}E" for v, c in ((0, 0), (1, 0), (1, 1))
                     for q in range(1, 8)] + ["nearest_many_queries", "min_sqdist_bwd_tiles"])
F_FRAMES, N_MARKERS = 450, 41
MPJPE_GATE_MM = 35.0  # the random layout's per-sequence gate
# the batch phases: bench.py's official batch and its gates per layout
# (GATES_MM: mean and median <= the first, per-sequence max <= the second)
BATCH, BATCH_SEED0 = 4, 2000
BATCH_GATES_MM = {"random": (25.0, 35.0), "cmu_41": (12.0, 18.0)}
# the hypothesis rounds' frame stride (bench.py's is 2,1; see the docstring)
BATCH_FRAME_STRIDE = 1
# the full-surface phase's accuracy gates, per sequence (ROADMAP C.7: on the
# synthetic mesh the configuration itself ends at 70-142 mm, in the JAX
# package as in the port).  The chamfer stage's snapshot, the last before
# the barycentric correspondences, ends at 44.7-53.3 mm (the shipped
# config's at 37.6-50.5 mm) and is held to 60 mm; the output, which the
# barycentric attachments on the mesh's long faces drag away, must stay
# below 1.5 times the prior's MPJPE (it reached 1.02 times)
FULL_SURFACE_CHAMFER_GATE_MM = 60.0
FULL_SURFACE_PRIOR_FACTOR = 1.5


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def require_launches(counts, what: str) -> None:
    """The rank kernel and both routes of the forward launched in ``what``."""
    for name, desc in (("rank_nearest_cuda", "the rank kernel"),
                       ("min_sqdist_forward_cuda", "the min_sqdist forward kernel (few queries)"),
                       ("min_sqdist_forward_rev_cuda",
                        "the min_sqdist forward kernel (many queries)")):
        require(counts[name] > 0, f"{what} never launched {desc}")


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


def lanes_verts(model, gt, L):
    """The ground-truth body's vertices under L yaw hypotheses: [L, F, V, 3]."""
    import torch

    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.ops import rotations as rot

    F = gt.trans.shape[0]
    angles = torch.arange(L, device="cuda", dtype=torch.float32) * (2 * torch.pi / L)
    root = rot.rot_z(angles[:, None, None, None].expand(L, F, 1, 1)) @ gt.root_orient
    with torch.no_grad():
        return lbs_forward(model, gt.pose_body, gt.betas, root,
                           gt.trans.expand(L, F, 3))["vertices"].contiguous()


def subtree_bias(model, L):
    """The part closure's vertex-exclusion bias [L, V]: 1e10 outside each
    lane's 11-bone subtree (the subtrees repeated when L exceeds them)."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.pipeline.part_fit import enumerate_subtree_masks

    masks, _ = enumerate_subtree_masks(model, num_bones=11)
    rows = masks[np.arange(L) % masks.shape[0]]
    return ((1.0 - torch.as_tensor(rows, device="cuda")) * 1e10).contiguous()


def rank_inputs(model, gt, markers, L, with_bias):
    """The rank kernel's inputs at the main path's shapes: the chamfer
    closure (L = 4, no bias) or the part closure (L = 8 for one sequence,
    16 for the batch's working set; subtree bias)."""
    F, M = markers.shape[0], markers.shape[1]
    mk = markers[None].expand(L, F, M, 3).contiguous()
    return mk, lanes_verts(model, gt, L), subtree_bias(model, L) if with_bias else None


def forward_inputs(model, gt, markers, L=8):
    """The forward kernel's inputs at part-fit scoring's shape (L = 8 subtree
    lanes x F frames): markers [B, M, 3] against vertices [B, V, 3] with the
    exclusion bias [B, V], and the reverse direction's marker bias [B, M]
    (1e10 on occluded markers)."""
    F, M = markers.shape[0], markers.shape[1]
    V, B = model.num_vertices, L * markers.shape[0]
    verts = lanes_verts(model, gt, L).reshape(B, V, 3)
    x = markers[None].expand(L, F, M, 3).reshape(B, M, 3).contiguous()
    vbias = subtree_bias(model, L)[:, None, :].expand(L, F, V).reshape(B, V).contiguous()
    occluded = (markers.abs().sum(-1) == 0).float() * 1e10  # [F, M]
    mbias = occluded[None].expand(L, F, M).reshape(B, M).contiguous()
    return x, verts, vbias, mbias


def cull_inputs(model, gt, markers, L=16, stride=BATCH_FRAME_STRIDE):
    """The forward's inputs at the batch's first hypothesis cull: L lanes
    (4 sequences x 4 hypotheses) at every ``stride``-th frame, markers
    [B, M, 3] against vertices [B, V, 3] (the single-directional score)."""
    M, V = markers.shape[1], model.num_vertices
    verts = lanes_verts(model, gt, L)[:, ::stride].contiguous()
    B = verts.shape[0] * verts.shape[1]
    x = markers[::stride][None].expand(L, -1, M, 3).reshape(B, M, 3).contiguous()
    return x, verts.reshape(B, V, 3)


def backward_inputs(V, F=F_FRAMES, M=N_MARKERS, lanes=4):
    """The backward kernel's inputs at a dense closure's shape (``lanes``
    lanes x F frames, M markers, V targets): random picks, differences,
    weights."""
    import torch

    B = lanes * F
    g = torch.Generator(device="cuda").manual_seed(SEED)
    idx = torch.randint(0, V, (B, M), device="cuda", generator=g, dtype=torch.int32)
    diff = torch.randn((B, M, 3), device="cuda", generator=g)
    gw = torch.randn((B, M), device="cuda", generator=g)
    return idx, diff, gw


def index_add_call(idx, diff, gw, V):
    """One PyTorch call computing the backward's function: ``index_add_``
    of (-diff, g) rows into a zeroed [B * V, 4] buffer (timed as the
    library yardstick only)."""
    import torch

    B, M = idx.shape
    rows = (torch.arange(B, device=idx.device)[:, None] * V + idx.long()).reshape(-1)
    src = torch.cat([-diff.reshape(-1, 3), gw.reshape(-1, 1)], dim=1)
    return lambda: torch.zeros((B * V, 4), device=idx.device).index_add_(0, rows, src)


def kernel_phase(model, gt, markers):
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K

    F, M, V = F_FRAMES, N_MARKERS, model.num_vertices
    results = {}

    # ---- rank kernel: the chamfer closure (L = 4, no bias) and the part
    #      closure (L = 8, and the batch's 16-lane working set; subtree
    #      exclusion bias)
    for L, with_bias in ((4, False), (8, True), (16, True)):
        mk, verts, bias = rank_inputs(model, gt, markers, L, with_bias)
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
        require(agree >= AGREE_MIN, f"rank L={L}: agreement {agree} below {AGREE_MIN}")
        ms = time_ms(lambda: K.rank_nearest_cuda(mk, verts, bias), 20)
        plain_ms = time_ms(lambda: K.rank_nearest_plain(mk, verts, bias), 3, warmup=1)
        nbytes = mk.numel() * 4 + verts.numel() * 4 + (0 if bias is None else bias.numel() * 4) + B * M * 4
        b_ms, b_by = bound(nbytes, B * M * V * FLOPS_PER_PAIR)
        print(f"rank L={L} bias={with_bias}: agreement {agree:.6f}, max tie gap {max_gap:.3g} m^2, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        results[f"rank_L{L}"] = dict(max_abs_err=max_gap, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None, agreement=agree)
        del verts

    # ---- min_sqdist forward: part-fit scoring, both directions (S = 8
    #      lanes), and the batch's first hypothesis cull (16 lanes, no bias)
    x, verts, vbias, mbias = forward_inputs(model, gt, markers)
    xc, vc = cull_inputs(model, gt, markers)
    for name, q, t, b in (("fwd", x, verts, vbias), ("rev", verts, x, mbias),
                          ("fwd_cull", xc, vc, torch.zeros(vc.shape[:2], device="cuda"))):
        results[f"min_sqdist_{name}"] = check_forward(name, q, t, b)
    del verts, vc

    # ---- the root stage's part chamfer (4 sequences x F frames): a part's
    #      vertices against the markers with the other parts' markers
    #      biased away (the many-query route), and back (few queries);
    #      the largest part and the smallest part with markers
    for tag, pq, pt, pb in part_inputs(model, gt, markers):
        results[f"min_sqdist_part_rev_{tag}"] = check_forward(f"part_rev_{tag}", pq, pt, pb)
        zero = torch.zeros(pq.shape[:2], device="cuda")
        results[f"min_sqdist_part_fwd_{tag}"] = check_forward(f"part_fwd_{tag}", pt, pq, zero)

    # ---- min_sqdist backward: the root stage's and the dense chamfer
    #      closure's shape (4 lanes x F frames against V), the part chamfer's
    #      (against the largest part's vertices) and the dense part fit's
    #      working set (16 lanes x F frames)
    results["min_sqdist_bwd"] = check_backward("", *backward_inputs(V), V, library=True)
    Vp = max(ids.numel() for ids in part_vertex_ids(model).values())  # the largest part
    results["min_sqdist_bwd_part"] = check_backward("part", *backward_inputs(Vp), Vp)
    results["min_sqdist_bwd_partfit"] = check_backward(
        "part fit", *backward_inputs(V, lanes=16), V)
    return results


def check_forward(name, q, t, b):
    """The forward kernel against its plain version on queries q [B, M, 3],
    targets t [B, V, 3], bias b [B, V]: picks (ties allowed), values, times."""
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K

    B = q.shape[0]
    val_k, idx_k = K.min_sqdist_forward_cuda(q, t, b)
    torch.cuda.synchronize()
    val_p, idx_p = K.min_sqdist_forward_plain(q, t, b)
    max_gap = float(pick_gap(q, t, b, idx_k, idx_p).max())
    val_err = float((val_k - val_p).abs().max())
    agree = float((idx_k.long() == idx_p).float().mean())
    require(max_gap <= TIE_GAP_M2, f"min_sqdist {name}: disagreement beyond a tie ({max_gap})")
    require(val_err <= FWD_VAL_TOL, f"min_sqdist {name}: value error {val_err}")
    require(agree >= AGREE_MIN, f"min_sqdist {name}: agreement {agree} below {AGREE_MIN}")
    ms = time_ms(lambda: K.min_sqdist_forward_cuda(q, t, b), 10)
    plain_ms = time_ms(lambda: K.min_sqdist_forward_plain(q, t, b), 3, warmup=1)
    Mq, Vt = q.shape[1], t.shape[1]
    nbytes = (q.numel() + t.numel() + b.numel()) * 4 + B * Mq * 8
    b_ms, b_by = bound(nbytes, B * Mq * Vt * FLOPS_PER_PAIR)
    route = "few queries" if Mq <= min(Vt, K.STAGED_MAX_M) else "many queries"
    print(f"min_sqdist {name} B={B} M={Mq} V={Vt} ({route}): agreement {agree:.6f}, max tie gap "
          f"{max_gap:.3g}, max value err {val_err:.3g}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return dict(max_abs_err=val_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, agreement=agree)


def check_backward(name, idx, diff, gw, V, library=False):
    """The backward kernel: two launches bit for bit equal, and equal to the
    plain version on the CPU (whose index_add_ adds in the same order);
    times, and with ``library`` the ``index_add_`` yardstick's."""
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K

    B, M = idx.shape
    tag = f"min_sqdist backward{' ' + name if name else ''}"
    first = K.min_sqdist_backward_cuda(idx, diff, gw, V)
    second = K.min_sqdist_backward_cuda(idx, diff, gw, V)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(first, second)), f"{tag}: two launches differ")
    ref = K.min_sqdist_backward_plain(idx.cpu(), diff.cpu(), gw.cpu(), V)
    err = max(float((a.cpu() - r).abs().max()) for a, r in zip(first, ref))
    require(all(torch.equal(a.cpu(), r) for a, r in zip(first, ref)),
            f"{tag}: differs from the CPU plain version (max {err})")
    del first, second, ref
    ms = time_ms(lambda: K.min_sqdist_backward_cuda(idx, diff, gw, V), 20)
    plain_ms = time_ms(lambda: K.min_sqdist_backward_plain(idx, diff, gw, V), 5)
    lib_ms = time_ms(index_add_call(idx, diff, gw, V), 20) if library else None
    nbytes = B * M * (4 + 12 + 4) + B * V * (12 + 4)
    b_ms, b_by = bound(nbytes, B * M * 4)
    print(f"{tag} B={B} M={M} V={V}: bitwise repeatable, equal to the CPU plain version, "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          + (f", index_add_ {lib_ms:.4f} ms" if library else "")
          + f", bound {b_ms:.4f} ms ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def part_vertex_ids(model):
    """{part id: vertex ids} of the model's parts."""
    from uuo_mocap_tpu_torch.ops.chamfer import part_vertex_index

    labels = model.vertex_part_labels()
    return dict(part_vertex_index(labels, range(model.lbs_weights.shape[1])))


def part_inputs(model, gt, markers, L=4):
    """The root stage's part-chamfer shapes, L sequences x F frames: for the
    largest part and the smallest part holding a marker (markers labelled
    by the part of their nearest vertex in the first frame) -> [(tag, part
    vertices [B, Vp, 3], markers [B, M, 3], the other parts' markers'
    bias [B, M])]."""
    import torch

    F, M = markers.shape[0], markers.shape[1]
    verts = lanes_verts(model, gt, L)  # [L, F, V, 3]
    labels = model.vertex_part_labels()
    near = torch.cdist(markers[0], verts[0, 0]).argmin(dim=-1)
    mlabels = labels[near]  # [M]
    parts = part_vertex_ids(model)
    held = [p for p in parts if bool((mlabels == p).any())]
    largest = max(held, key=lambda p: parts[p].numel())
    smallest = min(held, key=lambda p: parts[p].numel())
    x = markers[None].expand(L, F, M, 3).reshape(L * F, M, 3).contiguous()
    out = []
    for tag, pid in (("largest", largest), ("smallest", smallest)):
        ids = parts[pid]
        pv = verts.index_select(2, ids).reshape(L * F, ids.numel(), 3).contiguous()
        bias = ((mlabels != pid).float() * 1e10)[None].expand(L * F, M).contiguous()
        print(f"part {tag}: id {pid}, {ids.numel()} vertices, "
              f"{int((mlabels == pid).sum())} of {M} markers", flush=True)
        out.append((tag, pv, x, bias))
    del verts
    return out


def bench_parallel_config():
    """``configs/video_mocap.yaml`` with ``bench.py:479-534``'s parallel
    settings (its defaults, no environment overrides), the hypothesis
    rounds at ``BATCH_FRAME_STRIDE``."""
    from uuo_mocap_tpu_torch.data.config import load_config

    cfg = load_config(os.path.join(HERE, "configs", "video_mocap.yaml"))
    cfg["parallel"] = {
        "lane_width": 16, "part_lane_width": 16, "pad_width": True,
        "hypothesis_prune": {"enabled": True, "at_iters": [50, 150], "keep": [2, 1],
                             "rank_phase1": False, "frame_stride": BATCH_FRAME_STRIDE},
        "part_prune": {"enabled": True, "at_iters": 15, "keep": 2, "frame_stride": 1},
    }
    return cfg


# the full-surface phase's configuration: bench_parallel_config() with these
# overrides merged in (dicts merge key by key): the root stage on, with
# every root loss and both chamfer directions; the part fit with ground,
# foot and velocity losses (so its dense path); barycentric per-frame
# correspondences picked per part.  The chamfer and marker stages stay as
# shipped (the sparse main path).  tests/test_torch_full_surface.py runs
# the same overrides on the CPU.
FULL_SURFACE = {"stages": {
    "root": {"num_iters": 10000, "single_directional": False, "yaw_lock": True,
             "losses": {"full_chamfer": 10.0, "part_chamfer": 10.0, "reg_betas": 0.1,
                        "ground": 1.0, "trans_vel": 1.0, "root_orient_vel": 1.0}},
    "part": {"losses": {"ground": 1.0, "foot_contact": 1.0, "foot_velocity": 1.0,
                        "velocity": 1.0}},
    "compute_locations": {"use_mean": False, "use_barycentric": True},
    "segment": {"granularity": "part"},
}}


def merge_config(cfg, overrides):
    """``overrides`` merged into ``cfg`` in place, dicts key by key."""
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            merge_config(cfg[k], v)
        else:
            cfg[k] = copy.deepcopy(v)
    return cfg


def full_surface_config():
    return merge_config(bench_parallel_config(), FULL_SURFACE)


def make_batch(model, seed0=BATCH_SEED0, layout="random"):
    """``bench.py:_make_batch_inner``'s batch through the port's generators:
    sequence q has ground truth seed seed0 + 3q, markers seed0 + 3q + 1 (5 %
    occlusion; 41 at random vertices, or at the named layout's vertices with
    the columns padded to 41), prior seed0 + 3q + 2 (bench.py's noise).
    -> (ground truths, prepared sequences)."""
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.marker_layout import resolve_layout_vertex_ids
    from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
    from uuo_mocap_tpu_torch.data.synthetic import (
        generate_markers, perturb_params, random_pose_sequence)
    from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence

    vids = None if layout == "random" else resolve_layout_vertex_ids(layout, model)
    gts, preps = [], []
    for q in range(BATCH):
        s = seed0 + 3 * q
        gt = random_pose_sequence(F_FRAMES, seed=s, yaw=0.9, travel=0.5, device="cuda")
        markers = generate_markers(model, gt, num_markers=N_MARKERS, seed=s + 1,
                                   occlusion_rate=0.05, vertex_ids=vids)
        prior = perturb_params(gt, seed=s + 2, pose_noise=0.05, trans_noise=0.08, betas_noise=0.2)
        preps.append(prepare_sequence(
            ImgSmpl.from_params(prior), ArrayMarkers(markers.points.cpu().numpy()),
            frame_bucket=None, pad_to_markers=None if vids is None else N_MARKERS))
        gts.append(gt)
    return gts, preps


def count_stage_launches(obj, names, log):
    """Wrap the methods ``names`` of ``obj`` (on the instance) so that each
    call appends (name, launches during the call) to ``log``."""
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K

    def wrap(name, fn):
        def run(*args, **kw):
            before = K.launch_counts()
            out = fn(*args, **kw)
            after = K.launch_counts()
            log.append((name, {k: after[k] - before[k] for k in after if after[k] != before[k]}))
            return out

        return run

    for name in names:
        setattr(obj, name, wrap(name, getattr(obj, name)))


def mpjpe_mm(model, out, gt) -> float:
    """Per-sequence MPJPE (22 body joints) of a solve's output against the
    generating ground truth, in mm."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.body.model import lbs_forward

    def joints(pose, betas, root, trans):
        with torch.no_grad():
            return lbs_forward(model, pose, betas, root, trans)["joints"][:, :22]

    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    j_s = joints(dev(out["pose_body"]), dev(out["betas"]), dev(out["root_orient"]), dev(out["trans"]))
    j_gt = joints(gt.pose_body, gt.betas, gt.root_orient, gt.trans)
    return float(torch.linalg.norm(j_s - j_gt, dim=-1).mean()) * 1e3


def check_batch_results(model, out, gts, preps, tag):
    """A batch solve's outputs: the reference's keys and shapes, finite,
    betas the same in every frame (and so in each ``stages`` entry).
    -> per-sequence MPJPE (mm)."""
    import numpy as np

    F = F_FRAMES
    shapes = {"trans": (F, 3), "root_orient": (F, 1, 3, 3), "pose_body": (F, 23, 3, 3),
              "betas": (F, 10)}
    errs = []
    for q, (r, gt) in enumerate(zip(out["results"], gts)):
        shapes["markers_labels"] = (F, preps[q].M_real)
        for k, shp in shapes.items():
            require(r[k].shape == shp, f"{tag} sequence {q}: {k} shape {r[k].shape} != {shp}")
            require(bool(np.isfinite(r[k]).all()), f"{tag} sequence {q}: {k} has non-finite values")
        require("chain" in r and isinstance(r["best_hypothesis"], int),
                f"{tag} sequence {q}: output lacks chain / best_hypothesis")
        require(bool((r["betas"] == r["betas"][:1]).all()), f"{tag} sequence {q}: betas vary by frame")
        for stage, sd in r.get("stages", {}).items():
            for k, shp in (("trans", (F, 3)), ("root_orient", (F, 1, 3, 3)),
                           ("pose_body", (F, 23, 3, 3)), ("betas", (10,))):
                require(sd[k].shape == shp and bool(np.isfinite(sd[k]).all()),
                        f"{tag} sequence {q}: stage {stage} {k} shape {sd[k].shape} or not finite")
        errs.append(mpjpe_mm(model, r, gt))
    return errs


def batch_phase(model, layout="random"):
    """``MultiSequenceSolver.solve_prepared`` on one of bench.py's batches:
    the random layout (the main path) or cmu_41, each held to its gates.
    -> launch counts of the solve."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
    from uuo_mocap_tpu_torch.pipeline.segmentation import segment_rigid

    tag = "batch" if layout == "random" else f"{layout} batch"
    gates = BATCH_GATES_MM[layout]
    t0 = time.time()
    gts, preps = make_batch(model, layout=layout)
    print(f"{tag}: {BATCH} sequences of {preps[0].M_real} markers made in "
          f"{time.time() - t0:.2f} s; rigid groups per sequence "
          f"{[len(segment_rigid(p.markers[: p.F_real])) for p in preps]}", flush=True)
    solver = MultiSequenceSolver(model, bench_parallel_config(), device="cuda")
    per_call = []
    count_stage_launches(solver.part_fitter, ("fit_batch",), per_call)
    count_stage_launches(solver.stages, ("chamfer_stage_lanes", "score_chamfer_lanes",
                                         "nearest_points_lanes_nolabel", "marker_stage_lanes"),
                         per_call)
    K.reset_launch_counts()
    t0 = time.time()
    out = solver.solve_prepared(preps)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    counts = K.launch_counts()
    frames = BATCH * F_FRAMES
    print(f"{tag} solve: {solve_s:.2f} s, {frames / solve_s:.3f} frames/s ({frames} frames)",
          flush=True)
    print(f"{tag} stage times (s): {out['stage_times_s']}", flush=True)
    print(f"{tag} L-BFGS evaluations: {out['lbfgs_evals']}; per stage: "
          f"{json.dumps(out['eval_stats'])}", flush=True)
    print(f"{tag} best hypotheses: {out['best_hypothesis'].tolist()}, chains: "
          f"{[[int(c) for c in r['chain']] for r in out['results']]}", flush=True)
    print(f"{tag} launches per stage call: {per_call}", flush=True)
    print(json.dumps({f"{layout}_batch_launches": counts}), flush=True)
    keys = ("trans", "root_orient", "pose_body", "betas")
    print(f"{tag} output digest {digest(*(r[k] for r in out['results'] for k in keys))}",
          flush=True)
    require_launches(counts, f"the {tag} solve")

    errs = check_batch_results(model, out, gts, preps, tag)
    mean_v, med_v, max_v = float(np.mean(errs)), float(np.median(errs)), float(np.max(errs))
    print(f"{tag} MPJPE per sequence (mm): {[round(e, 3) for e in errs]}; mean {mean_v:.3f}, "
          f"median {med_v:.3f}, max {max_v:.3f} (gates {gates[0]} / {gates[1]} mm)", flush=True)
    require(mean_v <= gates[0] and med_v <= gates[0],
            f"{tag} MPJPE mean {mean_v:.2f} / median {med_v:.2f} mm above {gates[0]} mm")
    require(max_v <= gates[1], f"{tag} MPJPE max {max_v:.2f} mm above {gates[1]} mm")
    return counts


def full_surface_phase(model):
    """``MultiSequenceSolver.solve_prepared`` with ``full_surface_config()``
    on the random batch: the root stage, the part fit's dense path,
    barycentric correspondences per part.  Gates: outputs finite, of the
    reference's shapes, ``stages["root"]`` present, the root stage launched
    the backward and both forward routes, and per sequence the chamfer
    stage's MPJPE <= FULL_SURFACE_CHAMFER_GATE_MM and the output's <=
    FULL_SURFACE_PRIOR_FACTOR x the prior's (the configuration's own
    accuracy on the synthetic mesh is ROADMAP C.7's).  -> launch counts of
    the solve."""
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver

    tag = "full_surface"
    gts, preps = make_batch(model)
    solver = MultiSequenceSolver(model, full_surface_config(), device="cuda")
    per_call = []
    count_stage_launches(solver.part_fitter, ("fit_batch",), per_call)
    count_stage_launches(solver.stages, ("root_stage_lanes", "chamfer_stage_lanes",
                                         "score_chamfer_lanes", "nearest_points_lanes",
                                         "marker_stage_lanes"), per_call)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    t0 = time.time()
    out = solver.solve_prepared(preps, save_stages=True)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    frames = BATCH * F_FRAMES
    print(f"{tag} solve: {solve_s:.2f} s, {frames / solve_s:.3f} frames/s ({frames} frames); "
          f"peak memory {peak / 2**30:.3f} GiB ({(peak - base_mem) / 2**30:.3f} GiB above the "
          f"{base_mem / 2**30:.3f} GiB held before)", flush=True)
    print(f"{tag} stage times (s): {out['stage_times_s']}", flush=True)
    print(f"{tag} L-BFGS evaluations: {out['lbfgs_evals']}; per stage: "
          f"{json.dumps(out['eval_stats'])}", flush=True)
    print(f"{tag} best hypotheses: {out['best_hypothesis'].tolist()}, chains: "
          f"{[[int(c) for c in r['chain']] for r in out['results']]}", flush=True)
    print(f"{tag} launches per stage call: {per_call}", flush=True)
    print(json.dumps({f"{tag}_launches": counts}), flush=True)
    keys = ("trans", "root_orient", "pose_body", "betas")
    print(f"{tag} output digest {digest(*(r[k] for r in out['results'] for k in keys))}",
          flush=True)
    require_launches(counts, f"the {tag} solve")
    root_calls = [c for name, c in per_call if name == "root_stage_lanes"]
    require(len(root_calls) == 1, f"{tag}: {len(root_calls)} root stage calls, expected 1")
    for name in ("min_sqdist_backward_cuda", "min_sqdist_forward_cuda",
                 "min_sqdist_forward_rev_cuda"):
        require(root_calls[0].get(name, 0) > 0, f"{tag}: the root stage never launched {name}")
    for q, r in enumerate(out["results"]):
        require({"root", "chamfer", "marker", "marker_final"} <= set(r["stages"]),
                f"{tag} sequence {q}: stages {sorted(r['stages'])}")
    errs = check_batch_results(model, out, gts, preps, tag)
    per_stage = {}
    for r, gt in zip(out["results"], gts):
        for stage, sd in r["stages"].items():
            sd = dict(sd, betas=sd["betas"][None].repeat(F_FRAMES, 0))
            per_stage.setdefault(stage, []).append(round(mpjpe_mm(model, sd, gt), 3))
    prior = [mpjpe_mm(model, {"pose_body": p.o_pose_body, "betas": p.o_betas.repeat(p.F, 0),
                              "root_orient": p.o_root_orient, "trans": p.o_trans}, gt)
             for p, gt in zip(preps, gts)]
    print(f"{tag} MPJPE per sequence (mm): output {[round(e, 3) for e in errs]}, per stage "
          f"{per_stage}, prior {[round(e, 3) for e in prior]}", flush=True)
    require(max(per_stage["chamfer"]) <= FULL_SURFACE_CHAMFER_GATE_MM,
            f"{tag}: chamfer-stage MPJPE {max(per_stage['chamfer']):.2f} mm above "
            f"{FULL_SURFACE_CHAMFER_GATE_MM} mm")
    for q, (e, p) in enumerate(zip(errs, prior)):
        require(e <= FULL_SURFACE_PRIOR_FACTOR * p,
                f"{tag} sequence {q}: MPJPE {e:.2f} mm above {FULL_SURFACE_PRIOR_FACTOR} x the "
                f"prior's {p:.2f} mm")
    return counts


def path_phase(model, gt, markers, prior):
    import numpy as np
    import torch

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
    require_launches(main_counts, "the single-sequence solve")

    shapes = {"trans": (F, 3), "root_orient": (F, 1, 3, 3), "pose_body": (F, 23, 3, 3),
              "betas": (F, 10), "markers_labels": (F, M)}
    for k, shp in shapes.items():
        require(out[k].shape == shp, f"{k}: shape {out[k].shape} != {shp}")
        require(bool(np.isfinite(out[k]).all()), f"{k}: non-finite values")
    require("chain" in out and "mocap_markers" in out, "output dict lacks chain / mocap_markers")

    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    mpjpe = mpjpe_mm(model, out, gt)
    print(f"MPJPE vs generating ground truth: {mpjpe:.2f} mm (gate {MPJPE_GATE_MM} mm)", flush=True)
    require(mpjpe <= MPJPE_GATE_MM, f"MPJPE {mpjpe:.2f} mm above the gate")

    # ---- dense-gradient chamfer stage: differentiates min_sqdist (backward
    #      kernel), with the dense branch's part_chamfer and ground terms
    cfg_d = copy.deepcopy(cfg)
    cfg_d["stages"]["chamfer"]["single_directional"] = False
    cfg_d["stages"]["chamfer"]["num_iters"] = 3
    cfg_d["stages"]["chamfer"]["losses"].update(part_chamfer=10.0, ground=1.0)
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
        torch.as_tensor([np.bincount(c).argmax() for c in out["markers_labels"].T], device="cuda"))
    torch.cuda.synchronize()
    dense_counts = K.launch_counts()
    print(f"dense chamfer stage ({int(res.num_iters.max())} iterations, "
          f"{time.time() - t0:.2f} s) launches: {dense_counts}", flush=True)
    require(dense_counts["min_sqdist_backward_cuda"] > 0,
            "the dense chamfer stage never launched the backward kernel")
    require(bool(torch.isfinite(res.f).all()), "dense chamfer stage: non-finite loss")
    return main_counts, dense_counts, mpjpe


CLI_METHODS = ("moshpp", "hmr", "video_mocap")


def _timed(owner, name, timers, key, sync=True):
    """Replace ``owner.name`` by a wrapper adding its wall time (ending in a
    device synchronize) to ``timers[key]``; returns the original."""
    import torch

    fn = getattr(owner, name)

    def run(*args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        if sync:
            torch.cuda.synchronize()
        timers[key] = timers.get(key, 0.0) + time.time() - t0
        return out

    setattr(owner, name, run)
    return fn


def check_stageii(path, F, M):
    """One ``*_stageii*.npz`` has the reference's schema."""
    import numpy as np

    z = np.load(path)
    shapes = {"poses": (F, 72), "betas": (10,), "trans": (F, 3), "mocap_frame_rate": (),
              "mocap_markers": (F, M, 3), "gender": ()}
    require(sorted(z.files) == sorted(shapes), f"{path}: keys {sorted(z.files)}")
    for k, shp in shapes.items():
        require(z[k].shape == shp, f"{path}: {k} shape {z[k].shape} != {shp}")
    for k in ("poses", "betas", "trans"):
        require(bool(np.isfinite(z[k]).all()), f"{path}: {k} has non-finite values")
    require(str(z["gender"]) == "neutral" and float(z["mocap_frame_rate"]) == 30.0,
            f"{path}: gender {z['gender']}, rate {z['mocap_frame_rate']}")


def cli_phase():
    """The user's entry points, in process, in a temporary directory: the
    synthetic export, ``cli.test --batch 4`` (bench.py's parallel settings
    at frame stride 1) on 4 x 450 x 41, ``cli.test`` sequential on one
    150 x 41 sequence, and ``eval.comparisons`` on both.  -> launch counts."""
    import csv
    import glob
    import tempfile

    import numpy as np

    from uuo_mocap_tpu_torch.cli import export_synthetic_c3d
    from uuo_mocap_tpu_torch.cli import test as cli_test
    from uuo_mocap_tpu_torch.data import c3d_native
    from uuo_mocap_tpu_torch.data.c3d import read_c3d
    from uuo_mocap_tpu_torch.eval import comparisons, metrics
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.parallel import batch_solver
    from uuo_mocap_tpu_torch.pipeline import multimodal

    timers = {}
    originals = [
        (batch_solver.MultiSequenceSolver, "solve_prepared",
         _timed(batch_solver.MultiSequenceSolver, "solve_prepared", timers, "solve")),
        (multimodal, "multimodal_video_mocap",
         _timed(multimodal, "multimodal_video_mocap", timers, "solve")),
        (cli_test, "export_stageii", _timed(cli_test, "export_stageii", timers, "stageii_export",
                                            sync=False)),
        (metrics, "compute_m2s", _timed(metrics, "compute_m2s", timers, "m2s")),
    ]
    def yaml_lines(d, indent=0):
        for k, v in d.items():
            if isinstance(v, dict):
                yield " " * indent + f"{k}:"
                yield from yaml_lines(v, indent + 2)
            else:  # JSON scalars and flat lists are YAML flow values
                yield " " * indent + f"{k}: {json.dumps(v)}"

    # a child of the shipped config with the batch phases' parallel settings
    config = "\n".join([f"parent: {os.path.join(HERE, 'configs', 'video_mocap.yaml')}",
                        *yaml_lines({"parallel": bench_parallel_config()["parallel"]})]) + "\n"
    runs = (("cli_batch", [f"seq_{i:03d}" for i in range(BATCH)], F_FRAMES, 0, ["--batch", str(BATCH)]),
            ("cli_seq", ["seq_000"], 150, 10, []))
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
            cfg_path = os.path.join(d, "video_mocap_parallel.yaml")
            with open(cfg_path, "w") as f:
                f.write(config)
            t0 = time.time()
            c3d_native.build()
            print(f"cli: native c3d library build {time.time() - t0:.2f} s "
                  f"({c3d_native._Library.path})", flush=True)
            K.reset_launch_counts()
            for ds, seqs, frames, seed, extra in runs:
                synth = f"{seed}_{N_MARKERS}"
                t0 = time.time()
                export_synthetic_c3d.main(
                    ["--input_dir", d, "--dataset", ds, "--subjects", "s1", "--sequences", *seqs,
                     "--num_markers", str(N_MARKERS), "--num_frames", str(frames),
                     "--seed", str(seed)])
                export_s = time.time() - t0
                c3ds = sorted(glob.glob(os.path.join(d, ds, f"mocap_synthetic___{synth}", "s1", "*.c3d")))
                t0 = time.time()
                for p in c3ds:
                    require(read_c3d(p)["points"].shape == (frames, N_MARKERS, 4), f"{p}: shape")
                parse_s = time.time() - t0
                for k in ("solve", "stageii_export", "m2s"):
                    timers[k] = 0.0
                t0 = time.time()
                solved = cli_test.main(["--config", cfg_path, "--dataset", ds, "--input_dir", d,
                                        "--synthetic", "--print_options", *extra])
                cli_s = time.time() - t0
                require(solved == len(seqs), f"{ds}: cli.test solved {solved} of {len(seqs)}")
                out_dir = os.path.join(d, ds, "results", "video_mocap", "s1", f"synthetic_{synth}")
                for seq in seqs:
                    main_npz = os.path.join(out_dir, f"{seq}_stageii.npz")
                    stage_npz = sorted(glob.glob(os.path.join(out_dir, f"{seq}_stageii.*.npz")))
                    stages = [os.path.basename(p).split(".")[1] for p in stage_npz]
                    require(os.path.exists(main_npz) and {"chamfer", "marker", "marker_final"}
                            <= set(stages), f"{ds}/{seq}: outputs {stages}")
                    for p in [main_npz] + stage_npz:
                        check_stageii(p, frames, N_MARKERS)
                t0 = time.time()
                stats = comparisons.main(["--input_dir", d, "--dataset", ds, "--synthetic", synth,
                                          "--methods", *CLI_METHODS])
                eval_s = time.time() - t0
                stats_dir = os.path.join(d, ds, "results", "stats", ds, f"synthetic_{synth}")
                per_seq = {}
                for method in CLI_METHODS:
                    with open(os.path.join(stats_dir, f"{method}.csv")) as f:
                        per_seq[method] = list(csv.DictReader(f))
                    require(len(per_seq[method]) == len(seqs), f"{ds}: {method} rows")
                    require(all(np.isfinite(float(r["m2s"])) for r in per_seq[method]),
                            f"{ds}: {method} m2s not finite")
                vm = [float(r["mpjpe"]) for r in per_seq["video_mocap"]]
                print(f"{ds}: {len(seqs)} x {frames} x {N_MARKERS}; export {export_s:.2f} s, c3d parse "
                      f"{parse_s * 1e3:.2f} ms ({len(c3ds)} files), cli.test {cli_s:.2f} s (solve "
                      f"{timers['solve']:.2f} s, stageii export {timers['stageii_export']:.3f} s), "
                      f"evaluation {eval_s:.2f} s (m2s {timers['m2s']:.3f} s)", flush=True)
                print(f"{ds}: MPJPE per sequence (mm) video_mocap {vm}, hmr "
                      f"{[float(r['mpjpe']) for r in per_seq['hmr']]}; m2s mean (mm) "
                      f"{ {m: round(stats[m]['m2s']['mean'], 3) for m in CLI_METHODS} }", flush=True)
                require(max(vm) <= MPJPE_GATE_MM, f"{ds}: video_mocap MPJPE {max(vm):.2f} mm "
                        f"above {MPJPE_GATE_MM} mm")
                require(stats["video_mocap"]["mpjpe"]["mean"] < stats["hmr"]["mpjpe"]["mean"],
                        f"{ds}: video_mocap MPJPE not below the prior's")
            counts = K.launch_counts()
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    print(json.dumps({"cli_launches": counts}), flush=True)
    require_launches(counts, "the CLI phase")
    return counts


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K

    t_start = time.time()
    line = gpu_line()
    print(f"gpu: {line}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    K.build()
    print(f"kernel build: {time.time() - t0:.2f} s ({K._Library.path})", flush=True)
    usage = K.ptxas_usage(K._Library.log)
    for u in usage:
        print(f"  ptxas: {u['kernel']}: {u['registers']} registers, spill stores "
              f"{u['spill_stores']} B, spill loads {u['spill_loads']} B")
    for pattern in EXPECTED_KERNELS:  # each instantiation built once, none spills
        rows = [u for u in usage if pattern in u["kernel"]]
        require(len(rows) == 1, f"{len(rows)} ptxas lines match {pattern!r}, expected 1")
        require(rows[0]["spill_stores"] == 0 and rows[0]["spill_loads"] == 0,
                f"{rows[0]['kernel']} spills")
    require(len(usage) == len(EXPECTED_KERNELS),
            f"ptxas lists {len(usage)} kernels, expected {len(EXPECTED_KERNELS)}")

    model = synthetic_body_model(device="cuda")
    gt, markers, prior = make_sequence(model)

    kres = kernel_phase(model, gt, markers)
    batch_phase(model)  # the main path
    batch_phase(model, "cmu_41")
    t0 = time.time()
    launches = full_surface_phase(model)  # every kernel; the counts of the kernels line
    print(f"full_surface phase: {time.time() - t0:.1f} s", flush=True)
    path_phase(model, gt, markers, prior)
    cli_phase()
    print(f"chip_smoke total: {time.time() - t_start:.1f} s", flush=True)
    src = "uuo_mocap_tpu_torch/csrc/chamfer.cu"
    table = [
        dict(name="rank_nearest", route="cuda", source=src,
             replaces="uuo_mocap_tpu/ops/chamfer_pallas.py:195",
             launches=launches["rank_nearest_cuda"], **kres["rank_L4"]),
        dict(name="min_sqdist_forward", route="cuda", source=src,
             replaces="uuo_mocap_tpu/ops/chamfer_pallas.py:33",
             launches=launches["min_sqdist_forward_cuda"], **kres["min_sqdist_fwd"]),
        dict(name="min_sqdist_forward_rev", route="cuda", source=src,
             replaces="uuo_mocap_tpu/ops/chamfer_pallas.py:33",
             launches=launches["min_sqdist_forward_rev_cuda"], **kres["min_sqdist_rev"]),
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
