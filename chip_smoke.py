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
   forward at the first hypothesis cull (16 lanes x 450 frames).  The dense
   LBS kernel (``ops/lbs_kernels.py``, built from ``csrc/lbs.cu``; its
   ptxas line must show no spill) against the plain chain
   (``lbs_forward_plain``) at the benchmark's 64 lanes x 450 frames:
   vertices and joints within LBS_TOL_M, the rank kernel's picks on both
   within the rank gates, its time beside its FP32 arithmetic bound and the
   plain chain's; every batch solve but the mesh's must launch it.
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
   digests of the output and of the chamfer-stage snapshot.
4. The cmu_41 batch (bench.py's second layout, its gates 12 / 18 mm), as
   3., through ``MultiSequenceSolver(mesh=make_mesh())``: the visible card as
   a 1 x 1 mesh, the unsharded solve (its digest as before).
4a. Mesh phase (``parallel/mesh.py``): the random batch through a (1, 2)
   mesh that names the card twice, the body model cut into two vertex
   blocks (the rank kernel and the forward once per block, at V = 3445,
   combined to the global argmin).  Gates: 3.'s gates, 3.'s winning
   hypotheses, each sequence's MPJPE within 2 mm of 3.'s.  Prints the rank
   launches beside 3.'s.  Then ``sharded_train_step`` at 4 x 450 x 41 for 10
   SGD steps on a 1 x 1 and the 1 x 2 mesh: the losses within rtol 1e-5,
   falling, the min_sqdist forward and backward kernels launched.
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
6. Model phase: the four shipped checkpoints (``checkpoints/``) read by the
   port's msgpack reader and built on the card; ``checkpoints/
   MANIFEST.json``'s held-out metrics recomputed with
   ``uuo_mocap_tpu_torch/models/heldout.py`` at its counts (4 x 8 windows
   of 41 markers; n = 2048).  Gates: every accuracy within 0.005 of
   MANIFEST's, the Pos2BC error within 0.5 mm of its 1.7 mm, the PosDiff
   reduction within 0.01 of its 0.8385, and
   ``tests/test_demo_checkpoints.py``'s quality gates.
7. Network phase: the random batch with ``part.mode: network`` (the
   multimodal segmenter on each prior's joints; the largest chain of its
   labels restricts the part fit).  Gates: as 3.'s shapes; the rank kernel
   and both forward routes launched; every sequence <= 35 mm and the mean
   <= 3.'s mean + 2 mm.  Prints the segmentation's label accuracy against
   the generating vertices' parts, the chains, the fit-mask sizes, stage
   times, evaluations, launches per stage call and a digest.
8. SDF phase: the random batch with ``marker.use_sdf: true`` (the marker
   stages co-optimize virtual markers through the Pos2BC / PosDiff nets on
   a dense forward).  Gates: the chamfer-stage snapshot's digest equal to
   3.'s (only the marker stages differ); outputs finite, of the
   reference's shapes; the rank kernel and both forward routes launched;
   every sequence <= 60 mm and the mean <= 45 mm (provisional, from the
   JAX package's TPU record).  Prints the marker stages' times, evaluations
   and peak device memory.
9. Reprojection phase: the random batch with the camera streams
   ``tests/test_batch_reprojection_network.py`` gives a synthetic prior
   (REPROJ_CAMERA, 0.2 m from the body), both reprojection stages on at
   REPROJ_ITERS iterations over REPROJ_ANGLES yaw seeds (lanes = sequence x
   seed; the chamfer term runs the few-query forward and the backward
   kernel).  Gates: outputs finite, of the reference's shapes; both stages
   timed and each launched both kernels; every sequence <= 35 mm.  Prints
   per sequence the per-seed metrics, the chosen seed, the iterations and
   evaluations, and a digest.  At 0.2 m most lanes stop after 2 iterations
   (ROADMAP C.12), so the stage then runs alone on the batch with the
   camera of ``tests/test_torch_reprojection.py`` (REPROJ_STAGE_CAMERA,
   4.9 m), where it descends.  Gates there: finite, both kernels launched,
   the median lane at least REPROJ_MIN_MEDIAN_ITERS iterations, every lane
   below its starting loss.
10. Ranking-variant phase: the random batch with ``optimizer.rank_hier`` and
   ``hypothesis_prune.rank_phase1`` (phase 1 of the tournament ranks once
   per iteration through the rank kernel; phase 2 and the rest of the
   chamfer stage rank coarse to fine, ``ops/rank_hier.py``).  Gates:
   outputs finite, of the reference's shapes; every phase-1 call launched
   the rank kernel; per sequence <= 60 mm and the mean <= 3.'s + 5 mm
   (provisional).  Prints the evaluations beside 3.'s, and the coarse-to-fine
   ranking against the rank kernel at the first cull's shape: the share of
   equal picks, the largest squared-distance gap where they differ, both
   times.
11. Single-sequence phase: one synthetic 450 x 41 sequence solved through
   ``multimodal_video_mocap(device="cuda")`` on the shipped
   ``configs/video_mocap.yaml`` (4 yaw hypotheses), with every launch count
   reset just before and read just after (the forward counts its few-query
   and many-query routes apart, and both must launch); outputs must be
   finite, of the reference's shapes, and within the random layout's 35 mm
   per-sequence MPJPE gate.  Then the dense-gradient chamfer stage (the
   same stage with ``single_directional: false`` and the dense branch's
   ``part_chamfer`` and ``ground`` terms, the path that differentiates
   min_sqdist and so launches the backward kernel) runs a few iterations.
12. Preprocess phase (host code): a raw capture at the size of a
   CMU-kitchen session (5 min at 120 Hz, 45 markers prefixed with the
   subject, 5 % of cells zero-filled, made from SEED) through
   ``cli.preprocess_datasets.run_dataset("cmu_kitchen", remove_backpack=
   True, parts=all three)`` at 15 s windows at 30 Hz.  Gates: 20 windows of
   450 frames for the whole body and for each part, the labels the
   subject's minus the backpack's, every window's points the raw capture's
   at ``get_downsampled_indices`` in metres within float32 rounding, the
   native and the Python parser equal; ``slice_gt_to_windows`` on a 300 s
   npz gives 20 windows of 450 frames.  Prints the wall time of
   ``run_dataset`` and the parse time per window.
13. CLI phase: the user's entry points in a temporary directory (export,
   ``cli.test --batch 4`` and sequential on 80 frames, ``eval.comparisons``); the
   sequential run saves its iteration journal (``--save_iterations``),
   which must load with ``pickle`` alone and hold every stage, its L-BFGS
   segments at multiples of 50 iterations or a lane's last.  On the four
   solved 450 x 41 sequences it runs the tools (``tools_checks``):
   ``cli.filter`` (same shapes, less frame-to-frame jitter),
   ``cli.export_marker_layout`` on the card and with ``--cpu_only`` (the PLY
   header counts V + 6M vertices and F + 8M faces; finite distances; per
   marker the same face, or a tie at the same closest point and template
   position, within 1e-5 m; distances within 1e-5 m) and
   ``eval.qualitative``'s device half (``posed_vertices``) for the ground
   truth and the solve at 90 frames, finite and within 1e-5 m of the CPU.
   Then the vis phase (``vis_checks``): the device halves of the vis CLIs
   on the card and on the CPU (posed vertices within 1e-5 m, segmentation
   labels and the paper's confusion matrix equal, the reprojection stage
   finite) and ``visualize_model``'s solve on one CLI sequence with
   5-iteration stages (finite, the reference's keys and shapes; its
   launches printed).  The renderer is not called: the GPU machine has no
   matplotlib.
14. Training phase: the six model families trained on the card into a
   temporary directory (never ``checkpoints/``).  The four that
   ``checkpoints/MANIFEST.json`` records run its recipe through
   ``models/train.py`` (6000 steps at latent 128; the segmenters at batch
   32, Pos2BC and PosDiff at 512, PosDiff on a pool of 65536) and are saved
   with ``save_params``; the motion embedding and foot-contact nets train
   through ``cli.train.main`` at its defaults (300 steps, batch 8).  Every
   file is read back with ``load_params`` and ``convert.py``.  Gates
   (``tests/test_demo_checkpoints.py``'s): unimodal accuracy >= MANIFEST's
   majority baseline + 0.05 and >= 0.85 on the cmu_41 layout, multimodal
   >= 0.70 and >= 0.95, Pos2BC <= 5 mm, PosDiff reduction >= 0.60; the
   motion embedding's last 5 losses below ln 8 - 0.05 on average; the
   foot-contact loss falling; every loss finite.  Prints steps per second,
   wall time (the data pools included), first and last loss, and the gap to
   MANIFEST's figures.

The kernel phase also holds the forward at the root stage's part-chamfer
shapes (4 sequences x 450 frames: the largest and the smallest part with
markers, its vertices against the markers with the other parts' markers
biased away, and back) and the backward at a part's vertex count and at the
dense part fit's 16-lane working set, each beside ``zeros`` + ``index_add_``.
Every batch configuration sets ``checkpoints_dir`` to the repository's
``checkpoints/``, the CLI phase's config too.

Prints each solve's launch counts as a ``{"<phase>_launches": {...}}`` line,
then a ``{"kernels": [...]}`` line (launches from the full-surface phase,
which runs every kernel), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.  Imports
nothing of JAX.  On one H100 (700 W) the whole run took 898.6 s, the
kernel build, the mesh, vis and training phases included, the host setting
the spread (allow it 1200 s; PERF.md section 5 has every total).
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
# the dense LBS kernel against the plain chain at the benchmark's shape (64
# lanes x 450 frames): the largest vertex difference, m (FP32 sums over K =
# 218 and a vertex's weights in another order than the chain's GEMMs)
LBS_LANES, LBS_TOL_M = 64, 5e-6
SEED = 0
STAGE_KEYS = ("trans", "root_orient", "pose_body", "betas")
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
CHECKPOINTS = os.path.join(HERE, "checkpoints")
# the model phase: each held-out accuracy within this of checkpoints/
# MANIFEST.json's (the JAX package's evaluators reproduce every MANIFEST
# number on the CPU; the port's give the same values there); the Pos2BC
# expected-point error within 0.5 mm of the recorded 1.7 mm; the PosDiff
# distance reduction within 0.01 of the recorded 0.8385
MANIFEST_ACC_TOL = 0.005
POS2BC_ERR_TOL_M = 0.0005
POS_DIFF_REDUCTION_TOL = 0.01
# the network phase: tools/exp_network_mode.py's criterion, the mean MPJPE at
# most the same run's random-batch mean + 2 mm, and every sequence <= 35 mm
NETWORK_MEAN_MARGIN_MM = 2.0
# the SDF phase, provisional: per sequence <= 60 mm and the mean <= 45 mm
# (the JAX package's TPU record of the SDF mode reads 38.48 mm on this batch)
SDF_GATE_MM, SDF_MEAN_GATE_MM = 60.0, 45.0
# the reprojection phase: the camera streams tests/test_batch_reprojection_network.py
# gives a synthetic prior (the crop camera (1, 0, 0), bbox centre (320, 240),
# scale 200, image size (480, 640) in every frame; the 2D targets are the
# prior's own projection through it, so constant streams are a coherent
# camera), and a depth a user would give the stages (no shipped config turns
# them on; the JAX tests run 8-10 iterations over 2 seeds).  That camera is
# 2 x 5000 / (s x 51200 crop pixels) = 0.2 m from the body, where the
# objective is so steep that most lanes stop after 2 iterations (ROADMAP
# C.12); so the phase also runs the stage alone on the same batch with the
# camera of tests/test_torch_reprojection.py (crop camera (0.04, 0, 0), 4.9 m),
# where it descends, and gates the median lane's iterations there.
REPROJ_CAMERA = {"camera_bbox": (1.0, 0.0, 0.0), "center": (320.0, 240.0), "scale": (200.0,),
                 "size": (480.0, 640.0)}
REPROJ_STAGE_CAMERA = dict(REPROJ_CAMERA, camera_bbox=(0.04, 0.0, 0.0))
REPROJ_MIN_MEDIAN_ITERS = 10
REPROJ_ITERS, REPROJ_ANGLES = 200, 4
# the ranking-variant phase, provisional (the TPU records of these variants
# are claims about another chip): per sequence <= 60 mm, the mean at most the
# random batch's + 5 mm
RANK_VARIANT_GATE_MM, RANK_VARIANT_MEAN_MARGIN_MM = 60.0, 5.0


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
    angles = torch.arange(L, device=gt.trans.device, dtype=torch.float32) * (2 * torch.pi / L)
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


def lbs_check(model, gt, markers, L=LBS_LANES):
    """The dense LBS kernel (``ops/lbs_kernels.py``) at the benchmark's
    working set, L yaw lanes x F frames with per-lane betas: the no-grad
    ``lbs_forward`` (one kernel launch) against ``lbs_forward_plain`` (the
    chain of GEMMs and broadcasts), vertices and joints within LBS_TOL_M,
    the rank kernel's picks on both within AGREE_MIN and TIE_GAP_M2; the
    kernel's time beside its bound, the whole kernel-route forward's and
    the plain forward's.  -> the kernels line's row."""
    import torch

    from uuo_mocap_tpu_torch.body.model import lbs_forward, lbs_forward_plain, lbs_kernel_args
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.ops import lbs_kernels as LK
    from uuo_mocap_tpu_torch.ops import rotations as rot

    F, M, V = F_FRAMES, N_MARKERS, model.num_vertices
    g = torch.Generator(device="cuda").manual_seed(SEED)
    angles = torch.arange(L, device="cuda", dtype=torch.float32) * (2 * torch.pi / L)
    root = rot.rot_z(angles[:, None, None, None].expand(L, F, 1, 1)) @ gt.root_orient
    betas = gt.betas.reshape(1, 1, 10) + 0.5 * torch.randn(L, 1, 10, device="cuda", generator=g)
    args = (gt.pose_body, betas, root, gt.trans.expand(L, F, 3))
    launches = LK.lbs_vertices_cuda.launches
    with torch.no_grad():
        out = lbs_forward(model, *args)
        plain = lbs_forward_plain(model, *args)
    torch.cuda.synchronize()
    require(LK.lbs_vertices_cuda.launches == launches + 1,
            "lbs: the no-grad CUDA forward did not launch the kernel once")
    err = float((out["vertices"] - plain["vertices"]).abs().max())
    err_j = float((out["joints"] - plain["joints"]).abs().max())
    mk = markers[None].expand(L, F, M, 3).contiguous()
    idx_k, idx_p = K.rank_nearest(mk, out["vertices"]), K.rank_nearest(mk, plain["vertices"])
    B = L * F
    gap = float(pick_gap(mk.reshape(B, M, 3), plain["vertices"].reshape(B, V, 3), None,
                         idx_k.reshape(B, M), idx_p.reshape(B, M)).max())
    agree = float((idx_k == idx_p).float().mean())
    del out, plain
    print(f"lbs L={L} F={F}: max vertex error {err:.3g} m, joints {err_j:.3g} m, rank agreement "
          f"{agree:.6f}, max tie gap {gap:.3g} m^2", flush=True)
    require(err <= LBS_TOL_M and err_j <= LBS_TOL_M,
            f"lbs: kernel against the plain forward {err:.3g} / {err_j:.3g} m above {LBS_TOL_M}")
    require(agree >= AGREE_MIN, f"lbs: rank agreement {agree} below {AGREE_MIN}")
    require(gap <= TIE_GAP_M2, f"lbs: rank disagreement beyond a tie (gap {gap})")
    torch.cuda.empty_cache()
    with torch.no_grad():
        a = lbs_kernel_args(model, *args)[0]
    ms = time_ms(lambda: LK.lbs_vertices_cuda(*a), 20)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: lbs_forward(model, *args), 10)
        plain_ms = time_ms(lambda: lbs_forward_plain(model, *args), 5, warmup=1)
    t = a[4]
    W = t.joints.shape[1]
    nbytes = sum(x.numel() * 4 for x in a[:4]) + sum(x.numel() * 4 for x in t) + B * V * 12
    b_ms, b_by = bound(nbytes, LK.flop_per_row(V, W) * B)
    print(f"lbs L={L} F={F} ({B} rows, {W} weights a vertex): kernel {ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f} % of it; the kernel-route forward "
          f"{fwd_ms:.4f} ms, the plain forward {plain_ms:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, forward_ms=fwd_ms, agreement=agree)


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
    results["min_sqdist_bwd_part"] = check_backward("part", *backward_inputs(Vp), Vp,
                                                    library=True)
    results["min_sqdist_bwd_partfit"] = check_backward(
        "part fit", *backward_inputs(V, lanes=16), V, library=True)
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
    rounds at ``BATCH_FRAME_STRIDE``, and the repository's checkpoints."""
    from uuo_mocap_tpu_torch.data.config import load_config

    cfg = load_config(os.path.join(HERE, "configs", "video_mocap.yaml"))
    cfg["checkpoints_dir"] = CHECKPOINTS  # the CLI phase runs in another directory
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


def make_batch(model, seed0=BATCH_SEED0, layout="random", camera=None):
    """``bench.py:_make_batch_inner``'s batch through the port's generators:
    sequence q has ground truth seed seed0 + 3q, markers seed0 + 3q + 1 (5 %
    occlusion; 41 at random vertices, or at the named layout's vertices with
    the columns padded to 41), prior seed0 + 3q + 2 (bench.py's noise); with
    ``camera`` (a dict of streams, e.g. REPROJ_CAMERA) the prior carries them
    in every frame.
    -> (ground truths, prepared sequences)."""
    import numpy as np

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
        img = ImgSmpl.from_params(prior)
        for name, value in (camera or {}).items():
            setattr(img, name, np.tile(np.array(value, np.float32), (F_FRAMES, 1)))
        preps.append(prepare_sequence(
            img, ArrayMarkers(markers.points.cpu().numpy()),
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


def stage_digest(out, stage):
    """The digest of every sequence's ``stages[stage]`` parameters."""
    return digest(*(r["stages"][stage][k] for r in out["results"] for k in STAGE_KEYS))


def batch_phase(model, layout="random", mesh=None):
    """``MultiSequenceSolver.solve_prepared`` on one of bench.py's batches:
    the random layout (the main path) or cmu_41, each held to its gates;
    with ``mesh`` the solver runs on that device mesh.
    -> {"counts": launch counts, "mpjpe": per-sequence MPJPE (mm),
    "chamfer_digest": the chamfer-stage snapshot's digest, "best": the
    winning hypotheses, "solve_s"}."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.ops import lbs_kernels as LK
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
    from uuo_mocap_tpu_torch.pipeline.segmentation import segment_rigid

    tag = "batch" if layout == "random" else f"{layout} batch"
    if mesh is not None and mesh.size > 1:
        tag = f"mesh {tag}"
    gates = BATCH_GATES_MM[layout]
    t0 = time.time()
    gts, preps = make_batch(model, layout=layout)
    print(f"{tag}: {BATCH} sequences of {preps[0].M_real} markers made in "
          f"{time.time() - t0:.2f} s; rigid groups per sequence "
          f"{[len(segment_rigid(p.markers[: p.F_real])) for p in preps]}", flush=True)
    solver = (MultiSequenceSolver(model, bench_parallel_config(), device="cuda") if mesh is None
              else MultiSequenceSolver(model, bench_parallel_config(), mesh=mesh))
    if mesh is not None:
        print(f"{tag}: on {mesh}", flush=True)
    per_call = []
    count_stage_launches(solver.part_fitter, ("fit_batch",), per_call)
    count_stage_launches(solver.stages, ("chamfer_stage_lanes", "score_chamfer_lanes",
                                         "nearest_points_lanes_nolabel", "marker_stage_lanes"),
                         per_call)
    K.reset_launch_counts()
    lbs0 = LK.lbs_vertices_cuda.launches
    t0 = time.time()
    out = solver.solve_prepared(preps, save_stages=True)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    counts = K.launch_counts()
    lbs_launches = LK.lbs_vertices_cuda.launches - lbs0
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
    print(f"{tag}: {lbs_launches} dense LBS kernel launches", flush=True)
    require(mesh is not None or lbs_launches > 0, f"{tag}: the dense LBS kernel never launched")
    chamfer_digest = stage_digest(out, "chamfer")
    print(f"{tag} output digest {digest(*(r[k] for r in out['results'] for k in STAGE_KEYS))}, "
          f"chamfer-stage digest {chamfer_digest}", flush=True)
    require_launches(counts, f"the {tag} solve")

    errs = check_batch_results(model, out, gts, preps, tag)
    mean_v, med_v, max_v = float(np.mean(errs)), float(np.median(errs)), float(np.max(errs))
    print(f"{tag} MPJPE per sequence (mm): {[round(e, 3) for e in errs]}; mean {mean_v:.3f}, "
          f"median {med_v:.3f}, max {max_v:.3f} (gates {gates[0]} / {gates[1]} mm)", flush=True)
    require(mean_v <= gates[0] and med_v <= gates[0],
            f"{tag} MPJPE mean {mean_v:.2f} / median {med_v:.2f} mm above {gates[0]} mm")
    require(max_v <= gates[1], f"{tag} MPJPE max {max_v:.2f} mm above {gates[1]} mm")
    return {"counts": counts, "mpjpe": errs, "chamfer_digest": chamfer_digest,
            "evals": out["lbfgs_evals"], "eval_stats": out["eval_stats"],
            "best": out["best_hypothesis"].tolist(), "solve_s": solve_s,
            "lbs_launches": lbs_launches}


MESH_MPJPE_TOL_MM = 2.0  # tests/test_model_axis_parity.py's bound for the same transformation
MESH_TRAIN = dict(batch=BATCH, frames=F_FRAMES, markers=N_MARKERS)
MESH_TRAIN_STEPS = 10


def mesh_phase(model, random):
    """The device mesh on the one card (``parallel/mesh.py``): the random
    batch through ``MultiSequenceSolver(mesh=make_mesh(devices=[cuda:0,
    cuda:0], data=1, model=2))``, the body model cut into two vertex blocks
    of 3445 (every dense forward's min over V runs per block, the rank
    kernel once per block, the combine picks the global argmin).  This
    checks the shard arithmetic with the real kernels, not scaling across
    cards.  Gates: the random batch's gates, its winning hypotheses, and
    each sequence's MPJPE within 2 mm of ``random``'s.  Then
    ``sharded_train_step`` at B x F x M = 4 x 450 x 41 on a 1 x 1 and the 1
    x 2 mesh for MESH_TRAIN_STEPS SGD steps: the losses within rtol 1e-5 of
    each other, and falling.  -> launch counts of the solve and the steps."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.parallel.mesh import (
        make_mesh, make_train_batch, sharded_train_step)

    mesh = make_mesh(devices=["cuda:0", "cuda:0"], data=1, model=2)
    res = batch_phase(model, "random", mesh=mesh)
    diffs = [abs(a - b) for a, b in zip(res["mpjpe"], random["mpjpe"])]
    rank, rank0 = res["counts"]["rank_nearest_cuda"], random["counts"]["rank_nearest_cuda"]
    print(f"mesh: (1, 2) solve {res['solve_s']:.2f} s against {random['solve_s']:.2f} s unsharded; "
          f"best hypotheses {res['best']} (unsharded {random['best']}); MPJPE differences (mm) "
          f"{[round(x, 3) for x in diffs]}; rank launches {rank} at V = 3445 per block against "
          f"{rank0} at V = 6890 unsharded ({rank / max(rank0, 1):.2f}x)", flush=True)
    require(res["best"] == random["best"], f"mesh: best hypotheses {res['best']} != {random['best']}")
    require(max(diffs) <= MESH_MPJPE_TOL_MM,
            f"mesh: MPJPE differs from the unsharded solve by {max(diffs):.3f} mm")

    params, batch = make_train_batch(model, **MESH_TRAIN)
    losses, step_counts = {}, {}
    for name, m in (("1x1", make_mesh(devices=["cuda:0"], data=1, model=1)), ("1x2", mesh)):
        step = sharded_train_step(model, m)
        p, hist = params, []
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(MESH_TRAIN_STEPS):
            p, loss = step(p, batch)
            hist.append(float(loss))
        torch.cuda.synchronize()
        step_counts[name] = K.launch_counts()
        losses[name] = hist
        print(f"mesh: sharded_train_step {name} at {MESH_TRAIN}: {MESH_TRAIN_STEPS} steps "
              f"{time.time() - t0:.3f} s, loss {hist[0]:.6f} -> {hist[-1]:.6f}; launches "
              f"{step_counts[name]}", flush=True)
        require(all(np.isfinite(hist)) and hist[-1] < hist[0], f"mesh: {name} loss did not fall")
        require(step_counts[name]["min_sqdist_forward_cuda"] > 0
                and step_counts[name]["min_sqdist_backward_cuda"] > 0,
                f"mesh: {name} step did not launch the min_sqdist forward and backward kernels")
    gap = float(np.max(np.abs(np.subtract(losses["1x2"], losses["1x1"])) / np.abs(losses["1x1"])))
    print(f"mesh: train-step losses 1x2 against 1x1 within rtol {gap:.2e} (gate 1e-5)", flush=True)
    require(gap <= 1e-5, f"mesh: train-step losses differ by rtol {gap:.2e}")
    print(json.dumps({"mesh_launches": res["counts"], "mesh_train_launches": step_counts["1x2"]}),
          flush=True)
    return {"solve": res["counts"], "train": step_counts["1x2"]}


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
    print(f"{tag} output digest {digest(*(r[k] for r in out['results'] for k in STAGE_KEYS))}",
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


def model_phase(model):
    """The four shipped checkpoints, read by the port's msgpack reader and
    built on the card, and MANIFEST.json's held-out metrics recomputed with
    ``models/heldout.py`` at its counts (4 batches of 8 windows x 41
    markers, random vertices and the cmu_41 layout; n = 2048 surface
    points).  Gates: each accuracy within MANIFEST_ACC_TOL of MANIFEST's,
    the Pos2BC error within POS2BC_ERR_TOL_M of it, the PosDiff reduction
    within POS_DIFF_REDUCTION_TOL; and ``tests/test_demo_checkpoints.py``'s
    quality gates."""
    from uuo_mocap_tpu_torch import convert
    from uuo_mocap_tpu_torch.models import heldout
    from uuo_mocap_tpu_torch.models.checkpoints import load_params

    with open(os.path.join(CHECKPOINTS, "MANIFEST.json")) as f:
        manifest = json.load(f)
    t0 = time.time()
    nets = {name: build(load_params(CHECKPOINTS, name), "cuda") for name, build in (
        ("marker_segmenter", convert.marker_segmenter_from_flax),
        ("marker_segmenter_multimodal", convert.marker_segmenter_multimodal_from_flax),
        ("barycentric_coords/pos2bc", convert.pos2bc_from_flax),
        ("barycentric_coords/pos_diff", convert.pos_diff_from_flax))}
    print(f"model: four checkpoints read and built on the card in {time.time() - t0:.2f} s",
          flush=True)
    t0 = time.time()
    got = {}
    for name in ("marker_segmenter", "marker_segmenter_multimodal"):
        for key, layout in (("held_out_accuracy", None),
                            ("held_out_accuracy_cmu41_layout", "cmu_41")):
            acc = heldout.eval_segmenter(model, nets[name], name.endswith("multimodal"),
                                         layout=layout)
            want = manifest[name][key]
            got[(name, key)] = acc
            print(f"model: {name} {key} {acc:.6f} (MANIFEST {want})", flush=True)
            require(abs(acc - want) <= MANIFEST_ACC_TOL,
                    f"{name} {key} {acc:.4f} not within {MANIFEST_ACC_TOL} of {want}")
    err = heldout.eval_pos2bc(model, nets["barycentric_coords/pos2bc"])
    want = manifest["barycentric_coords/pos2bc"]["held_out_expected_point_err_m"]
    print(f"model: pos2bc expected-point error {err * 1e3:.4f} mm (MANIFEST {want * 1e3} mm)",
          flush=True)
    require(abs(err - want) <= POS2BC_ERR_TOL_M, f"Pos2BC error {err} m not within "
            f"{POS2BC_ERR_TOL_M} m of {want} m")
    after, before = heldout.eval_pos_diff(model, nets["barycentric_coords/pos_diff"])
    red = 1.0 - after / before
    want = manifest["barycentric_coords/pos_diff"]["held_out_dist_reduction"]
    print(f"model: pos_diff surface distance {before * 1e3:.4f} -> {after * 1e3:.4f} mm, "
          f"reduction {red:.6f} (MANIFEST {want})", flush=True)
    require(abs(red - want) <= POS_DIFF_REDUCTION_TOL,
            f"PosDiff reduction {red:.4f} not within {POS_DIFF_REDUCTION_TOL} of {want}")
    # tests/test_demo_checkpoints.py's gates, on the card's numbers
    base = manifest["marker_segmenter"]["majority_class_baseline"]
    require(got[("marker_segmenter", "held_out_accuracy")] >= base + 0.05
            and got[("marker_segmenter", "held_out_accuracy_cmu41_layout")] >= 0.85
            and got[("marker_segmenter_multimodal", "held_out_accuracy")] >= 0.70
            and got[("marker_segmenter_multimodal", "held_out_accuracy_cmu41_layout")] >= 0.95
            and err <= 0.005 and red >= 0.60, "a demo-checkpoint quality gate failed")
    print(f"model: held-out metrics in {time.time() - t0:.2f} s", flush=True)


def generating_vertex_ids(model, seed0=BATCH_SEED0):
    """The generating vertex of every marker of ``make_batch``'s random
    batch, per sequence (the same draws)."""
    from uuo_mocap_tpu_torch.data.synthetic import generate_markers, random_pose_sequence

    out = []
    for q in range(BATCH):
        s = seed0 + 3 * q
        gt = random_pose_sequence(F_FRAMES, seed=s, yaw=0.9, travel=0.5, device="cuda")
        out.append(generate_markers(model, gt, num_markers=N_MARKERS, seed=s + 1,
                                    occlusion_rate=0.05).vertex_ids)
    return out


def network_phase(model, random_mpjpe):
    """The random batch through ``MultiSequenceSolver`` with the batch
    phases' config and ``part.mode: network``: the multimodal segmenter on
    each sequence's prior joints, its largest chain restricting the part
    fit.  Gates: outputs finite and of the reference's shapes; the rank
    kernel and both forward routes launched; every sequence <= 35 mm and the
    mean <= the random batch's mean (``random_mpjpe``, this run) +
    NETWORK_MEAN_MARGIN_MM.  Prints the segmentation's label accuracy
    against the generating vertices' parts, the chains and fit-mask sizes.
    -> launch counts of the solve."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.parallel import batch_solver
    from uuo_mocap_tpu_torch.pipeline.segmentation import merge_symmetric_labels

    tag = "network"
    gts, preps = make_batch(model)
    cfg = bench_parallel_config()
    cfg["stages"]["part"]["mode"] = "network"
    solver = batch_solver.MultiSequenceSolver(model, cfg, device="cuda")
    per_call, segs = [], []
    count_stage_launches(solver.part_fitter, ("fit_batch",), per_call)
    count_stage_launches(solver.stages, ("chamfer_stage_lanes", "score_chamfer_lanes",
                                         "nearest_points_lanes_nolabel", "marker_stage_lanes"),
                         per_call)
    segment = batch_solver.network_segmentation

    def recorded(*args, **kw):
        segs.append(segment(*args, **kw))
        return segs[-1]

    batch_solver.network_segmentation = recorded
    try:
        K.reset_launch_counts()
        t0 = time.time()
        out = solver.solve_prepared(preps, save_stages=True)
        torch.cuda.synchronize()
        solve_s = time.time() - t0
        counts = K.launch_counts()
    finally:
        batch_solver.network_segmentation = segment
    frames = BATCH * F_FRAMES
    print(f"{tag} solve: {solve_s:.2f} s, {frames / solve_s:.3f} frames/s ({frames} frames)",
          flush=True)
    print(f"{tag} stage times (s): {out['stage_times_s']}", flush=True)
    print(f"{tag} L-BFGS evaluations: {out['lbfgs_evals']}; per stage: "
          f"{json.dumps(out['eval_stats'])}", flush=True)
    print(f"{tag} launches per stage call: {per_call}", flush=True)
    print(json.dumps({f"{tag}_launches": counts}), flush=True)
    print(f"{tag} output digest {digest(*(r[k] for r in out['results'] for k in STAGE_KEYS))}",
          flush=True)
    part_of = model.vertex_part_labels().cpu().numpy()
    for q, ((labels, merged, chains), vids) in enumerate(zip(segs, generating_vertex_ids(model))):
        truth = part_of[vids]
        mode = np.apply_along_axis(lambda c: np.bincount(c).argmax(), 0, labels)
        print(f"{tag} sequence {q}: label accuracy per frame "
              f"{float((labels == truth[None]).mean()):.4f}, per-marker mode "
              f"{float((mode == truth).mean()):.4f}, merged "
              f"{float((merged == merge_symmetric_labels(truth)).mean()):.4f}; chains "
              f"{[[int(j) for j in c] for c in chains]}; fit mask "
              f"{int(np.isin(merged, chains[0]).sum())} of {len(merged)} markers; part-fit chain "
              f"{[int(c) for c in out['results'][q]['chain']]}", flush=True)
    require(len(segs) == BATCH, f"{tag}: {len(segs)} segmentations for {BATCH} sequences")
    require_launches(counts, f"the {tag} solve")
    errs = check_batch_results(model, out, gts, preps, tag)
    mean_v, ref_mean = float(np.mean(errs)), float(np.mean(random_mpjpe))
    print(f"{tag} MPJPE per sequence (mm): {[round(e, 3) for e in errs]}; mean {mean_v:.3f} "
          f"(random batch, cluster mode: {ref_mean:.3f}; gates {MPJPE_GATE_MM} mm per sequence, "
          f"mean <= {ref_mean + NETWORK_MEAN_MARGIN_MM:.3f} mm)", flush=True)
    require(max(errs) <= MPJPE_GATE_MM, f"{tag} MPJPE max {max(errs):.2f} mm above "
            f"{MPJPE_GATE_MM} mm")
    require(mean_v <= ref_mean + NETWORK_MEAN_MARGIN_MM,
            f"{tag} MPJPE mean {mean_v:.2f} mm above the random batch's {ref_mean:.2f} mm + "
            f"{NETWORK_MEAN_MARGIN_MM} mm")
    return counts


def sdf_phase(model, random_chamfer_digest):
    """The random batch through ``MultiSequenceSolver`` with the batch
    phases' config and ``marker.use_sdf: true``: both marker stages
    co-optimize the virtual markers through the SDF nets on a dense
    forward.  Gates: the chamfer-stage snapshot's digest equal to the
    random batch's (``random_chamfer_digest``: only the marker stages may
    differ); outputs finite and of the reference's shapes; every sequence
    <= SDF_GATE_MM and the mean <= SDF_MEAN_GATE_MM.  Prints the marker
    stages' times, evaluations and peak device memory.  -> launch counts
    of the solve."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver

    tag = "sdf"
    gts, preps = make_batch(model)
    cfg = bench_parallel_config()
    cfg["stages"]["marker"]["use_sdf"] = True
    solver = MultiSequenceSolver(model, cfg, device="cuda")
    peaks = []
    run = solver.stages.marker_stage_sdf_lanes

    def measured(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        result = run(*args, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks.append((round(time.time() - t0, 3), round(peak / 2**30, 3), round(base / 2**30, 3)))
        return result

    solver.stages.marker_stage_sdf_lanes = measured
    K.reset_launch_counts()
    t0 = time.time()
    out = solver.solve_prepared(preps, save_stages=True)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    counts = K.launch_counts()
    frames = BATCH * F_FRAMES
    print(f"{tag} solve: {solve_s:.2f} s, {frames / solve_s:.3f} frames/s ({frames} frames)",
          flush=True)
    print(f"{tag} stage times (s): {out['stage_times_s']}", flush=True)
    print(f"{tag} L-BFGS evaluations: {out['lbfgs_evals']}; per stage: "
          f"{json.dumps(out['eval_stats'])}", flush=True)
    print(f"{tag} marker stage calls (s, peak GiB, GiB held before): {peaks}", flush=True)
    print(json.dumps({f"{tag}_launches": counts}), flush=True)
    chamfer_digest = stage_digest(out, "chamfer")
    print(f"{tag} output digest {digest(*(r[k] for r in out['results'] for k in STAGE_KEYS))}, "
          f"chamfer-stage digest {chamfer_digest} (random batch {random_chamfer_digest})",
          flush=True)
    require(chamfer_digest == random_chamfer_digest,
            f"{tag}: the chamfer-stage snapshot differs from the random batch's")
    require(len(peaks) == 2, f"{tag}: {len(peaks)} SDF marker stage calls, expected 2")
    require_launches(counts, f"the {tag} solve")
    errs = check_batch_results(model, out, gts, preps, tag)
    per_stage = {}
    for r, gt in zip(out["results"], gts):
        for stage, sd in r["stages"].items():
            sd = dict(sd, betas=sd["betas"][None].repeat(F_FRAMES, 0))
            per_stage.setdefault(stage, []).append(round(mpjpe_mm(model, sd, gt), 3))
    mean_v = float(np.mean(errs))
    print(f"{tag} MPJPE per sequence (mm): {[round(e, 3) for e in errs]}, mean {mean_v:.3f}; "
          f"per stage {per_stage} (gates {SDF_GATE_MM} mm per sequence, mean "
          f"{SDF_MEAN_GATE_MM} mm)", flush=True)
    require(max(errs) <= SDF_GATE_MM, f"{tag} MPJPE max {max(errs):.2f} mm above {SDF_GATE_MM} mm")
    require(mean_v <= SDF_MEAN_GATE_MM,
            f"{tag} MPJPE mean {mean_v:.2f} mm above {SDF_MEAN_GATE_MM} mm")
    return counts


def reprojection_phase(model):
    """The random batch with REPROJ_CAMERA's streams through
    ``MultiSequenceSolver`` with the batch phases' config and both
    reprojection stages on (REPROJ_ITERS iterations over REPROJ_ANGLES yaw
    seeds; lanes = 4 sequences x 4 seeds).  Gates: outputs finite and of the
    reference's shapes; both stages timed; each stage's call launched the
    few-query forward and the backward; every sequence <= 35 mm.  Prints
    per sequence and stage the per-seed metrics, the chosen seed, the
    iterations and evaluations, and a digest per sequence.  Then
    ``reprojection_stage_check``.  -> launch counts of the solve."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
    from uuo_mocap_tpu_torch.pipeline.reprojection import ReprojectionStage

    tag = "reprojection"
    gts, preps = make_batch(model, camera=REPROJ_CAMERA)
    require(all(p.has_camera for p in preps), f"{tag}: a sequence without camera streams")
    cfg = bench_parallel_config()
    for key in ("reprojection_part", "reprojection_full"):
        cfg["stages"][key].update(num_iters=REPROJ_ITERS, num_angles=REPROJ_ANGLES)
    solver = MultiSequenceSolver(model, cfg, device="cuda")
    stage = solver._reproj = ReprojectionStage(model, cfg, "reprojection_part")
    calls = []
    lanes = stage.lanes

    def recorded(*args):
        before, t0 = K.launch_counts(), time.time()
        out = lanes(*args)
        torch.cuda.synchronize()
        after = K.launch_counts()
        calls.append({"s": round(time.time() - t0, 3),
                      "metrics": {k: v.cpu().numpy() for k, v in out["metrics"].items()},
                      "evals": stage.last_result.num_evals.cpu().numpy(),
                      "iters": stage.last_result.num_iters.cpu().numpy(),
                      "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}})
        return out

    stage.lanes = recorded
    K.reset_launch_counts()
    t0 = time.time()
    out = solver.solve_prepared(preps, save_stages=True)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    counts = K.launch_counts()
    frames = BATCH * F_FRAMES
    print(f"{tag} solve: {solve_s:.2f} s, {frames / solve_s:.3f} frames/s ({frames} frames)",
          flush=True)
    print(f"{tag} stage times (s): {out['stage_times_s']}", flush=True)
    print(f"{tag} L-BFGS evaluations: {out['lbfgs_evals']}; per stage: "
          f"{json.dumps(out['eval_stats'])}", flush=True)
    print(json.dumps({f"{tag}_launches": counts}), flush=True)
    require(len(calls) == 2, f"{tag}: {len(calls)} stage calls, expected 2 (one per stage)")
    for name, call in zip(("reprojection_part", "reprojection_full"), calls):
        print(f"{tag} {name}: {call['s']} s, launches {call['launches']}", flush=True)
        require(name in out["stage_times_s"], f"{tag}: {name} not timed")
        for k in ("min_sqdist_forward_cuda", "min_sqdist_backward_cuda"):
            require(call["launches"].get(k, 0) > 0, f"{tag}: {name} never launched {k}")
        met = {k: v.reshape(BATCH, REPROJ_ANGLES) for k, v in call["metrics"].items()}
        for q in range(BATCH):
            lanes_q = slice(q * REPROJ_ANGLES, (q + 1) * REPROJ_ANGLES)
            print(f"{tag} {name} sequence {q}: reproject {met['reproject'][q].tolist()}, chamfer "
                  f"{met['chamfer'][q].tolist()}, chosen seed {int(np.argmin(met['reproject'][q]))}"
                  f", iterations {call['iters'][lanes_q].tolist()}, evaluations "
                  f"{call['evals'][lanes_q].tolist()}", flush=True)
        require(all(np.isfinite(v).all() for v in call["metrics"].values()),
                f"{tag}: {name} metrics not finite")
        print(f"{tag} {name}: iterations per lane {call['iters'].tolist()}, median "
              f"{float(np.median(call['iters']))} (the 0.2 m camera, ROADMAP C.12)", flush=True)
    errs = check_batch_results(model, out, gts, preps, tag)
    for q, r in enumerate(out["results"]):
        print(f"{tag} sequence {q}: MPJPE {errs[q]:.3f} mm, best hypothesis "
              f"{r['best_hypothesis']}, digest {digest(*(r[k] for k in STAGE_KEYS))}", flush=True)
    print(f"{tag} output digest {digest(*(r[k] for r in out['results'] for k in STAGE_KEYS))}",
          flush=True)
    require(max(errs) <= MPJPE_GATE_MM,
            f"{tag} MPJPE max {max(errs):.2f} mm above {MPJPE_GATE_MM} mm")
    reprojection_stage_check(model, cfg)
    return counts


def reprojection_stage_check(model, cfg):
    """The reprojection stage alone (``ReprojectionStage.lanes``, as the
    batch solve's ``_reprojection_lanes`` calls it) on the random batch with
    REPROJ_STAGE_CAMERA's streams, 4.9 m from the body, where it descends:
    lanes = 4 sequences x REPROJ_ANGLES seeds, REPROJ_ITERS iterations.
    Gates: finite metrics and outputs of the stage's shapes; the few-query
    forward and the backward launched; the median lane ran at least
    REPROJ_MIN_MEDIAN_ITERS iterations; every lane ended below its starting
    loss (the same stage at 0 iterations).  Prints the time, the per-lane
    iterations, evaluations and losses."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.ops.geometry import get_marker_mask, median
    from uuo_mocap_tpu_torch.pipeline.reprojection import ReprojectionStage

    tag = "reprojection stage at 4.9 m"
    _, preps = make_batch(model, camera=REPROJ_STAGE_CAMERA)

    def lanes(field):  # [4, ...] -> [4 x REPROJ_ANGLES, ...], sequence-major
        x = torch.as_tensor(np.stack([np.asarray(getattr(p, field), np.float32) for p in preps]),
                            device="cuda")
        return x.repeat_interleave(REPROJ_ANGLES, dim=0)

    markers = lanes("markers")
    angles = torch.arange(REPROJ_ANGLES, device="cuda", dtype=torch.float32).repeat(BATCH) * (
        2 * np.pi / REPROJ_ANGLES)
    args = (angles, markers, get_marker_mask(markers), lanes("o_pose_body"), lanes("o_betas"),
            lanes("hmr_betas"), lanes("hmr_root_orient"), median(markers, dim=2),
            lanes("camera_bbox"), lanes("cam_center"), lanes("cam_size"), lanes("cam_scale"),
            lanes("img_mask"))
    start = ReprojectionStage(model, merge_config(copy.deepcopy(cfg), {"stages": {
        "reprojection_part": {"num_iters": 0}}}), "reprojection_part")
    start.lanes(*args)
    f0 = start.last_result.f  # the starting loss
    stage = ReprojectionStage(model, cfg, "reprojection_part")
    K.reset_launch_counts()
    t0 = time.time()
    out = stage.lanes(*args)
    torch.cuda.synchronize()
    stage_s = time.time() - t0
    counts = K.launch_counts()
    res = stage.last_result
    iters, evals = res.num_iters.cpu().numpy(), res.num_evals.cpu().numpy()
    f1 = res.f.cpu().numpy()
    print(f"{tag}: {stage_s:.2f} s for {len(iters)} lanes x {F_FRAMES} frames, launches "
          f"{json.dumps(counts)}", flush=True)
    print(f"{tag}: iterations per lane {iters.tolist()}, median {float(np.median(iters))}; "
          f"evaluations {evals.tolist()}", flush=True)
    print(f"{tag}: loss per lane at the start {f0.cpu().numpy().tolist()}, at the end "
          f"{f1.tolist()}; reproject {out['metrics']['reproject'].cpu().numpy().tolist()}, chamfer "
          f"{out['metrics']['chamfer'].cpu().numpy().tolist()}", flush=True)
    L = len(iters)
    require(tuple(out["root_orient"].shape) == (L, F_FRAMES, 1, 3, 3)
            and tuple(out["trans"].shape) == (L, F_FRAMES, 3), f"{tag}: output shapes")
    require(all(bool(torch.isfinite(v).all()) for v in
                (out["trans"], out["root_orient"], out["betas"], *out["metrics"].values())),
            f"{tag}: outputs not finite")
    for k in ("min_sqdist_forward_cuda", "min_sqdist_backward_cuda"):
        require(counts.get(k, 0) > 0, f"{tag}: never launched {k}")
    require(float(np.median(iters)) >= REPROJ_MIN_MEDIAN_ITERS,
            f"{tag}: the median lane ran {float(np.median(iters))} iterations, under "
            f"{REPROJ_MIN_MEDIAN_ITERS}")
    require(bool((res.f < f0).all()), f"{tag}: a lane ended at or above its starting loss")


def rank_variant_phase(model, random, gt, markers):
    """The random batch through ``MultiSequenceSolver`` with the batch
    phases' config, ``optimizer.rank_hier`` and ``hypothesis_prune.
    rank_phase1``: the tournament's phase 1 runs the rank-per-iteration
    solver (the rank kernel once per iteration, in the L-BFGS prepare hook),
    phase 2 the coarse-to-fine ranking.  Gates: outputs finite and of the
    reference's shapes; every phase-1 call launched the rank kernel; per
    sequence <= RANK_VARIANT_GATE_MM, the mean <= the random batch's
    (``random``, this run) + RANK_VARIANT_MEAN_MARGIN_MM.  Prints the lane
    evaluations per stage beside the random batch's, and at the first cull's
    shape (16 lanes x 450 frames x 41 markers) the agreement of
    ``hierarchical_nearest`` with the rank kernel (share of equal picks, the
    largest squared-distance gap where they differ) and both times on the
    card.  -> launch counts of the solve."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.ops.rank_hier import hierarchical_nearest, rank_table_for
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver

    tag = "rank variants"
    gts, preps = make_batch(model)
    cfg = bench_parallel_config()
    cfg["optimizer"]["rank_hier"] = True
    cfg["parallel"]["hypothesis_prune"]["rank_phase1"] = True
    solver = MultiSequenceSolver(model, cfg, device="cuda")
    frozen = solver.phase1_solver()
    require(frozen is solver.stages._chamfer_solver_frozen and frozen.prepare is not None,
            f"{tag}: phase 1 does not run the rank-per-iteration solver")
    calls = []
    run = solver.stages.chamfer_stage_lanes

    def recorded(*args, solver=None, **kw):
        before, t0 = K.launch_counts(), time.time()
        out = run(*args, solver=solver, **kw)
        torch.cuda.synchronize()
        after = K.launch_counts()
        calls.append(("phase 1" if solver is frozen else "phase 2", round(time.time() - t0, 3),
                      {k: after[k] - before[k] for k in after if after[k] != before[k]}))
        return out

    solver.stages.chamfer_stage_lanes = recorded
    K.reset_launch_counts()
    t0 = time.time()
    out = solver.solve_prepared(preps, save_stages=True)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    counts = K.launch_counts()
    frames = BATCH * F_FRAMES
    print(f"{tag} solve: {solve_s:.2f} s, {frames / solve_s:.3f} frames/s ({frames} frames)",
          flush=True)
    print(f"{tag} stage times (s): {out['stage_times_s']}", flush=True)
    print(f"{tag} L-BFGS evaluations: {out['lbfgs_evals']} (random batch {random['evals']}); "
          f"per stage: {json.dumps(out['eval_stats'])} (random batch "
          f"{json.dumps(random['eval_stats'])})", flush=True)
    print(f"{tag} chamfer stage calls (phase, s, launches): {calls}", flush=True)
    print(json.dumps({"rank_variant_launches": counts}), flush=True)
    print(f"{tag} output digest {digest(*(r[k] for r in out['results'] for k in STAGE_KEYS))}",
          flush=True)
    phase1 = [c for c in calls if c[0] == "phase 1"]
    require(phase1 and all(c[2].get("rank_nearest_cuda", 0) > 0 for c in phase1),
            f"{tag}: phase 1 did not launch the rank kernel")
    errs = check_batch_results(model, out, gts, preps, tag)
    mean_v, ref_mean = float(np.mean(errs)), float(np.mean(random["mpjpe"]))
    print(f"{tag} MPJPE per sequence (mm): {[round(e, 3) for e in errs]}; mean {mean_v:.3f} "
          f"(random batch {ref_mean:.3f}; gates {RANK_VARIANT_GATE_MM} mm per sequence, mean <= "
          f"{ref_mean + RANK_VARIANT_MEAN_MARGIN_MM:.3f} mm)", flush=True)
    require(max(errs) <= RANK_VARIANT_GATE_MM,
            f"{tag} MPJPE max {max(errs):.2f} mm above {RANK_VARIANT_GATE_MM} mm")
    require(mean_v <= ref_mean + RANK_VARIANT_MEAN_MARGIN_MM,
            f"{tag} MPJPE mean {mean_v:.2f} mm above the random batch's {ref_mean:.2f} mm + "
            f"{RANK_VARIANT_MEAN_MARGIN_MM} mm")

    # the coarse-to-fine ranking against the rank kernel at the first cull's shape
    mk, verts, _ = rank_inputs(model, gt, markers, 16, False)
    L, F, M, V = mk.shape[0], mk.shape[1], mk.shape[2], verts.shape[2]
    table = rank_table_for(model)
    hier = hierarchical_nearest(mk, verts, table)
    dense = K.rank_nearest(mk, verts)
    equal = hier == dense
    gap = pick_gap(mk.reshape(L * F, M, 3), verts.reshape(L * F, V, 3), None,
                   hier.reshape(L * F, M), dense.reshape(L * F, M))
    max_gap = float(gap[~equal.reshape(L * F, M)].max()) if not bool(equal.all()) else 0.0
    hier_ms = time_ms(lambda: hierarchical_nearest(mk, verts, table), iters=5)
    rank_ms = time_ms(lambda: K.rank_nearest(mk, verts), iters=20)
    print(f"{tag}: hierarchical_nearest against the rank kernel at L={L}, F={F}, M={M}, V={V}: "
          f"{float(equal.float().mean()):.6f} of picks equal, largest d2 gap where they differ "
          f"{max_gap:.3e} m^2; {hier_ms:.4f} ms against {rank_ms:.4f} ms (table: "
          f"{table.coarse_ids.shape[0]} centres, {table.cand_ids.shape[1]} candidates per cell, "
          f"top {table.top_p})", flush=True)
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
# the sequential cli.test run's frames, bucketed to 128: a cut depth for the
# time limit (150 until the reprojection and ranking-variant phases came; its
# part tournament took 136 of 210 s there, PERF.md)
CLI_SEQ_FRAMES = 80
QUAL_MAX_FRAMES = 90  # eval.qualitative's default
LAYOUT_TOL_M = 1e-5  # export_marker_layout and posed vertices, the card against the CPU


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


def check_journal(path):
    """An iteration journal ``cli.test --save_iterations`` wrote: read with
    ``pickle`` alone, numpy arrays and Python scalars only, an entry for every
    stage of the shipped config (part, chamfer, marker, marker_final_0) and
    the L-BFGS segments of the last three, every segment's iterations a
    multiple of 50 or its lane's last iteration."""
    import pickle

    import numpy as np

    t0 = time.time()
    with open(path, "rb") as f:
        entries = pickle.load(f)
    load_s = time.time() - t0

    def plain(v):
        if isinstance(v, dict):
            return all(plain(x) for x in v.values())
        if isinstance(v, list):
            return all(plain(x) for x in v)
        return isinstance(v, (np.ndarray, np.generic, int, float, str))

    require(plain(entries), f"{path}: holds other types than numpy arrays and Python scalars")
    for stage in ("part", "chamfer", "marker", "marker_final_0"):
        require(bool(entries.get(stage)), f"{path}: no entry for {stage}")
    summary = {}
    for stage in ("chamfer", "marker", "marker_final_0"):
        segs = entries.get(f"{stage}__segments") or []
        require(bool(segs), f"{path}: no segments for {stage}")
        last = {}
        for seg in segs:
            for lane, it in zip(seg["lanes"].tolist(), seg["iters"].tolist()):
                last[lane] = max(last.get(lane, 0), it)
        for seg in segs:
            for lane, it in zip(seg["lanes"].tolist(), seg["iters"].tolist()):
                require(it % 50 == 0 or it == last[lane],
                        f"{path}: {stage} segment at iteration {it} of lane {lane}")
        summary[stage] = (len(segs), [int(last[k]) for k in sorted(last)])
    print(f"cli: journal {os.path.basename(path)}: {os.path.getsize(path)} bytes, loaded in "
          f"{load_s * 1e3:.1f} ms; entries {sorted(entries)}; segments, last iterations per lane "
          f"{summary}", flush=True)


# the preprocess phase: a raw capture at the size of one CMU-kitchen session
# (5 min at 120 Hz, in mm), one subject's labels prefixed "<subject>:": the
# backpack rig, every marker of the three part lists, head and torso markers
PREPROCESS_SECONDS, PREPROCESS_RATE, PREPROCESS_ZERO_SHARE = 300, 120.0, 0.05
PREPROCESS_SUBJECT, PREPROCESS_SEQ = "S07", "brownie"
PREPROCESS_EXTRA_LABELS = ("LFHD", "RFHD", "LBHD", "RBHD", "C7", "CLAV", "STRN", "RBAK", "RFWT",
                           "RSHO", "LASI", "RASI", "LPSI", "RPSI", "T12")


def preprocess_phase():
    """``cli.preprocess_datasets.run_dataset("cmu_kitchen", remove_backpack=
    True, parts=all three)`` on the raw capture above, at the default 15 s
    windows at 30 Hz, then ``slice_gt_to_windows`` on a 300 s npz.  Host code
    from end to end (numpy and the native c3d parser).  Gates: 20 windows of
    450 frames under ``cmu_kitchen_pilot_rb/mocap/<subject>/`` and under each
    part's ``mocap_parts___<part>/<subject>/``; the labels the subject's minus
    the backpack's (a part's: the table's, in capture order); every window's
    points the raw capture's at ``get_downsampled_indices``, in metres, within
    float32 rounding; the native and the pure-Python parser read the same
    points; 20 ground-truth windows of 450 frames."""
    import tempfile

    import numpy as np

    from uuo_mocap_tpu_torch.cli.preprocess_datasets import run_dataset
    from uuo_mocap_tpu_torch.data import c3d_native
    from uuo_mocap_tpu_torch.data.c3d import read_c3d, write_c3d
    from uuo_mocap_tpu_torch.data.dataset_tables import (CMU_KITCHEN_BACKPACK_LABELS,
                                                        CMU_KITCHEN_BODY_PARTS)
    from uuo_mocap_tpu_torch.data.preprocess import get_downsampled_indices, slice_gt_to_windows

    parts = list(CMU_KITCHEN_BODY_PARTS)
    names = list(dict.fromkeys([*CMU_KITCHEN_BACKPACK_LABELS,
                                *(l for p in parts for l in CMU_KITCHEN_BODY_PARTS[p]),
                                *PREPROCESS_EXTRA_LABELS]))
    F, M = int(PREPROCESS_SECONDS * PREPROCESS_RATE), len(names)
    rng = np.random.RandomState(SEED)
    # markers around a body-sized cloud, drifting smoothly, 5 % of cells zero
    raw = (rng.uniform([-300, -300, 0], [300, 300, 1800], (1, M, 3))
           + np.cumsum(rng.randn(F, 1, 3) * 2.0, axis=0) + rng.randn(F, M, 3) * 0.5).astype(np.float32)
    raw[rng.rand(F, M) < PREPROCESS_ZERO_SHARE] = 0.0
    kept = [i for i, n in enumerate(names) if n not in CMU_KITCHEN_BACKPACK_LABELS]
    t0 = time.time()
    c3d_native.build()  # before the timed run: its first use compiles it
    print(f"preprocess: native c3d library build {time.time() - t0:.2f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_preprocess_") as d:
        src = os.path.join(d, "raw", PREPROCESS_SUBJECT, PREPROCESS_SEQ + ".c3d")
        os.makedirs(os.path.dirname(src))
        t0 = time.time()
        write_c3d(src, raw, rate=PREPROCESS_RATE, units="mm",
                  labels=[f"{PREPROCESS_SUBJECT}:{n}" for n in names])
        write_s = time.time() - t0
        t0 = time.time()
        count = run_dataset("cmu_kitchen", os.path.join(d, "raw"), os.path.join(d, "out"),
                            parts=parts, remove_backpack=True)
        run_s = time.time() - t0
        idx = get_downsampled_indices(F, PREPROCESS_RATE, 30.0)
        want_all = raw[idx].astype(np.float64) / 1000.0  # the exact metres of each kept frame
        win = 15 * 30
        n_win = -(-len(idx) // win)
        require(n_win == 20 and count == 4 * n_win, f"{count} windows written, {len(idx)} frames")
        base = os.path.join(d, "out", "cmu_kitchen_pilot_rb")
        variants = [("mocap", kept)] + [
            (f"mocap_parts___{p}", [i for i in kept if names[i] in CMU_KITCHEN_BODY_PARTS[p]])
            for p in parts]
        parse_s, max_err, n_files = 0.0, 0.0, 0
        for sub, cols in variants:
            files = sorted(os.listdir(os.path.join(base, sub, PREPROCESS_SUBJECT)))
            require(files == [f"{PREPROCESS_SEQ}_{w * win:08d}.c3d" for w in range(n_win)],
                    f"{sub}: files {files[:3]}... ({len(files)})")
            for w, fname in enumerate(files):
                path = os.path.join(base, sub, PREPROCESS_SUBJECT, fname)
                t0 = time.time()
                got = read_c3d(path)  # the native parser
                parse_s += time.time() - t0
                py = read_c3d(path, use_native=False)
                require(np.array_equal(got["points"], py["points"]) and got["labels"] == py["labels"],
                        f"{sub}/{fname}: the native and the Python parser differ")
                require(got["points"].shape == (win, len(cols), 4) and got["rate"] == 30.0,
                        f"{sub}/{fname}: shape {got['points'].shape}, rate {got['rate']}")
                require(got["labels"] == [names[i] for i in cols], f"{sub}/{fname}: labels")
                want = want_all[w * win:(w + 1) * win][:, cols]
                want = np.concatenate([want, np.repeat(want[-1:], win - want.shape[0], 0)])
                err = float(np.abs(got["points"][:, :, :3] - want).max())
                require(err <= 2.0 * float(np.abs(want).max()) * np.finfo(np.float32).eps,
                        f"{sub}/{fname}: points off by {err} m")
                max_err, n_files = max(max_err, err), n_files + 1
        gt = os.path.join(d, "gt.npz")
        np.savez(gt, poses=rng.randn(n_win * win, 72).astype(np.float32),
                 trans=rng.randn(n_win * win, 3).astype(np.float32),
                 betas=rng.randn(10).astype(np.float32), mocap_frame_rate=30.0, gender="neutral")
        t0 = time.time()
        sliced = slice_gt_to_windows(gt, os.path.join(d, "gt_out"), PREPROCESS_SEQ)
        slice_s = time.time() - t0
        require(len(sliced) == n_win, f"{len(sliced)} ground-truth windows")
        for path in sliced:
            z = np.load(path)
            require(z["poses"].shape == (win, 72) and z["trans"].shape == (win, 3), f"{path}: shapes")
    print(f"preprocess: raw capture {F} x {M} at {PREPROCESS_RATE:g} Hz ({raw.nbytes / 2 ** 20:.1f} MiB, "
          f"written in {write_s:.2f} s); run_dataset cmu_kitchen (backpack removed, 3 parts) "
          f"{run_s:.3f} s for {count} windows; native parse {parse_s / n_files * 1e3:.3f} ms per "
          f"window ({n_files} windows); largest point error {max_err:.3g} m; "
          f"slice_gt_to_windows {slice_s:.3f} s ({len(sliced)} windows)", flush=True)
    return {"run_s": run_s, "parse_ms": parse_s / n_files * 1e3, "windows": count}


def tools_checks(d, ds, synth, seqs):
    """The tools around the solve on a solved CLI dataset (``cli_phase``'s
    batch): ``cli.filter`` on one result, ``cli.export_marker_layout`` on
    the card and with ``--cpu_only``, and ``eval.qualitative``'s device half
    for the ground truth and the solve on every sequence, on the card and
    on the CPU.  The renderer (matplotlib) is not called: this machine's
    installation need not have it."""
    import numpy as np

    from uuo_mocap_tpu_torch.cli import export_marker_layout, filter as cli_filter
    from uuo_mocap_tpu_torch.eval import comparisons, qualitative

    out_dir = os.path.join(d, ds, "results", "video_mocap", "s1", f"synthetic_{synth}")
    seq0 = os.path.join(out_dir, f"{seqs[0]}_stageii.npz")
    smooth = os.path.join(d, f"{seqs[0]}_smoothed.npz")
    cli_filter.main(["--input", seq0, "--output", smooth])
    a, b = np.load(seq0), np.load(smooth)
    require(all(a[k].shape == b[k].shape for k in a.files) and sorted(a.files) == sorted(b.files),
            "cli.filter: keys or shapes changed")
    jitter = [float(np.abs(np.diff(z["poses"], axis=0)).mean()) for z in (a, b)]
    require(jitter[1] < jitter[0], f"cli.filter: jitter {jitter[1]} not below {jitter[0]}")

    c3d = os.path.join(d, ds, f"mocap_synthetic___{synth}", "s1", f"{seqs[0]}.c3d")
    no_models = os.path.join(d, "no_body_models")
    res, secs = {}, {}
    for name, extra in (("cuda", []), ("cpu", ["--cpu_only"])):
        t0 = time.time()
        res[name] = export_marker_layout.main(
            ["--markers", c3d, "--smpl", seq0, "--frame", "0", "--body_models", no_models,
             "--output", os.path.join(d, f"layout_{name}.ply"), *extra])
        secs[name] = time.time() - t0
    gpu, cpu = res["cuda"], res["cpu"]
    with open(gpu["path"]) as f:
        header = f.read(400)
    M = gpu["face_index"].shape[0]
    require(f"element vertex {6890 + 6 * M}\n" in header and f"element face {13776 + 8 * M}\n" in header,
            f"export_marker_layout: header {header!r}")
    require(bool(np.isfinite(gpu["distance"]).all()), "export_marker_layout: distances")
    # a marker whose closest point is a vertex or an edge lies on several
    # faces at one distance: the two devices' rounding may pick different
    # ones.  Such a tie attaches to the same point, so a marker passes with
    # the same face or with the same closest point and template position
    same = gpu["face_index"] == cpu["face_index"]
    ties = ~same & (np.abs(gpu["closest_point"] - cpu["closest_point"]).max(-1) <= LAYOUT_TOL_M) \
        & (np.abs(gpu["template_position"] - cpu["template_position"]).max(-1) <= LAYOUT_TOL_M)
    dist_err = float(np.abs(gpu["distance"] - cpu["distance"]).max())
    tie_bary = [float(x) for x in gpu["barycentric"][~same].max(-1)]
    require(float((same | ties).mean()) >= 0.99 and dist_err <= LAYOUT_TOL_M,
            f"export_marker_layout: same face on {int(same.sum())} of {M} markers, ties "
            f"{int(ties.sum())}, distances differ by {dist_err}")
    print(f"tools: cli.filter jitter {jitter[0]:.5f} -> {jitter[1]:.5f} rad; export_marker_layout "
          f"({M} markers) on the card {secs['cuda']:.2f} s, on the CPU {secs['cpu']:.2f} s; same "
          f"face on {int(same.sum())} of {M} markers ({float(same.mean()):.3f}), the other "
          f"{int((~same).sum())} ties at one closest point (largest barycentric weight {tie_bary}); "
          f"distances within {dist_err:.2e} m (largest {float(gpu['distance'].max()) * 1e3:.2f} mm)",
          flush=True)

    models = {name: comparisons.default_model_provider(no_models, device=name)("neutral")
              for name in ("cuda", "cpu")}
    items = list(qualitative.qualitative_items(d, ds, ["moshpp", "video_mocap"], synthetic=synth))
    require(len(items) == 2 * len(seqs), f"eval.qualitative: {len(items)} items")
    worst, secs = 0.0, {"cuda": 0.0, "cpu": 0.0}
    for method, _, seq, pred, _, _ in items:
        verts = {}
        for name, model in models.items():
            t0 = time.time()
            verts[name] = qualitative.posed_vertices(pred, model, QUAL_MAX_FRAMES).cpu().numpy()
            secs[name] += time.time() - t0
        require(verts["cuda"].shape == (QUAL_MAX_FRAMES, 6890, 3)
                and bool(np.isfinite(verts["cuda"]).all()), f"{method}/{seq}: posed vertices")
        err = float(np.abs(verts["cuda"] - verts["cpu"]).max())
        require(err <= LAYOUT_TOL_M, f"{method}/{seq}: card and CPU vertices differ by {err} m")
        worst = max(worst, err)
    print(f"tools: eval.qualitative posed_vertices for {len(items)} (method, sequence) pairs at "
          f"{QUAL_MAX_FRAMES} frames: on the card {secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s, "
          f"largest difference {worst:.2e} m", flush=True)
    print("tools: eval.qualitative's renderer (matplotlib) is not called here: the GPU "
          "machine's installation has no matplotlib", flush=True)


VIS_MODEL_ITERS = 5  # visualize_model's stages: a cut depth, the widths as shipped
VIS_REPROJ_ITERS = 10  # visualize_reprojection's stage: cut from its CLI's 50
VIS_MODEL_CONFIG = """find_best_part_fits: true
stages:
  part:
    num_iters: {n}
  chamfer:
    num_iters: {n}
  marker:
    num_iters: {n}
"""


def vis_checks(d, ds, synth, seqs, journal):
    """The device halves of the vis CLIs (``uuo_mocap_tpu_torch/vis``) on the
    CLI phase's data, on the card and with the CPU: ``visualize_smpl`` and
    ``paper``'s stills on a solved ``*_stageii.npz``, ``visualize_dataset``
    (procedural and ``--structured``), ``visualize_iterations`` on the
    sequential run's journal (posed vertices within 1e-5 m of the CPU),
    ``visualize_segmentation`` on the shipped checkpoints (both nets) and
    ``paper``'s confusion matrix (labels and counts equal),
    ``visualize_reprojection``'s stage at VIS_REPROJ_ITERS iterations
    (finite, the CPU's shapes); then
    ``visualize_model``'s solve on the card, on one CLI sequence with
    VIS_MODEL_ITERS-iteration stages (finite, the reference's keys and
    shapes).  No renderer is called.  -> launch counts of the vis phase."""
    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.eval.comparisons import default_model_provider
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.pipeline.journal import IterationJournal
    from uuo_mocap_tpu_torch.vis import (
        paper, visualize_dataset, visualize_iterations, visualize_model, visualize_reprojection,
        visualize_segmentation, visualize_smpl)

    K.reset_launch_counts()
    secs = {}
    no_models = os.path.join(d, "no_body_models")
    models = {name: default_model_provider(no_models, device=name)("neutral")
              for name in ("cuda", "cpu")}
    npz = os.path.join(d, ds, "results", "video_mocap", "s1", f"synthetic_{synth}",
                       f"{seqs[0]}_stageii.npz")
    entries = IterationJournal.load(journal)
    halves = {
        "visualize_smpl": lambda m: visualize_smpl.smpl_bodies([npz], m),
        "paper.stills_vertices": lambda m: [paper.stills_vertices(npz, m)],
        "visualize_dataset": lambda m: list(visualize_dataset.dataset_sample(m, frames=64)[:2]),
        "visualize_dataset --structured": lambda m: list(
            visualize_dataset.dataset_sample(m, frames=64, structured=True)[:2]),
        "visualize_iterations": lambda m: [v for *_, v in visualize_iterations.replay_vertices(
            entries, m)],
    }
    for name, fn in halves.items():
        out = {}
        for dev, m in models.items():
            torch.cuda.synchronize()
            t0 = time.time()
            out[dev] = fn(m)
            torch.cuda.synchronize()
            secs[dev] = time.time() - t0
        require(len(out["cuda"]) == len(out["cpu"]) > 0, f"vis: {name}: outputs")
        err = 0.0
        for a, b in zip(out["cuda"], out["cpu"]):
            require(a.shape == b.shape and bool(np.isfinite(a).all()), f"vis: {name}: shapes")
            err = max(err, float(np.abs(a - b).max()))
        print(f"vis: {name}: {len(out['cuda'])} arrays {[a.shape for a in out['cuda']][:3]}, card "
              f"{secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s, largest difference {err:.2e} m",
              flush=True)
        require(err <= LAYOUT_TOL_M, f"vis: {name}: card and CPU differ by {err} m")

    for multimodal in (False, True):
        preds = {}
        for dev, m in models.items():
            t0 = time.time()
            net, hist = visualize_segmentation.load_or_train(m, CHECKPOINTS, multimodal)
            require(hist is None, "vis: visualize_segmentation did not load the shipped checkpoint")
            preds[dev] = visualize_segmentation.predict_parts(m, net, multimodal)
            secs[dev] = time.time() - t0
        acc = float((preds["cuda"][1] == preds["cuda"][2][None]).mean())
        print(f"vis: visualize_segmentation{' --multimodal' if multimodal else ''}: per-marker "
              f"accuracy {acc:.3f}, card {secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s", flush=True)
        require(np.array_equal(preds["cuda"][1], preds["cpu"][1]),
                "vis: visualize_segmentation labels differ between the card and the CPU")
    cms = {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        cms[dev] = paper.segmentation_labels(CHECKPOINTS, device=dev)
        secs[dev] = time.time() - t0
    same = all(np.array_equal(a, b) for a, b in zip(cms["cuda"], cms["cpu"]))
    print(f"vis: paper confusion matrix: {int(cms['cuda'][2].sum())} markers, "
          f"{float(np.trace(cms['cuda'][2]) / cms['cuda'][2].sum()):.3f} on the diagonal; card "
          f"{secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s; labels and counts equal: {same}",
          flush=True)
    require(same, "vis: the confusion matrix differs between the card and the CPU")

    outs = {}
    for dev, m in models.items():
        t0 = time.time()
        outs[dev], _ = visualize_reprojection.run_reprojection(m, num_iters=VIS_REPROJ_ITERS)
        secs[dev] = time.time() - t0
    for k in ("joints_2d", "trans", "root_orient"):
        a, b = outs["cuda"][k], outs["cpu"][k]
        require(a.shape == b.shape and bool(np.isfinite(a).all()), f"vis: reprojection {k}")
    print(f"vis: visualize_reprojection stage (4 seeds, {VIS_REPROJ_ITERS} iterations, 30 frames): card "
          f"{secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s; metrics card "
          f"{np.round(outs['cuda']['metrics']['reproject'], 4).tolist()}, CPU "
          f"{np.round(outs['cpu']['metrics']['reproject'], 4).tolist()}", flush=True)

    # visualize_model reads <dataset>/mocap/<subject>/<sequence>.c3d
    mocap = os.path.join(d, ds, "mocap")
    if not os.path.exists(mocap):
        os.symlink(os.path.join(d, ds, f"mocap_synthetic___{synth}"), mocap)
    cfg = os.path.join(d, "vis_model.yaml")
    with open(cfg, "w") as f:
        f.write(f"parent: {os.path.join(HERE, 'configs', 'video_mocap.yaml')}\n"
                f"checkpoints_dir: {CHECKPOINTS}\n" + VIS_MODEL_CONFIG.format(n=VIS_MODEL_ITERS))
    args = visualize_model.build_parser().parse_args(
        ["--config", cfg, "--dataset", ds, "--input_dir", d, "--subject", "s1", "--sequence",
         seqs[0], "--show_hmr", "--body_models", no_models])
    before = K.launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    solved = visualize_model.solve_sequence(args, models["cuda"])
    torch.cuda.synchronize()
    model_s = time.time() - t0
    after = K.launch_counts()
    res = solved["result"]
    F, M = solved["points"].shape[:2]
    shapes = {"trans": (F, 3), "root_orient": (F, 1, 3, 3), "pose_body": (F, 23, 3, 3),
              "betas": (F, 10), "markers_labels": (F, M)}
    for k, shp in shapes.items():
        require(res[k].shape == shp and bool(np.isfinite(res[k]).all()),
                f"vis: visualize_model {k} shape {res[k].shape} or not finite")
    require({"stages", "chain"} <= set(res) and solved["verts"].shape == (F, 6890, 3)
            and solved["hmr_verts"].shape == (F, 6890, 3) and bool(np.isfinite(solved["verts"]).all()),
            "vis: visualize_model's outputs")
    solve_launches = {k: after[k] - before[k] for k in after}
    print(f"vis: visualize_model solve on the card, {F} x {M}, {VIS_MODEL_ITERS}-iteration stages: "
          f"{model_s:.2f} s, stages {sorted(res['stages'])}, launches {solve_launches}", flush=True)
    require(solve_launches["rank_nearest_cuda"] > 0 and solve_launches["min_sqdist_forward_cuda"] > 0,
            "vis: visualize_model's solve did not launch the rank and forward kernels")
    counts = K.launch_counts()
    print(json.dumps({"vis_launches": counts}), flush=True)
    return counts


def cli_phase():
    """The user's entry points, in process, in a temporary directory: the
    synthetic export, ``cli.test --batch 4`` (bench.py's parallel settings
    at frame stride 1) on 4 x 450 x 41, ``cli.test`` sequential on one
    CLI_SEQ_FRAMES x 41 sequence, and ``eval.comparisons`` on both.  -> launch
    counts."""
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
                        *yaml_lines({k: bench_parallel_config()[k]
                                     for k in ("parallel", "checkpoints_dir")})]) + "\n"
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
            journal_dir = os.path.join(d, "iterations")
            runs = (("cli_batch", [f"seq_{i:03d}" for i in range(BATCH)], F_FRAMES, 0,
                     ["--batch", str(BATCH)]),
                    ("cli_seq", ["seq_000"], CLI_SEQ_FRAMES, 10,
                     ["--save_iterations", journal_dir]))
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
                if ds == "cli_batch":
                    tools_checks(d, ds, synth, seqs)
                if "--save_iterations" in extra:
                    for seq in seqs:
                        check_journal(os.path.join(journal_dir, f"s1_{seq}_iterations.pkl"))
            counts = K.launch_counts()
            t0 = time.time()
            vis_counts = vis_checks(d, "cli_batch", f"0_{N_MARKERS}", runs[0][1],
                                    os.path.join(journal_dir, "s1_seq_000_iterations.pkl"))
            print(f"vis phase: {time.time() - t0:.1f} s", flush=True)
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    print(json.dumps({"cli_launches": counts}), flush=True)
    require_launches(counts, "the CLI phase")
    return counts, vis_counts


# the training phase: checkpoints/MANIFEST.json's recipe (tools/
# train_demo_checkpoints.py: 6000 steps at latent 128, the segmenters at batch
# 32, Pos2BC and PosDiff at their own batch of 512, PosDiff on a pool of
# 65536), and the CLI's defaults (300 steps, batch 8) for the two families
# MANIFEST does not record.  The gates are tests/test_demo_checkpoints.py's
# and, for the motion embedding, tests/test_models.py's margin below chance
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LATENT, POS_DIFF_POOL = 6000, 32, 128, 65536
CLI_TRAIN_STEPS, CLI_TRAIN_BATCH = 300, 8
EMBEDDING_MARGIN = 0.05  # below ln(batch): 2.0 against ln 8 = 2.079


def training_phase(model):
    """Trains the six model families on the card into a temporary directory
    (never ``checkpoints/``, which the model phase reads): the four that
    MANIFEST.json records through ``models/train.py`` at its recipe, each
    saved with ``save_params`` (Pos2BC in float16, as the demo tool stores
    it), and the motion embedding and foot-contact nets through the entry
    point, ``cli.train.main``, at its defaults.  Every file is read back with
    ``load_params`` and ``convert.py``; the four are scored by
    ``models/heldout.py``.  Gates: every loss finite; unimodal accuracy >=
    MANIFEST's majority baseline + 0.05 and cmu_41-layout accuracy >= 0.85;
    multimodal >= 0.70 and >= 0.95; Pos2BC <= 5 mm; PosDiff reduction >=
    0.60; the motion embedding's mean loss over its last 5 history entries
    < ln(batch) - EMBEDDING_MARGIN; the foot-contact loss ending below its
    start; the CLI's nets finite on a motion.  Prints each family's steps per
    second, wall time, first and last loss, and the gap to MANIFEST's
    figures."""
    import math
    import tempfile

    import numpy as np
    import torch

    from uuo_mocap_tpu_torch import convert
    from uuo_mocap_tpu_torch.body.model import lbs_forward
    from uuo_mocap_tpu_torch.cli import train as cli_train
    from uuo_mocap_tpu_torch.data.synthetic import random_pose_sequence
    from uuo_mocap_tpu_torch.models import heldout
    from uuo_mocap_tpu_torch.models import train as T
    from uuo_mocap_tpu_torch.models.checkpoints import load_params, save_params

    with open(os.path.join(CHECKPOINTS, "MANIFEST.json")) as f:
        manifest = json.load(f)
    recipe = dict(steps=TRAIN_STEPS)
    seg = dict(recipe, batch=TRAIN_BATCH, latent_dim=TRAIN_LATENT)
    runs = (("marker_segmenter", lambda: T.train_marker_segmenter(model, **seg), np.float32),
            ("marker_segmenter_multimodal",
             lambda: T.train_marker_segmenter_multimodal(model, **seg), np.float32),
            ("barycentric_coords/pos2bc", lambda: T.train_pos2bc(model, **recipe), np.float16),
            ("barycentric_coords/pos_diff",
             lambda: T.train_pos_diff(model, pool_n=POS_DIFF_POOL, **recipe), np.float32))

    def cast(tree, dtype):
        if isinstance(tree, dict):
            return {k: cast(v, dtype) for k, v in tree.items()}
        return tree.astype(dtype)

    def report(name, hist, wall, steps):
        require(len(hist) > 0 and all(math.isfinite(h) for h in hist), f"{name}: loss not finite")
        print(f"train: {name}: {steps} steps in {wall:.1f} s ({steps / wall:.1f} steps/s), "
              f"loss {hist[0]:.4f} -> {hist[-1]:.4f} ({len(hist)} history entries)", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        for name, train, dtype in runs:
            torch.cuda.synchronize()
            t0 = time.time()
            net, hist = train()
            torch.cuda.synchronize()
            report(name, hist, time.time() - t0, TRAIN_STEPS)
            save_params(cast(convert.to_flax(net), dtype), root, name)
            want = manifest[name].get("final_train_loss")
            print(f"train: {name}: last loss {hist[-1]:.4f} (MANIFEST {want})", flush=True)
        nets = {name: build(load_params(root, name), "cuda") for name, build in (
            ("marker_segmenter", convert.marker_segmenter_from_flax),
            ("marker_segmenter_multimodal", convert.marker_segmenter_multimodal_from_flax),
            ("barycentric_coords/pos2bc", convert.pos2bc_from_flax),
            ("barycentric_coords/pos_diff", convert.pos_diff_from_flax))}
        base = manifest["marker_segmenter"]["majority_class_baseline"]
        floors = {("marker_segmenter", None): base + 0.05,
                  ("marker_segmenter", "cmu_41"): 0.85,
                  ("marker_segmenter_multimodal", None): 0.70,
                  ("marker_segmenter_multimodal", "cmu_41"): 0.95}
        for (name, layout), floor in floors.items():
            key = "held_out_accuracy_cmu41_layout" if layout else "held_out_accuracy"
            acc = heldout.eval_segmenter(model, nets[name], name.endswith("multimodal"),
                                         layout=layout)
            want = manifest[name][key]
            print(f"train: {name} {key} {acc:.4f} (gate >= {floor:.4f}; MANIFEST {want}, "
                  f"gap {acc - want:+.4f})", flush=True)
            require(acc >= floor, f"trained {name} {key} {acc:.4f} below {floor:.4f}")
        err = heldout.eval_pos2bc(model, nets["barycentric_coords/pos2bc"])
        want = manifest["barycentric_coords/pos2bc"]["held_out_expected_point_err_m"]
        print(f"train: pos2bc expected-point error {err * 1e3:.3f} mm (gate <= 5 mm; MANIFEST "
              f"{want * 1e3} mm, gap {(err - want) * 1e3:+.3f} mm)", flush=True)
        require(err <= 0.005, f"trained Pos2BC error {err * 1e3:.3f} mm above 5 mm")
        after, before = heldout.eval_pos_diff(model, nets["barycentric_coords/pos_diff"])
        red = 1.0 - after / before
        want = manifest["barycentric_coords/pos_diff"]["held_out_dist_reduction"]
        print(f"train: pos_diff surface distance {before * 1e3:.3f} -> {after * 1e3:.3f} mm, "
              f"reduction {red:.4f} (gate >= 0.60; MANIFEST {want}, gap {red - want:+.4f})",
              flush=True)
        require(red >= 0.60, f"trained PosDiff reduction {red:.4f} below 0.60")

        hists = {}
        for name in ("motion_embedding", "foot_contact"):
            torch.cuda.synchronize()
            t0 = time.time()
            hists.update(cli_train.main([
                "--models", name, "--steps", str(CLI_TRAIN_STEPS), "--batch", str(CLI_TRAIN_BATCH),
                "--checkpoints", root, "--body_models", os.path.join(root, "no_body_models")]))
            torch.cuda.synchronize()
            report(f"cli.train {name}", hists[name], time.time() - t0, CLI_TRAIN_STEPS)
        me = hists["motion_embedding"]
        chance = math.log(CLI_TRAIN_BATCH)
        tail = float(np.mean(me[-5:]))
        print(f"train: motion_embedding mean of the last 5 losses {tail:.4f} (gate < "
              f"{chance - EMBEDDING_MARGIN:.4f}, ln {CLI_TRAIN_BATCH} = {chance:.4f})", flush=True)
        require(tail < chance - EMBEDDING_MARGIN, "the motion embedding stayed at chance")
        fc = hists["foot_contact"]
        require(fc[-1] < fc[0], f"foot contact loss {fc[0]:.4f} -> {fc[-1]:.4f} did not fall")
        gt = random_pose_sequence(64, seed=heldout.HELD_OUT_SEED, device="cuda")
        with torch.no_grad():
            joints = lbs_forward(model, gt.pose_body, gt.betas, gt.root_orient,
                                 gt.trans)["joints"][None, :, :22]
            m_net = convert.motion_embedding_from_flax(
                load_params(root, "motion_embedding/markers"), "cuda")
            j_net = convert.motion_embedding_from_flax(
                load_params(root, "motion_embedding/joints"), "cuda", joints=True)
            fc_net = convert.foot_contact_from_flax(load_params(root, "foot_contact"), "cuda")
            emb = torch.cat([m_net(joints[:, :16]), j_net(joints[:, :16])])
            logits = fc_net(joints)
        require(bool(torch.isfinite(emb).all() and torch.isfinite(logits).all())
                and emb.shape == (2, 32) and logits.shape == (1, 64, 2),
                "the CLI's checkpoints do not read back to finite nets of the right shapes")
        require(bool(torch.allclose(emb.norm(dim=-1), torch.ones(2, device="cuda"), atol=1e-5)),
                "the read-back embeddings are not unit vectors")


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K
    from uuo_mocap_tpu_torch.ops import lbs_kernels as LK

    t_start = time.time()
    line = gpu_line()
    print(f"gpu: {line}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    K.build()
    print(f"kernel build: {time.time() - t0:.2f} s ({K._Library.path})", flush=True)
    t0 = time.time()
    LK.build()
    print(f"lbs kernel build: {time.time() - t0:.2f} s ({LK._Library.path})", flush=True)
    lbs_usage = K.ptxas_usage(LK._Library.log)
    for u in lbs_usage:
        print(f"  ptxas: {u['kernel']}: {u['registers']} registers, spill stores "
              f"{u['spill_stores']} B, spill loads {u['spill_loads']} B")
    require(len(lbs_usage) == 1 and lbs_usage[0]["spill_stores"] == 0
            and lbs_usage[0]["spill_loads"] == 0, "the lbs kernel spills or is not listed once")
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
    lres = lbs_check(model, gt, markers)
    random = batch_phase(model)  # the main path
    from uuo_mocap_tpu_torch.parallel.mesh import make_mesh

    batch_phase(model, "cmu_41", mesh=make_mesh())  # the visible card: a 1 x 1 mesh
    t0 = time.time()
    mesh_launches = mesh_phase(model, random)
    print(f"mesh phase: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    launches = full_surface_phase(model)  # every kernel; the counts of the kernels line
    print(f"full_surface phase: {time.time() - t0:.1f} s", flush=True)
    for name, phase, args in (("model", model_phase, ()),
                              ("network", network_phase, (random["mpjpe"],)),
                              ("sdf", sdf_phase, (random["chamfer_digest"],)),
                              ("reprojection", reprojection_phase, ()),
                              ("rank_variant", rank_variant_phase, (random, gt, markers))):
        t0 = time.time()
        phase(model, *args)
        print(f"{name} phase: {time.time() - t0:.1f} s", flush=True)
    path_phase(model, gt, markers, prior)
    t0 = time.time()
    preprocess_phase()
    print(f"preprocess phase: {time.time() - t0:.1f} s", flush=True)
    cli_phase()
    t0 = time.time()
    training_phase(model)
    print(f"training phase: {time.time() - t0:.1f} s", flush=True)
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
        dict(name="lbs_vertices", route="cuda", source="uuo_mocap_tpu_torch/csrc/lbs.cu",
             replaces="none (the dense forward's GEMMs and broadcasts)",
             launches=random["lbs_launches"], **lres),
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
