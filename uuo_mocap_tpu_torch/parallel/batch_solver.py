"""Multi-sequence batch solve (counterpart of
``uuo_mocap_tpu/parallel/batch_solver.py``).

Sequences, yaw hypotheses and candidate subtrees are lanes of the same
closures the single-sequence solve runs (per-sequence tensors move from
``shared`` into ``lane``, ``stages._data``):

  * part fit:   lanes = sequence x candidate subtree (``PartFitter.fit_batch``)
  * chamfer:    lanes = sequence x yaw hypothesis, with the opt-in
                ``hypothesis_prune`` tournament cascade
  * marker IK:  lanes = sequence x surviving hypothesis
  * refinement: lanes = sequence

Lane widths (``config["parallel"]``): the stage solvers run a working set of
``lane_width`` lanes (default 16) and stream any number of lanes through it
with refill-on-retire (``solver/lbfgs.py``); ``part_lane_width`` does the
same for the part fit.  On the H100 the width has no crash to avoid (the
reference's 16 comes from a TPU worker crash); it is kept so that both
packages run the same lane schedule.

Betas stay shared per lane, [Ln, 1, 10], as in the paper.  The reference's
``upsample_lane_params`` (``batch_solver.py:68-81``) broadcasts the shared
betas to [Ln, F, 10] when a frame-strided tournament round hands over to a
full-frame one, and the later stages then fit per-frame betas.  The port
upsamples only the axes that carry the strided frames (pose, root, trans)
and never touches betas, so the output betas are the same in every frame
under any ``frame_stride``.

With ``save_stages`` each sequence's ``stages`` dict holds the part fit's
own result under ``part`` and the root stage's under ``root``, as the
single-sequence solve writes them; the reference's batch solve writes no
``root`` entry and files the root stage's result under ``part``.

The reprojection stages run as sequence x yaw-seed lanes
(``_reprojection_lanes``) on the camera streams ``prepare_sequence``
carries; a sequence without them raises ``ValueError`` when the config
turns the stages on.  Under ``hypothesis_prune.rank_phase1`` the
tournament's phase 1 descends with the rank-per-iteration chamfer solver.

With ``mesh`` (``parallel/mesh.py:make_mesh``, a (data, model) grid of
devices driven from this process) the model axis cuts the body model by
vertex (``ShardedBodyModel``: every dense forward's min over V runs per
block and combines across them, the gathered forward reads each vertex
from its block) and the data axis splits every stage closure's lanes in
contiguous blocks (``split_closure``), the L-BFGS state staying on the
grid's first device; the scoring and correspondence passes run on that
device.  A 1 x 1 grid on the model's device is the unsharded solve.  On
one card a grid may name it twice (``make_mesh(devices=["cuda:0",
"cuda:0"], data=1, model=2)``); on the CPU, ``devices=["cpu"] * n``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel
from uuo_mocap_tpu_torch.device import resolve_device
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.ops.geometry import (
    get_aabb, get_aabb_volume, get_marker_mask, median, upsample_frames)
from uuo_mocap_tpu_torch.ops.sharded import dense
from uuo_mocap_tpu_torch.parallel.mesh import (
    DeviceMesh, _norm_device, _shard_model_by_vertex, split_closure)
from uuo_mocap_tpu_torch.pipeline.multimodal import (
    PreparedSequence, _mode_per_column, _numpy, _params_to_stage_dict, network_segmentation)
from uuo_mocap_tpu_torch.pipeline.part_fit import PartFitter, _prune_rounds
from uuo_mocap_tpu_torch.pipeline.reprojection import ReprojectionStage
from uuo_mocap_tpu_torch.pipeline.segmentation import filter_rigid, segment_rigid
from uuo_mocap_tpu_torch.pipeline.stages import SmplParams, SolveStages, _forward
from uuo_mocap_tpu_torch.utils.tracing import spanned, stage, sync


def _tree_map(fn, *trees):
    """``fn`` over tensors, or leaf by leaf over NamedTuples and dicts of
    them."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return type(trees[0])(*(_tree_map(fn, *leaves) for leaves in zip(*trees)))


def _lane_count(tree) -> int:
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


def chunked_lanes(fn, width: Optional[int], *args):
    """Run a lane function on ``width`` lanes at a time and concatenate
    (``batch_solver.py:51-65``).  The reference pads the last chunk to
    keep one compiled shape; nothing is compiled per shape here, so the last
    chunk runs as it is."""
    L = _lane_count(args[0])
    if not width or L <= int(width):
        return fn(*args)
    outs = [fn(*(_tree_map(lambda a: a[s:s + int(width)], arg) for arg in args))
            for s in range(0, L, int(width))]
    return _tree_map(lambda *cs: torch.cat(cs), *outs)


def upsample_lane_params(params: SmplParams, F_full: int, stride: int) -> SmplParams:
    """Warm start of a full-frame round from a frame-strided one: linear
    interpolation of trans, blend and re-orthonormalization of rotations
    (``batch_solver.py:68-81``).  Betas [Ln, 1, 10] are shared by the frames
    and pass through unchanged (see the module docstring)."""
    return SmplParams(
        pose_body=rot.normalize_rotation(upsample_frames(params.pose_body, F_full, stride)),
        betas=params.betas,
        root_orient=rot.normalize_rotation(upsample_frames(params.root_orient, F_full, stride)),
        trans=upsample_frames(params.trans, F_full, stride),
    )


class MultiSequenceSolver:
    """Solve a batch of same-shape sequences: the staged pipeline with
    sequences, hypotheses and subtrees as lanes of shared closures.  The
    model must live on ``device`` (default: the mesh's first device, else
    the card); with ``mesh`` it is placed on the grid (module docstring)."""

    def __init__(self, model: BodyModel, config: Dict[str, Any],
                 mesh: Optional[DeviceMesh] = None, device=None):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a parallel.mesh.DeviceMesh (make_mesh), "
                            f"not {type(mesh).__name__}")
        if mesh is not None and device is None:
            device = mesh.devices[0, 0]
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, the solve runs on {self.device}")
        self.mesh = None  # a grid other than 1 x 1 on the model's device
        if mesh is not None and (mesh.size > 1 or _norm_device(model.device)
                                 != _norm_device(mesh.devices[0, 0])):
            if _norm_device(mesh.devices[0, 0]) != _norm_device(self.device):
                raise ValueError(f"the solve runs on {self.device}, the mesh's first device "
                                 f"is {mesh.devices[0, 0]}")
            self.mesh = mesh
            model = _shard_model_by_vertex(model, mesh)
        self.model = model
        self.config = config
        self.stages = SolveStages(model, config)
        self.part_fitter = PartFitter(model, config)
        pcfg = config.get("parallel") or {}
        self.lane_width = int(pcfg.get("lane_width", 16))
        self._pad_width = bool(pcfg.get("pad_width", False))
        self.use_sdf = bool(config["stages"]["marker"].get("use_sdf"))
        # the marker stage's solver: under use_sdf the SDF nets load here
        self.marker_solver = (self.stages._marker_solver_sdf if self.use_sdf
                              else self.stages._marker_solver)
        for solver in (self.stages._chamfer_solver, self.marker_solver, self.stages._root_solver):
            self._configure_solver(solver)
        self.prune_cfg = dict(pcfg.get("hypothesis_prune") or {})
        self._reproj = None  # the reprojection stage, built on first use
        part_w = int(pcfg.get("part_lane_width", 16))
        if part_w:
            self.part_fitter._solver.max_width = part_w
            self.part_fitter._solver.pad_width = self._pad_width
        self._split_lanes(self.part_fitter._solver)

    @staticmethod
    def _seed_roots(angles: torch.Tensor, root_seed: torch.Tensor) -> torch.Tensor:
        """Yaw-hypothesis roots: angles [A], root_seed [Q, F, 1, 3, 3] ->
        [Q, A, F, 1, 3, 3] (``batch_solver.py:174-187``)."""
        Q, F = root_seed.shape[:2]
        A = angles.shape[0]
        yaw = rot.rot_z(angles[None, :, None, None, None].expand(Q, A, F, 1, 1))
        return rot.normalize_rotation(yaw @ root_seed[:, None])

    def _configure_solver(self, solver) -> None:
        """Apply the sweep's lane width and padding, and the mesh's data
        axis, to a stage solver."""
        if self.lane_width:
            solver.max_width = int(self.lane_width)
            solver.pad_width = self._pad_width
        self._split_lanes(solver)

    def _split_lanes(self, solver) -> None:
        """Split a stage solver's closure (and its prepare hook) over the
        mesh's data axis, once."""
        if self.mesh is None or getattr(solver, "_mesh_split", False):
            return
        solver.fun = split_closure(solver.fun, self.mesh, self.model)
        if solver.prepare is not None:
            solver.prepare = split_closure(solver.prepare, self.mesh, self.model)
        solver._mesh_split = True

    def phase1_solver(self):
        """The chamfer solver of the hypothesis tournament's phase 1
        (``batch_solver.py:506-514``): the rank-per-iteration one under
        ``hypothesis_prune.rank_phase1``, unless ``optimizer.
        rank_per_iteration`` already makes the stage's own solver freeze
        its ranking; phase 2 always runs the stage's own solver."""
        if (self.prune_cfg.get("rank_phase1")
                and not self.config["optimizer"].get("rank_per_iteration", False)):
            solver = self.stages._chamfer_solver_frozen
            self._configure_solver(solver)
            return solver
        return self.stages._chamfer_solver

    # ------------------------------------------------------------- full sweep
    @spanned("solve")
    def solve_prepared(self, preps: List[PreparedSequence], print_options: List[str] = (),
                       save_stages: bool = False) -> Dict[str, Any]:
        """Full-pipeline batch solve of Q prepared sequences
        (``batch_solver.py:206-751``): the same stage schedule as
        ``multimodal_video_mocap``, with lanes instead of loops.  Every prep
        must share the padded shapes [F, M]
        (``prepare_sequence(pad_to_frames=, pad_to_markers=)``).

        Returns {"results": [per-sequence output dict of numpy arrays],
        "lbfgs_evals", "solve_time_s", "stage_times_s", "eval_stats",
        "scores" [Q, A_eff], "best_hypothesis" [Q]}."""
        t_start = time.time()
        cfg = self.config
        do_reproj_part = (cfg["find_best_part_fits"]
                          and cfg["stages"]["reprojection_part"]["num_iters"] > 0)
        do_reproj_full = cfg["stages"]["reprojection_full"]["num_iters"] > 0
        if (do_reproj_part or do_reproj_full) and not all(p.has_camera for p in preps):
            raise ValueError(
                "reprojection stages need HMR camera streams; prepare_sequence found none on at "
                "least one sequence (synthetic ImgSmpl priors carry no camera data)")
        model, stages, dev = self.model, self.stages, self.device
        progress = "progress" in print_options
        Q = len(preps)
        F = preps[0].F
        M = preps[0].markers.shape[1]
        for p in preps:
            if p.F != F or p.markers.shape[1] != M:
                raise ValueError(
                    f"batch shapes differ: ({p.F},{p.markers.shape[1]}) vs ({F},{M}); "
                    "pass pad_to_frames/pad_to_markers to prepare_sequence")

        stage_times: Dict[str, float] = {}
        eval_stats: Dict[str, Dict[str, int]] = {}

        def grab_stats(name, solver):
            st = dict(solver.last_run_stats)
            if name not in eval_stats:
                eval_stats[name] = st
                return
            cur = eval_stats[name]
            for k, v in st.items():  # width and lanes are shapes, not sums
                cur[k] = v if k in ("width", "lanes") else cur.get(k, 0) + v

        def timed(name):
            return stage(name, stage_times, dev)

        def log(msg):
            if progress:
                print(msg)

        def stack(field):
            return torch.as_tensor(np.stack([np.asarray(getattr(p, field), np.float32)
                                             for p in preps]), device=dev)

        markers_b = stack("markers")  # [Q, F, M, 3]
        weights_b = get_marker_mask(markers_b)
        img_mask_b, frame_valid_b = stack("img_mask"), stack("frame_valid")
        o_pose_b, o_root_b = stack("o_pose_body"), stack("o_root_orient")
        o_betas_b, o_fc_b = stack("o_betas"), stack("o_foot_contacts")
        total_evals = 0

        # ---- segmentation per sequence, on its real frames: rigid clustering
        #      on the host, or the learned segmenter, whose largest chain
        #      restricts that sequence's part fit
        marker_labels_b = np.zeros((Q, F, M), np.int64)
        fit_mask_b = None  # [Q, M], network mode
        if cfg["stages"]["part"].get("mode", "cluster") == "network":
            log(f"Batch[{Q}]: network segmentation...")
            fit_mask_b = np.zeros((Q, M), np.float32)
            num_fit_groups = []
            with timed("segment_network"):
                for q, p in enumerate(preps):
                    marker_labels_b[q], merged, chains_q = network_segmentation(
                        model, p, cfg.get("checkpoints_dir", "./checkpoints"))
                    num_fit_groups.append(len(chains_q[0]))
                    fit_mask_b[q] = np.isin(merged, chains_q[0])
        else:
            log(f"Batch[{Q}]: rigid segmentation...")
            with timed("segment_rigid"):
                groups_per_seq = [segment_rigid(np.asarray(p.markers[: p.F_real])) for p in preps]
            for q, groups in enumerate(groups_per_seq):
                for gi, group in enumerate(groups):
                    marker_labels_b[q, :, group] = gi
            num_fit_groups = [len(g) for g in groups_per_seq]

        # ---- AABB part-vs-full heuristic per sequence, real frames only
        with timed("aabb"), torch.no_grad():
            mean_vertices = dense(_forward(model, SmplParams(
                o_pose_b.reshape(Q * F, 23, 3, 3), torch.zeros((1, 10), device=dev),
                o_root_b.reshape(Q * F, 1, 3, 3), torch.zeros((Q * F, 3), device=dev),
            ))["vertices"]).reshape(Q, F, -1, 3)
            aabb_ratios = np.asarray([
                sync(float, median(get_aabb_volume(get_aabb(markers_b[q, : p.F_real]))
                                   / get_aabb_volume(get_aabb(mean_vertices[q, : p.F_real])),
                                   dim=0))
                for q, p in enumerate(preps)])
            del mean_vertices

        # ---- camera-aware alignment before the part fit, lanes = sequence x
        #      yaw seed; its best seed's betas and root replace the prior's
        if do_reproj_part:
            log(f"Batch[{Q}]: reprojection_part (lanes = sequence x angle)...")
            criterion = cfg["stages"]["reprojection_part"].get("criterion", "reprojection")
            with timed("reprojection_part"):
                o_betas_b, o_root_b, _ = self._reprojection_lanes(
                    preps, int(cfg["stages"]["reprojection_part"]["num_angles"]),
                    "reproject" if criterion == "reprojection" else "chamfer", markers_b,
                    weights_b, o_pose_b, o_betas_b, median(markers_b, dim=2), img_mask_b)

        # ---- part fit, every sequence's subtree search in one lane batch
        trans_seed = median(markers_b, dim=2)  # [Q, F, 3]
        root_seed, betas_seed = o_root_b, o_betas_b
        chains: List[Optional[np.ndarray]] = [None] * Q
        if cfg["find_best_part_fits"]:
            log(f"Batch[{Q}]: part fit (lanes = sequence x subtree)...")
            fit_weights = torch.ones_like(weights_b) * frame_valid_b[:, :, None]
            if fit_mask_b is not None:  # network mode: only the chain's markers
                fit_weights = fit_weights * torch.as_tensor(fit_mask_b, device=dev)[:, None, :]
            with timed("part_fit"):
                part_results = self.part_fitter.fit_batch(
                    markers_b, fit_weights, o_pose_b, o_betas_b, o_root_b,
                    num_rigid_groups=num_fit_groups, foot_contacts_b=o_fc_b,
                    frame_valid_b=frame_valid_b)
            total_evals += sum(r.lbfgs_evals for r in part_results)
            grab_stats("part_fit", self.part_fitter._solver)
            marker_labels_b = np.stack([_numpy(r.marker_labels) for r in part_results])
            root_seed = torch.stack([r.params.root_orient for r in part_results])
            trans_seed = torch.stack([r.params.trans for r in part_results])
            betas_seed = torch.stack([r.params.betas for r in part_results])
            chains = [r.chain for r in part_results]

        # ---- full-body fallback per sequence
        fallback = (~np.asarray([bool(cfg["find_best_part_fits"])] * Q)) | (aabb_ratios > 0.4)
        if fallback.any():
            fb = torch.as_tensor(fallback, device=dev)

            def sel(new, old):
                return torch.where(fb.reshape((Q,) + (1,) * (old.dim() - 1)), new, old)

            trans_seed = sel(median(markers_b, dim=2), trans_seed)
            root_seed = sel(o_root_b, root_seed)
            betas_seed = sel(o_betas_b, betas_seed)

        part_seeds = (betas_seed, root_seed, trans_seed)  # the part fit's own result

        # ---- camera-aware alignment of the full body
        if do_reproj_full:
            log(f"Batch[{Q}]: reprojection_full (lanes = sequence x angle)...")
            with timed("reprojection_full"):
                betas_seed, root_seed, trans_seed = self._reprojection_lanes(
                    preps, int(cfg["stages"]["reprojection_full"]["num_angles"]), "reproject",
                    markers_b, weights_b, o_pose_b, betas_seed, trans_seed, img_mask_b)

        labels_mode_b = torch.as_tensor(
            np.stack([_mode_per_column(marker_labels_b[q]) for q in range(Q)]), device=dev)

        # ---- root stage, lanes = sequence
        do_root = cfg["stages"]["root"]["num_iters"] > 0
        if do_root:
            log(f"Batch[{Q}]: root stage...")
            with timed("root"):
                params_root, res_r = stages.root_stage_lanes(
                    markers_b, weights_b, o_pose_b, o_betas_b, betas_seed, root_seed, trans_seed,
                    labels_mode_b, frame_valid_b)
            total_evals += sync(int, res_r.num_evals.sum())
            grab_stats("root", stages._root_solver)
            root_seed, trans_seed, betas_seed = (
                params_root.root_orient, params_root.trans, params_root.betas)

        # ---- chamfer + marker stages: lanes = sequence x yaw hypothesis
        A = int(cfg["num_root_orient_angles"])
        angles = torch.as_tensor(np.arange(A) * 2 * np.pi / A, dtype=torch.float32, device=dev)
        Ln = Q * A
        log(f"Batch[{Q}]: chamfer+marker, {Ln} lanes ({Q} sequences x {A} hypotheses)...")
        root0_l = self._seed_roots(angles, root_seed).reshape(Ln, F, 1, 3, 3)

        def lane_rep(x):  # [Q, ...] -> [Q * A, ...], sequence-major
            return x.repeat_interleave(A, dim=0)

        markers_l, weights_l, o_pose_l = lane_rep(markers_b), lane_rep(weights_b), lane_rep(o_pose_b)
        o_betas_l, fv_l = lane_rep(o_betas_b), lane_rep(frame_valid_b)
        labels_l, img_mask_l = lane_rep(labels_mode_b), lane_rep(img_mask_b)
        do_chamfer = cfg["stages"]["chamfer"]["num_iters"] > 0
        do_marker = cfg["stages"]["marker"]["num_iters"] > 0
        W = self.lane_width
        A_eff = A  # hypotheses still alive per sequence
        hyp_ids = np.tile(np.arange(A), (Q, 1))  # [Q, A_eff] original angle ids
        pose0_l, betas0_l, trans0_l = o_pose_l, lane_rep(betas_seed), lane_rep(trans_seed)

        if do_chamfer:
            # hypothesis pruning (``batch_solver.py:475-613``): tournament
            # rounds descend every live lane to at_iters (on every
            # frame_stride-th frame), score them with the final argmin's
            # chamfer and keep the best ``keep`` per sequence; the survivors
            # then descend to convergence at full frames
            rounds, strides = _prune_rounds(self.prune_cfg, 150, 1, "hypothesis_prune")
            if bool(self.prune_cfg.get("enabled")) and A > rounds[-1][1]:
                solver = self.phase1_solver()

                def stride_frames(x, s):  # the frame axis (dim 1), where present
                    return x[:, ::s] if s > 1 and x.dim() >= 2 and x.shape[1] == F else x

                A_cur, done_iters, p_stride = A, 0, 1
                for (at_iters, keep), r_stride in zip(rounds, strides):
                    if A_cur <= keep:
                        continue
                    round_iters = max(at_iters - done_iters, 1)
                    log(f"Batch[{Q}]: chamfer phase 1 ({Ln} lanes, +{round_iters} iters to "
                        f"{at_iters}" + (f", frame stride {r_stride}" if r_stride > 1 else "")
                        + ")...")
                    if p_stride != r_stride:  # re-sample the warm start
                        p = SmplParams(pose0_l, betas0_l, root0_l, trans0_l)
                        if p_stride > 1:
                            p = upsample_lane_params(p, F, p_stride)
                        p = SmplParams(*(stride_frames(x, r_stride) for x in p))
                        pose0_l, betas0_l, root0_l, trans0_l = p
                        p_stride = r_stride
                    mk_s, wt_s, op_s, ob_s, fv_s = (stride_frames(x, r_stride) for x in (
                        markers_l, weights_l, o_pose_l, o_betas_l, fv_l))
                    with timed("chamfer"):
                        solver.iter_cap = round_iters
                        try:
                            partial_all, res_p = stages.chamfer_stage_lanes(
                                mk_s, wt_s, op_s, ob_s, pose0_l, betas0_l, root0_l, trans0_l,
                                labels_l, fv_s, solver=solver)
                        finally:
                            solver.iter_cap = None
                    done_iters = at_iters
                    total_evals += sync(int, res_p.num_evals.sum())
                    grab_stats("chamfer", solver)
                    with timed("prune_score"):
                        pscores = _numpy(chunked_lanes(stages.score_chamfer_lanes, W, mk_s, wt_s,
                                                       partial_all)).reshape(Q, A_cur)
                    local = np.sort(np.argsort(pscores, axis=1)[:, :keep], axis=1)
                    hyp_ids = np.take_along_axis(hyp_ids, local, axis=1)
                    surv = torch.as_tensor((np.arange(Q)[:, None] * A_cur + local).reshape(-1),
                                           device=dev)
                    markers_l, weights_l, o_pose_l, o_betas_l, fv_l, img_mask_l, labels_l = (
                        x[surv] for x in (markers_l, weights_l, o_pose_l, o_betas_l, fv_l,
                                          img_mask_l, labels_l))
                    pose0_l, betas0_l, root0_l, trans0_l = (x[surv] for x in partial_all)
                    root0_l = rot.normalize_rotation(root0_l)
                    A_cur, Ln = keep, Q * keep
                if p_stride > 1:  # survivors enter phase 2 from upsampled params
                    pose0_l, betas0_l, root0_l, trans0_l = upsample_lane_params(
                        SmplParams(pose0_l, betas0_l, root0_l, trans0_l), F, p_stride)
                A_eff = A_cur
                log(f"  survivors {hyp_ids.tolist()}; chamfer phase 2 ({Ln} lanes)...")
            with timed("chamfer"):
                chamfer_all, res_c = stages.chamfer_stage_lanes(
                    markers_l, weights_l, o_pose_l, o_betas_l, pose0_l, betas0_l, root0_l,
                    trans0_l, labels_l, fv_l)
            total_evals += sync(int, res_c.num_evals.sum())
            grab_stats("chamfer", stages._chamfer_solver)
        else:
            chamfer_all = SmplParams(pose0_l, betas0_l, root0_l, trans0_l)

        part_gran = cfg["stages"]["segment"]["granularity"] == "part"
        marker_lanes = stages.marker_stage_sdf_lanes if self.use_sdf else stages.marker_stage_lanes
        if do_marker:
            with timed("nearest"):
                attach_all = (chunked_lanes(stages.nearest_points_lanes, W, markers_l,
                                            chamfer_all, img_mask_l, labels_l) if part_gran
                              else chunked_lanes(stages.nearest_points_lanes_nolabel, W,
                                                 markers_l, chamfer_all, img_mask_l))
            with timed("marker"):
                marker_all, res_m = marker_lanes(
                    markers_l, weights_l, o_pose_l, o_betas_l, chamfer_all, attach_all, fv_l)
            total_evals += sync(int, res_m.num_evals.sum())
            grab_stats("marker", self.marker_solver)
        else:
            marker_all = chamfer_all

        # ---- best hypothesis per sequence
        scores = _numpy(chunked_lanes(stages.score_chamfer_lanes, W, markers_l, weights_l,
                                      marker_all)).reshape(Q, A_eff)
        best_local = np.argmin(scores, axis=1)  # [Q] index into the surviving lanes
        best = hyp_ids[np.arange(Q), best_local]  # [Q] original angle ids
        sel_l = torch.as_tensor(np.arange(Q) * A_eff + best_local, device=dev)
        params_q = SmplParams(*(x[sel_l] for x in marker_all))
        chamfer_q = SmplParams(*(x[sel_l] for x in chamfer_all))
        marker_q = params_q  # the pre-refinement "marker" stage snapshot
        log(f"  best hypotheses: {best.tolist()}")

        # ---- final refinement repeats, lanes = sequence
        marker_labels_out = marker_labels_b
        if do_marker:
            for rep in range(int(cfg["stage_repeats"])):
                log(f"Batch[{Q}]: refinement {rep + 1}/{cfg['stage_repeats']}...")
                with timed("nearest_final"):
                    attach_q = (chunked_lanes(stages.nearest_points_lanes, W, markers_b,
                                              params_q, img_mask_b, labels_mode_b) if part_gran
                                else chunked_lanes(stages.nearest_points_lanes_nolabel, W,
                                                   markers_b, params_q, img_mask_b))
                if cfg.get("recompute_marker_labels"):
                    labels_np = []
                    for q in range(Q):
                        lab = _numpy(stages.marker_labels_from_attachment(
                            type(attach_q)(*(t[q] for t in attach_q)), F))
                        if cfg["stages"]["segment"]["rigid_filter"]:
                            lab = filter_rigid(preps[q].markers, lab)
                        labels_np.append(lab)
                    marker_labels_out = np.stack(labels_np)
                with timed("marker_final"):
                    params_q, res_f = marker_lanes(
                        markers_b, weights_b, params_q.pose_body, o_betas_b, params_q, attach_q,
                        frame_valid_b)
                total_evals += sync(int, res_f.num_evals.sum())
                grab_stats("marker_final", self.marker_solver)

        # ---- per-sequence output assembly (its reads drain the queue: no
        #      synchronize at its end)
        with stage("assemble", stage_times):
            results = []
            trans_np = _numpy(params_q.trans)
            root_np = _numpy(rot.normalize_rotation(params_q.root_orient))
            pose_np = _numpy(rot.normalize_rotation(params_q.pose_body))
            betas_np = _numpy(params_q.betas)
            for q in range(Q):
                Fr, Mr = preps[q].F_real, preps[q].M_real
                out: Dict[str, Any] = {
                    "trans": trans_np[q, :Fr], "root_orient": root_np[q, :Fr],
                    "pose_body": pose_np[q, :Fr],
                    "betas": np.broadcast_to(betas_np[q], (Fr, 10)).copy(),
                    "mocap_frame_rate": preps[q].mocap_freq,
                    "markers_labels": np.asarray(marker_labels_out[q])[:Fr, :Mr],
                    "best_hypothesis": int(best[q]),
                }
                if chains[q] is not None:
                    out["chain"] = chains[q]
                if save_stages:
                    def at_q(p):
                        return SmplParams(*(x[q] for x in p))

                    stage_dicts = {}
                    if cfg["find_best_part_fits"] and not fallback[q]:
                        stage_dicts["part"] = _params_to_stage_dict(SmplParams(
                            o_pose_b[q], part_seeds[0][q], part_seeds[1][q], part_seeds[2][q]))
                    if do_root:
                        stage_dicts["root"] = _params_to_stage_dict(at_q(params_root))
                    if do_chamfer:
                        stage_dicts["chamfer"] = _params_to_stage_dict(at_q(chamfer_q))
                    if do_marker:
                        stage_dicts["marker"] = _params_to_stage_dict(at_q(marker_q))
                        stage_dicts["marker_final"] = _params_to_stage_dict(at_q(params_q))
                    for sd in stage_dicts.values():
                        for key in ("trans", "root_orient", "pose_body"):
                            sd[key] = sd[key][:Fr]
                    out["stages"] = stage_dicts
                results.append(out)
        return {
            "results": results,
            "lbfgs_evals": total_evals,
            "solve_time_s": time.time() - t_start,
            "stage_times_s": {k: round(v, 2) for k, v in stage_times.items()},
            "eval_stats": eval_stats,
            "scores": scores,
            "best_hypothesis": best,
        }

    # ------------------------------------------------- reprojection lanes
    def _reprojection_lanes(self, preps, nA, metric_key, markers_b, weights_b, o_pose_b,
                            betas0_b, trans0_b, img_mask_b):
        """Camera alignment of every sequence at once (``batch_solver.py:
        754-792``): lanes = sequence x yaw seed, ``lane_width`` lanes at a
        time.  -> each sequence's best seed (least ``metric_key``): betas
        [Q, 1, 10] (the frame mean), root [Q, F, 1, 3, 3], trans [Q, F, 3].
        Both stages read their iterations and losses from
        ``reprojection_part``, as the reference does (ROADMAP C.10)."""
        if self._reproj is None:
            self._reproj = ReprojectionStage(self.model, self.config, "reprojection_part")
        Q, dev = len(preps), self.device
        angles_l = torch.as_tensor(np.tile(np.arange(nA) * 2 * np.pi / max(nA, 1), Q),
                                   dtype=torch.float32, device=dev)  # sequence-major

        def lane_rep(x):
            return x.repeat_interleave(nA, dim=0)

        def cam(field):
            return lane_rep(torch.as_tensor(np.stack([getattr(p, field) for p in preps]),
                                            device=dev))

        out = chunked_lanes(
            self._reproj.lanes, self.lane_width, angles_l, lane_rep(markers_b),
            lane_rep(weights_b), lane_rep(o_pose_b), lane_rep(betas0_b), cam("hmr_betas"),
            cam("hmr_root_orient"), lane_rep(trans0_b), cam("camera_bbox"), cam("cam_center"),
            cam("cam_size"), cam("cam_scale"), lane_rep(img_mask_b))
        best = np.argmin(_numpy(out["metrics"][metric_key]).reshape(Q, nA), axis=1)
        sel = torch.as_tensor(np.arange(Q) * nA + best, device=dev)
        return out["betas"][sel].mean(dim=1, keepdim=True), out["root_orient"][sel], out["trans"][sel]

    # ----------------------------------------------- compat core-stage sweep
    def solve(self, markers: torch.Tensor, weights: torch.Tensor, o_pose_body: torch.Tensor,
              o_betas: torch.Tensor, root_orient0: torch.Tensor, trans0: torch.Tensor,
              img_mask: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Core-stage sweep (chamfer -> correspondence -> marker IK -> best
        hypothesis) over S sequences without part-fit seeding
        (``batch_solver.py:793-852``): markers [S, F, M, 3], weights
        [S, F, M], o_pose_body [S, F, 23, 3, 3], o_betas [S, 1, 10],
        root_orient0 [S, F, 1, 3, 3], trans0 [S, F, 3], img_mask [S, F]."""
        stages = self.stages
        S, F, M = markers.shape[:3]
        dev = markers.device
        A = int(self.config["num_root_orient_angles"])
        Ln = S * A
        angles = torch.as_tensor(np.arange(A) * 2 * np.pi / A, dtype=torch.float32, device=dev)
        if img_mask is None:
            img_mask = torch.ones((S, F), device=dev)
        root0_l = self._seed_roots(angles, root_orient0).reshape(Ln, F, 1, 3, 3)

        def lane_rep(x):
            return x.repeat_interleave(A, dim=0)

        markers_l, weights_l, o_pose_l = lane_rep(markers), lane_rep(weights), lane_rep(o_pose_body)
        o_betas_l, fv_l = lane_rep(o_betas), torch.ones((Ln, F), device=dev)
        chamfer_all, res_c = stages.chamfer_stage_lanes(
            markers_l, weights_l, o_pose_l, o_betas_l, o_pose_l, o_betas_l, root0_l,
            lane_rep(trans0), torch.zeros((Ln, M), dtype=torch.long, device=dev), fv_l)
        attach_all = stages.nearest_points_lanes_nolabel(markers_l, chamfer_all, lane_rep(img_mask))
        marker_all, res_m = stages.marker_stage_lanes(
            markers_l, weights_l, o_pose_l, o_betas_l, chamfer_all, attach_all, fv_l)
        scores = _numpy(stages.score_chamfer_lanes(markers_l, weights_l, marker_all)).reshape(S, A)
        best = np.argmin(scores, axis=1)
        sel_l = torch.as_tensor(np.arange(S) * A + best, device=dev)
        return {
            "params": SmplParams(*(x[sel_l] for x in marker_all)),
            "scores": scores,
            "best_hypothesis": best,
            "lbfgs_evals": int(res_c.num_evals.sum() + res_m.num_evals.sum()),
        }
