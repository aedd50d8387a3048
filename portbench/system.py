"""Everything the benchmark calls in the program, ``uuo_mocap_tpu_torch``:
its body model built from the benchmark's arrays, its prepared windows, its
batch solver (``MultiSequenceSolver.solve_prepared``, the window's entry),
the warm-up, its counters, and the spans a traced run wraps around its calls.

Nothing else of the harness imports the program.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List

import numpy as np

from portbench import yardstick

# the calls a traced run wraps in ``torch.profiler.record_function`` ranges
# (the owner's attribute, the span's name)
STAGE_SPANS = (
    ("part_fitter", "fit_batch", "part_fitter.fit_batch"),
    ("stages", "chamfer_stage_lanes", "stages.chamfer_stage_lanes"),
    ("stages", "score_chamfer_lanes", "stages.score_chamfer_lanes"),
    ("stages", "nearest_points_lanes_nolabel", "stages.nearest_points_lanes_nolabel"),
    ("stages", "marker_stage_lanes", "stages.marker_stage_lanes"),
)
DISPATCHERS = ("rank_nearest", "min_sqdist_forward", "min_sqdist_backward")
# the hand-written kernels those dispatchers launch, as the profiler names them
NEAREST_KERNELS = ("nearest_staged", "nearest_many_queries", "min_sqdist_bwd_tiles")


def build_model(arrays: Dict[str, np.ndarray], device: str):
    from uuo_mocap_tpu_torch.convert import body_model_from_numpy

    return body_model_from_numpy(arrays, device=device)


def build_kernels(device: str) -> None:
    """Build (on a checkout's first run) and load the Hopper kernels."""
    if device == "cuda":
        from uuo_mocap_tpu_torch.ops import chamfer_kernels

        chamfer_kernels.build()


def prepare(batch, columns: int, freq: float) -> List[Any]:
    """The program's prepared windows of a pool batch: the prior resampled
    to the markers' rate, the marker columns padded to ``columns``."""
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
    from uuo_mocap_tpu_torch.pipeline.multimodal import prepare_sequence
    from uuo_mocap_tpu_torch.pipeline.stages import SmplParams

    preps = []
    for prior, markers in zip(batch.priors, batch.markers):
        p = SmplParams(*(np.asarray(prior[k], np.float32)
                         for k in ("pose_body", "betas", "root_orient", "trans")))
        preps.append(prepare_sequence(
            ImgSmpl.from_params(p, freq=freq), ArrayMarkers(markers, freq=freq), frame_bucket=None,
            pad_to_markers=columns if markers.shape[1] < columns else None))
    return preps


def solve_config(config: dict, traffic: dict) -> dict:
    """The configuration's solve settings with the traffic's solver
    settings (lane widths) merged in."""
    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = copy.deepcopy(v)
        return dst

    return merge(copy.deepcopy(config["solve"]), traffic.get("solver", {}))


def make_solver(model, cfg: dict, device: str):
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver

    return MultiSequenceSolver(model, cfg, device=device)


def stage_solvers(solver) -> list:
    """The L-BFGS solvers of the part fit, the chamfer stage (both phases)
    and the marker stages."""
    return [solver.part_fitter._solver, solver.stages._chamfer_solver, solver.marker_solver,
            solver.phase1_solver()]


def warm_up(solver, preps) -> None:
    """One solve with every stage solver capped at 1 iteration: every shape
    and program of the window runs once (``bench.py:555-569``'s warm-up)."""
    solvers = stage_solvers(solver)
    for s in solvers:
        s.warmup_iter_cap = 1
    try:
        solver.solve_prepared(preps, save_stages=True)
    finally:
        for s in solvers:
            s.warmup_iter_cap = None


@contextlib.contextmanager
def _recorded(owner, attr: str, calls: list):
    """Append what ``owner.attr`` returns to ``calls``; undone on exit."""
    old = owner.__dict__.get(attr)
    fn = getattr(owner, attr)

    def run(*args, **kw):
        out = fn(*args, **kw)
        calls.append(out)
        return out

    setattr(owner, attr, run)
    try:
        yield
    finally:
        if old is None:
            delattr(owner, attr)
        else:
            setattr(owner, attr, old)


def solve(solver, preps) -> Dict[str, Any]:
    """The window's call, with two of its picks kept for the check: per
    window the part fit's body (betas, root, translation; its
    nearest-vertex labels are the answer's ``markers_labels``) as
    ``"part_fits"``, and the vertex each marker is attached to in the final
    marker pass, [Q, M], as ``"final_attach"``."""
    fits, attach = [], []
    with _recorded(solver.part_fitter, "fit_batch", fits), \
            _recorded(solver.stages, "nearest_points_lanes_nolabel", attach):
        out = solver.solve_prepared(preps, save_stages=True)
    out["part_fits"] = [{k: np.asarray(getattr(r.params, k).detach().cpu())
                         for k in ("betas", "root_orient", "trans")} for r in fits[-1]]
    # the final pass's lanes are the last len(preps) of the last calls
    ids, lanes = [], 0
    for a in reversed(attach):
        if lanes >= len(preps):
            break
        ids.insert(0, a.vertex_ids[..., 0].cpu().numpy())
        lanes += ids[0].shape[0]
    out["final_attach"] = np.concatenate(ids)[-len(preps):]
    return out


def launch_counts() -> Dict[str, int]:
    from uuo_mocap_tpu_torch.ops import chamfer_kernels

    return dict(chamfer_kernels.launch_counts())


def answers(out: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per window, what the check reads of a solve's output: the answer's
    parameters and labels, the hypothesis picked, the marker stage's
    parameters and the score the program gave them, the part fit's body
    and the final marker pass's picks (``solve``)."""
    scores = np.asarray(out["scores"], np.float64)
    rows = []
    for q, r in enumerate(out["results"]):
        rows.append({k: np.asarray(r[k]) for k in ("trans", "root_orient", "pose_body", "betas",
                                                    "markers_labels")}
                    | {"best_hypothesis": r["best_hypothesis"],
                       "marker_stage": {k: np.asarray(v) for k, v in r["stages"]["marker"].items()},
                       "score": float(scores[q].min()),
                       "part_fit": out["part_fits"][q], "attach_ids": out["final_attach"][q]})
    return rows


@contextlib.contextmanager
def instrumented(solver, calls: List[float]):
    """Wrap the stage calls and the three kernel dispatchers in
    ``record_function`` ranges, and append each dispatcher call's roofline
    bound (s, from its shapes) to ``calls``; undone on exit."""
    from torch.profiler import record_function

    from uuo_mocap_tpu_torch.ops import chamfer_kernels as K

    def spanned(name, fn):
        def run(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return run

    def rank_bound(markers, verts, bias=None):
        L, F, M = markers.shape[:3]
        return yardstick.rank_call_bound_ms(L, F, M, verts.shape[2], bias is not None)

    def fwd_bound(x, y, bias):
        return yardstick.forward_call_bound_ms(x.shape[0], x.shape[1], y.shape[1])

    def bwd_bound(idx, diff, g, V):
        return yardstick.backward_call_bound_ms(idx.shape[0], idx.shape[1], V)

    def counted(name, fn, bound_ms):
        def run(*args, **kw):
            if args[0].device.type == "cuda":
                calls.append(bound_ms(*args, **kw) / 1e3)
            with record_function(name):
                return fn(*args, **kw)
        return run

    saved = []
    for owner_name, attr, span in STAGE_SPANS:
        owner = getattr(solver, owner_name)
        saved.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, spanned(span, getattr(owner, attr)))
    for name, bound_ms in zip(DISPATCHERS, (rank_bound, fwd_bound, bwd_bound)):
        saved.append((K, name, getattr(K, name)))
        setattr(K, name, counted(name, getattr(K, name), bound_ms))
    try:
        yield
    finally:
        for owner, attr, old in reversed(saved):
            if owner is K:
                setattr(K, attr, old)
            elif old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
