"""Lane-batched L-BFGS with a per-lane strong-Wolfe line search
(counterpart of ``uuo_mocap_tpu/solver/lbfgs.py``).

Semantics follow ``torch.optim.LBFGS(line_search_fn="strong_wolfe")`` as the
reference restates them (``lbfgs.py:1-23``):
  * two-loop recursion over a circular (s, y) history with gamma scaling;
  * a curvature pair is stored only when y.s > 1e-10;
  * first step t0 = lr * min(1, 1/||g||_1);
  * strong Wolfe (c1=1e-4, c2=0.9, at most 25 evaluations) with cubic
    interpolation, bracketing and zoom (``_strong_wolfe``, ``:90-243``);
  * stop on max|g| <= tolerance_grad, max|t*d| <= tolerance_change, or
    |f - f_prev| < tolerance_change.

Lanes advance in lockstep.  Every evaluation runs the closure for all L
lanes at once: ``fun(x [L, n]) -> [L]``, and ``autograd.grad(f.sum(), x)``
gives every lane its own gradient because lanes do not interact.  A lane
that has finished (or whose line search has) is frozen: its state and its
counters stop, exactly as under the reference's ``vmap`` of ``while_loop``.
The host reads one flag per line-search evaluation to decide whether any
lane is still running; each such read goes through ``utils.tracing.sync``,
and a traced run sees the ``uuo.lbfgs.*`` spans (``utils/tracing.py``).

Two optional hooks follow the reference.  ``prepare(x) -> aux`` computes
non-differentiated data once per iteration (the rank freeze: nearest-vertex
ids) and the closure takes ``(x, aux)`` for every evaluation of that
iteration (``lbfgs.py:245-290``).  An observer of the parameters is called
at the end of every segment of ``SEGMENT_SIZE`` iterations, and when the run
ends (``lbfgs.py:557-563``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from uuo_mocap_tpu_torch.utils.tracing import (
    dense_lbs_kernel_rows, dense_lbs_rows, span, spanned, sync, sync_count)

# iterations per segment of the reference's device loop (``stages.py:47``):
# the rate at which ``BatchedLbfgs.snapshot`` sees the parameters
SEGMENT_SIZE = 50


@dataclasses.dataclass(frozen=True)
class LbfgsOptions:
    max_iter: int = 100
    tolerance_grad: float = 1e-7
    tolerance_change: float = 1e-9
    history_size: int = 10
    lr: float = 1.0
    max_ls: int = 25
    c1: float = 1e-4
    c2: float = 0.9


class LbfgsResult(NamedTuple):
    x: torch.Tensor  # [L, n]
    f: torch.Tensor  # [L]
    grad_norm: torch.Tensor  # [L] max|g|
    num_iters: torch.Tensor  # [L]
    num_evals: torch.Tensor  # [L]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, xmin, xmax):
    """``torch.optim.lbfgs._cubic_interpolate``, branch-free and per lane."""
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_sq = d1 * d1 - g1 * g2
    d2 = torch.sqrt(torch.clamp_min(d2_sq, 0.0))
    min_pos_12 = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
    min_pos_21 = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
    min_pos = torch.where(x1 <= x2, min_pos_12, min_pos_21)
    mid = (xmin + xmax) / 2.0
    out = torch.where(d2_sq >= 0, torch.minimum(torch.maximum(min_pos, xmin), xmax), mid)
    return torch.where(torch.isfinite(out), out, mid)


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane select: mask [L] broadcast over the trailing dims of a, b."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _pick(arr: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """arr [L, 2, ...], slot [L] in {0, 1} -> arr[l, slot[l]]."""
    return _sel(slot == 0, arr[:, 0], arr[:, 1])


def _put(arr: torch.Tensor, slot: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """arr [L, 2, ...] with arr[l, slot[l]] = val[l]."""
    return torch.stack([_sel(slot == 0, val, arr[:, 0]), _sel(slot == 1, val, arr[:, 1])], dim=1)


def _pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, b], dim=1)


@spanned("lbfgs.line_search")
def _strong_wolfe(eval_fd, t, d, f, g, gtd, opts: LbfgsOptions):
    """Per-lane strong-Wolfe search from t [L] along d [L, n], as the
    reference's single-evaluation-site state machine.  ``eval_fd(t)``
    evaluates every lane at x + t*d.  Returns (f_new, g_new, t, n_evals,
    exhausted): ``exhausted`` [L] marks the lanes whose search stopped at
    ``max_ls`` evaluations without meeting its conditions."""
    c1, c2 = opts.c1, opts.c2
    tol = 1e-9  # torch hard-codes tolerance_change=1e-9 inside the search
    d_norm = d.abs().amax(-1)
    L = t.shape[0]
    dev = t.device
    zeros = torch.zeros_like(t)

    s = {
        "zoom": torch.zeros(L, dtype=torch.bool, device=dev),
        "done": torch.zeros(L, dtype=torch.bool, device=dev),
        "ls_iter": torch.zeros(L, dtype=torch.long, device=dev),
        "t_c": t, "t_p": zeros, "f_p": f, "g_p": g, "gtd_p": gtd,
        "br_t": _pair(zeros, t), "br_f": _pair(f, f), "br_g": _pair(g, g),
        "br_gtd": _pair(gtd, gtd),
        "insuf": torch.zeros(L, dtype=torch.bool, device=dev),
    }

    while True:
        active = (~s["done"]) & (s["ls_iter"] < opts.max_ls)
        if not sync(bool, active.any()):
            break
        t_c = s["t_c"]
        f_c, g_c = eval_fd(t_c)
        gtd_c = _dot(g_c, d)
        in_bracket = ~s["zoom"]

        # bracket phase (torch's loop top)
        armijo_fail = (f_c > f + c1 * t_c * gtd) | ((s["ls_iter"] > 1) & (f_c >= s["f_p"]))
        wolfe_ok = gtd_c.abs() <= -c2 * gtd
        grad_pos = gtd_c >= 0
        hit = armijo_fail | wolfe_ok | grad_pos
        wolfe_exit_b = in_bracket & wolfe_ok & ~armijo_fail
        to_zoom = in_bracket & hit & ~wolfe_exit_b

        sel_prev = armijo_fail | grad_pos
        bt_new = _sel(sel_prev, _pair(s["t_p"], t_c), _pair(t_c, t_c))
        bf_new = _sel(sel_prev, _pair(s["f_p"], f_c), _pair(f_c, f_c))
        bg_new = _sel(sel_prev, _pair(s["g_p"], g_c), _pair(g_c, g_c))
        bgtd_new = _sel(sel_prev, _pair(s["gtd_p"], gtd_c), _pair(gtd_c, gtd_c))
        bt_new = _sel(wolfe_exit_b, _pair(t_c, t_c), bt_new)
        bf_new = _sel(wolfe_exit_b, _pair(f_c, f_c), bf_new)
        bg_new = _sel(wolfe_exit_b, _pair(g_c, g_c), bg_new)
        bgtd_new = _sel(wolfe_exit_b, _pair(gtd_c, gtd_c), bgtd_new)

        min_step = t_c + 0.01 * (t_c - s["t_p"])
        max_step = t_c * 10.0
        t_next_b = _cubic_interpolate(s["t_p"], s["f_p"], s["gtd_p"], t_c, f_c, gtd_c,
                                      min_step, max_step)

        # zoom phase (torch's zoom, after the evaluation)
        low0 = torch.where(s["br_f"][:, 0] <= s["br_f"][:, 1], 0, 1)
        high0 = 1 - low0
        z_fail = (f_c > f + c1 * t_c * gtd) | (f_c >= _pick(s["br_f"], low0))
        z_wolfe = gtd_c.abs() <= -c2 * gtd
        flip = gtd_c * (_pick(s["br_t"], high0) - _pick(s["br_t"], low0)) >= 0

        def z_update(arr, val):
            fail_arr = _put(arr, high0, val)
            succ_arr = _sel(flip, _put(arr, high0, _pick(arr, low0)), arr)
            succ_arr = _put(succ_arr, low0, val)
            return _sel(z_fail, fail_arr, succ_arr)

        z_bt = z_update(s["br_t"], t_c)
        z_bf = z_update(s["br_f"], f_c)
        z_bg = z_update(s["br_g"], g_c)
        z_bgtd = z_update(s["br_gtd"], gtd_c)
        zoom_done = (~z_fail) & z_wolfe

        # merge the phases; a bracket continuation keeps [0, last t]
        br_t = _sel(in_bracket, _sel(hit, bt_new, _pair(zeros, t_c)), z_bt)
        br_f = _sel(in_bracket, _sel(hit, bf_new, _pair(f, f_c)), z_bf)
        br_g = _sel(in_bracket, _sel(hit, bg_new, _pair(g, g_c)), z_bg)
        br_gtd = _sel(in_bracket, _sel(hit, bgtd_new, _pair(gtd, gtd_c)), z_bgtd)

        entering_zoom = to_zoom | (~in_bracket)
        zoom = ~(in_bracket & ~hit)
        done = s["done"] | wolfe_exit_b | ((~in_bracket) & zoom_done)

        t_z = _cubic_interpolate(br_t[:, 0], br_f[:, 0], br_gtd[:, 0],
                                 br_t[:, 1], br_f[:, 1], br_gtd[:, 1],
                                 torch.minimum(br_t[:, 0], br_t[:, 1]),
                                 torch.maximum(br_t[:, 0], br_t[:, 1]))
        bmax = torch.maximum(br_t[:, 0], br_t[:, 1])
        bmin = torch.minimum(br_t[:, 0], br_t[:, 1])
        eps = 0.1 * (bmax - bmin)
        close_to_edge = torch.minimum(bmax - t_z, t_z - bmin) < eps
        force = s["insuf"] | (t_z >= bmax) | (t_z <= bmin)
        t_forced = torch.where((t_z - bmax).abs() < (t_z - bmin).abs(), bmax - eps, bmin + eps)
        t_z_final = torch.where(close_to_edge & force, t_forced, t_z)
        insuf = torch.where(entering_zoom, close_to_edge & ~force, s["insuf"])
        done = done | (entering_zoom & ((br_t[:, 1] - br_t[:, 0]).abs() * d_norm < tol))
        t_next = torch.where(entering_zoom, t_z_final, t_next_b)
        keep_prev = in_bracket & ~hit

        new = {
            "zoom": zoom, "done": done, "ls_iter": s["ls_iter"] + 1, "t_c": t_next,
            "t_p": torch.where(keep_prev, t_c, s["t_p"]),
            "f_p": torch.where(keep_prev, f_c, s["f_p"]),
            "g_p": _sel(keep_prev, g_c, s["g_p"]),
            "gtd_p": torch.where(keep_prev, gtd_c, s["gtd_p"]),
            "br_t": br_t, "br_f": br_f, "br_g": br_g, "br_gtd": br_gtd, "insuf": insuf,
        }
        s = {k: _sel(active, new[k], s[k]) for k in s}

    low = torch.where(s["br_f"][:, 0] <= s["br_f"][:, 1], 0, 1)
    return (_pick(s["br_f"], low), _pick(s["br_g"], low), _pick(s["br_t"], low),
            1 + s["ls_iter"], ~s["done"])


def _value_and_grad(fun: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    with span("lbfgs.eval"), torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fun(xg)
        with span("lbfgs.grad"):
            (g,) = torch.autograd.grad(f.sum(), xg)
    return f.detach(), g


class LbfgsState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    S: torch.Tensor  # [L, H, n]
    Y: torch.Tensor  # [L, H, n]
    rho: torch.Tensor  # [L, H]
    hist: torch.Tensor  # [L]
    n_iter: torch.Tensor
    n_evals: torch.Tensor
    done: torch.Tensor
    ls_exhausted: torch.Tensor  # [L] iterations whose line search ran out (``_strong_wolfe``)


def _with_aux(fun, prepare, x: torch.Tensor):
    """``fun`` itself, or with ``prepare``'s aux computed at x held fixed."""
    if prepare is None:
        return fun
    with torch.no_grad():
        aux = prepare(x.detach())
    return lambda x_: fun(x_, aux)


@spanned("lbfgs.init")
def lbfgs_init(fun, x0: torch.Tensor, opts: LbfgsOptions, prepare=None) -> LbfgsState:
    f0, g0 = _value_and_grad(_with_aux(fun, prepare, x0), x0)
    L, n = x0.shape
    H = opts.history_size
    z = torch.zeros((L, H, n), dtype=x0.dtype, device=x0.device)
    ints = torch.zeros(L, dtype=torch.long, device=x0.device)
    return LbfgsState(x0.detach(), f0, g0, z, z.clone(),
                      torch.zeros((L, H), dtype=x0.dtype, device=x0.device),
                      ints, ints.clone(), ints + 1,
                      g0.abs().amax(-1) <= opts.tolerance_grad, ints.clone())


@spanned("lbfgs.direction")
def _direction(st: LbfgsState, H: int) -> torch.Tensor:
    """Two-loop recursion, every lane over its own history."""
    L = st.x.shape[0]
    lanes = torch.arange(L, device=st.x.device)
    num = torch.clamp_max(st.hist, H)
    q = -st.g
    al = torch.zeros_like(st.rho)
    for i in range(H):
        slot = torch.remainder(st.hist - 1 - i, H)
        a_i = st.rho[lanes, slot] * _dot(st.S[lanes, slot], q)
        a_i = torch.where(i < num, a_i, torch.zeros_like(a_i))
        q = q - a_i[:, None] * st.Y[lanes, slot]
        al[lanes, slot] = a_i
    last = torch.remainder(st.hist - 1, H)
    y_last, s_last = st.Y[lanes, last], st.S[lanes, last]
    gamma = _dot(y_last, s_last) / torch.clamp_min(_dot(y_last, y_last), 1e-20)
    r = q * gamma[:, None]
    for i in range(H):
        slot = torch.remainder(st.hist - num + i, H)
        be = st.rho[lanes, slot] * _dot(st.Y[lanes, slot], r)
        upd = (al[lanes, slot] - be)[:, None] * st.S[lanes, slot]
        r = r + torch.where((i < num)[:, None], upd, torch.zeros_like(upd))
    return torch.where((st.hist == 0)[:, None], -st.g, r)


def lbfgs_step(fun, st: LbfgsState, opts: LbfgsOptions, prepare=None) -> LbfgsState:
    """One L-BFGS iteration for every lane (direction, line search, history
    and convergence update); the caller keeps it only for running lanes.
    With ``prepare`` the iteration re-evaluates (f, g) at its start under
    ``prepare(x)``'s aux, counted as one evaluation, and holds that aux for
    its line search (``lbfgs.py:269-300``)."""
    H = opts.history_size
    if prepare is not None:
        fun = _with_aux(fun, prepare, st.x)
        f, g = _value_and_grad(fun, st.x)
        st = st._replace(f=f, g=g, n_evals=st.n_evals + 1)
    d = _direction(st, H)
    gtd = _dot(st.g, d)
    dd_break = gtd > -opts.tolerance_change
    t0 = torch.where(
        st.n_iter == 0,
        opts.lr * torch.clamp_max(1.0 / torch.clamp_min(st.g.abs().sum(-1), 1e-20), 1.0),
        torch.full_like(gtd, opts.lr))

    def eval_fd(t):
        return _value_and_grad(fun, st.x + t[:, None] * d)

    f_ls, g_ls, t_ls, ev_ls, ex_ls = _strong_wolfe(eval_fd, t0, d, st.f, st.g, gtd, opts)
    f_new = torch.where(dd_break, st.f, f_ls)
    g_new = _sel(dd_break, st.g, g_ls)
    t = torch.where(dd_break, torch.zeros_like(t_ls), t_ls)
    evals = torch.where(dd_break, torch.zeros_like(ev_ls), ev_ls)

    s = t[:, None] * d
    y = g_new - st.g
    ys = _dot(y, s)
    store = ys > 1e-10
    slot = torch.remainder(st.hist, H)
    lanes = torch.arange(st.x.shape[0], device=st.x.device)
    S_new, Y_new, rho_new = st.S.clone(), st.Y.clone(), st.rho.clone()
    S_new[lanes, slot] = _sel(store, s, st.S[lanes, slot])
    Y_new[lanes, slot] = _sel(store, y, st.Y[lanes, slot])
    rho_new[lanes, slot] = torch.where(store, 1.0 / ys, st.rho[lanes, slot])

    done = (dd_break | (g_new.abs().amax(-1) <= opts.tolerance_grad)
            | (s.abs().amax(-1) <= opts.tolerance_change)
            | ((f_new - st.f).abs() < opts.tolerance_change))
    return LbfgsState(
        x=_sel(dd_break, st.x, st.x + s), f=f_new, g=g_new, S=S_new, Y=Y_new, rho=rho_new,
        hist=st.hist + store.long(), n_iter=st.n_iter + 1, n_evals=st.n_evals + evals,
        done=done, ls_exhausted=st.ls_exhausted + (ex_ls & ~dd_break).long())


def _segment_ends(k: int, running: bool) -> bool:
    """After k iterations of a working set: a segment ends every
    SEGMENT_SIZE iterations, and when the set stops (unless it just did)."""
    return (k > 0 and k % SEGMENT_SIZE == 0) if running else (k == 0 or k % SEGMENT_SIZE != 0)


def lbfgs_run(fun, x0: torch.Tensor, opts: LbfgsOptions, iter_cap: int | None = None,
              prepare=None, on_segment=None) -> Tuple[LbfgsState, int]:
    """Minimize every lane of ``fun(x [L, n]) -> [L]`` from x0 [L, n].
    ``on_segment(state)``, if given, sees the state at every segment's end.
    Returns the final state and the number of lockstep iterations run."""
    cap = opts.max_iter if iter_cap is None else min(opts.max_iter, int(iter_cap))
    st = lbfgs_init(fun, x0, opts, prepare)
    steps = 0
    while True:
        alive = (~st.done) & (st.n_iter < cap)
        running = sync(bool, alive.any())
        if on_segment is not None and _segment_ends(steps, running):
            on_segment(st)
        if not running:
            return st, steps
        new = lbfgs_step(fun, st, opts, prepare)
        st = LbfgsState(*(_sel(alive, a, b) for a, b in zip(new, st)))
        steps += 1


def _result(st: LbfgsState) -> LbfgsResult:
    return LbfgsResult(x=st.x, f=st.f, grad_norm=st.g.abs().amax(-1), num_iters=st.n_iter,
                       num_evals=st.n_evals)


def _raveler(params: Dict[str, torch.Tensor], lead: int):
    """Flatten a dict of tensors in sorted key order (``ravel_pytree``'s
    order) after ``lead`` leading dims -> (x [*lead, n], unflatten)."""
    keys = sorted(params)
    shapes = [params[k].shape[lead:] for k in keys]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    head = params[keys[0]].shape[:lead]
    x = torch.cat([params[k].reshape(head + (-1,)) for k in keys], dim=-1).float()

    def unflatten(x):
        return {k: p.reshape(x.shape[:-1] + tuple(s))
                for k, p, s in zip(keys, torch.split(x, sizes, dim=-1), shapes)}

    return x, unflatten


def lbfgs_minimize_flat(fun, x0: torch.Tensor, opts: LbfgsOptions) -> LbfgsResult:
    """Minimize ``fun(x [n]) -> scalar`` from x0 [n] (``lbfgs.py:426-449``).

    With x0 [L, n], L independent problems (the reference's ``vmap`` of this
    function): ``fun(x [R, n], rows [R]) -> [R]`` evaluates the lanes
    ``rows``, and every iteration evaluates only the lanes still running, so
    a lane that stops is frozen and costs nothing more.  A lane's result is
    its lone run's.  This loop stays apart from ``BatchedLbfgs``: the
    shipped stages evaluate fixed-width lanes in lockstep, and their
    results (and ``chip_smoke.py``'s digests of them) depend on those
    shapes, so compacting them would move every shipped digest."""
    if x0.dim() == 1:
        st, _ = lbfgs_run(lambda x: fun(x[0])[None], x0[None], opts)
        return LbfgsResult(*(t[0] for t in _result(st)))
    rows = torch.arange(x0.shape[0], device=x0.device)
    st = lbfgs_init(lambda x: fun(x, rows), x0, opts)
    while True:
        rows = sync(torch.nonzero, (~st.done) & (st.n_iter < opts.max_iter))[:, 0]
        if rows.numel() == 0:
            return _result(st)
        new = lbfgs_step(lambda x, r=rows: fun(x, r), LbfgsState(*(t[rows] for t in st)), opts)
        st = LbfgsState(*(t.index_copy(0, rows, n) for t, n in zip(st, new)))


def lbfgs_minimize(fun, params0: Dict[str, torch.Tensor], opts: LbfgsOptions,
                   batched: bool = False) -> Tuple[Dict[str, torch.Tensor], LbfgsResult]:
    """Minimize ``fun(params) -> scalar`` over a dict of tensors
    (``lbfgs.py:452-463``) -> (optimized params, result).  ``batched``: every
    tensor carries a leading lane axis, one problem per lane, and
    ``fun(params, rows)`` returns the values of the lanes ``rows``, whose
    rows ``params`` holds (see ``lbfgs_minimize_flat``)."""
    x0, unflatten = _raveler(params0, int(batched))
    if batched:
        res = lbfgs_minimize_flat(lambda x, rows: fun(unflatten(x), rows), x0, opts)
    else:
        res = lbfgs_minimize_flat(lambda x: fun(unflatten(x)), x0, opts)
    return {k: v.detach() for k, v in unflatten(res.x).items()}, res


def _gather(st: LbfgsState, idx: torch.Tensor) -> LbfgsState:
    return LbfgsState(*(t[idx] for t in st))


def _cat(states) -> LbfgsState:
    return LbfgsState(*(torch.cat(ts) for ts in zip(*states)))


class BatchedLbfgs:
    """``fun(params, lane, shared) -> [L]`` minimized independently for every
    lane (counterpart of ``BatchedLbfgs``, ``lbfgs.py:475-851``).

    ``params`` is a dict of tensors with a leading lane axis; ``lane``
    tensors carry the lane axis too, ``shared`` ones do not.  The parameters
    are flattened per lane in sorted key order (the reference's
    ``ravel_pytree`` order).  ``iter_cap`` caps each lane's iterations below
    ``opts.max_iter``, and ``warmup_iter_cap`` caps them again whatever the
    caller set (a warm-up that runs every program once).

    Streaming (``max_width``): the closure runs a working set of W lanes,
    and every lane lives in a pool.  The pool is initialized W lanes at a
    time; then a lane that converges or reaches its cap retires to the pool
    and a queued lane takes its slot, and once the queue is empty,
    duplicates of live lanes pad the working set.  ``pad_width`` rounds a
    batch smaller than ``max_width`` up to the next power of two (the
    reference's bucket rule, ``lbfgs.py:669-674``).  Unlike the reference,
    which runs segments of iterations per device program and checks between
    them, the port steps the working set one iteration at a time and checks
    on the host after each, so ``segments`` and ``abort_after_segments``
    have no counterpart.

    ``last_run_stats`` after a run, under the reference's meanings:
    ``width`` (W), ``lanes`` (L), ``refills`` (working-set changes),
    ``lane_evals`` (the evaluations the lanes used, summed), ``device_evals``
    (the evaluations the working set ran: W per initial evaluation and, per
    iteration, W times the most any of its lanes counted) and
    ``ride_along_evals`` (their difference: finished lanes and duplicates
    carried in lockstep).  Evaluations are counted as the reference counts
    them, 1 + the line search's evaluations per iteration, so the two
    packages' numbers compare.  The port's own counters: ``iterations``
    (working-set iterations), ``ls_evals`` (closure calls made inside line
    searches), ``lane_iters`` (the lanes' iterations, summed),
    ``ls_exhausted`` (lane iterations whose line search stopped at
    ``max_ls`` evaluations without meeting its conditions, lanes whose
    direction was not a descent left out), ``host_syncs`` (the run's
    ``utils.tracing.sync`` calls: host reads and copies that wait for the
    device), ``dense_lbs_rows`` (the rows of the run's dense LBS forwards,
    ``utils.tracing.dense_lbs_rows``) and ``dense_lbs_kernel_rows`` (of
    those, the rows the hand-written kernel computed).

    ``prepare(params, lane, shared) -> aux`` (the rank freeze): computed once
    per iteration, and ``fun`` then takes ``(params, lane, shared, aux)``.
    ``snapshot(lanes, iters, params)``, if set, sees the working set at the
    end of every segment of ``SEGMENT_SIZE`` iterations and when the working
    set changes or the run ends: its pool lane ids [W] (duplicates
    included), iterations [W] and parameters (a dict of numpy arrays [W,
    ...]), as the reference's observer does (``lbfgs.py:557-563``).  The
    reference refills the working set only between segments, the port
    between any two iterations, so under streaming the segments differ.
    """

    def __init__(self, fun, opts: LbfgsOptions, max_width: int | None = None,
                 pad_width: bool = False, prepare=None):
        self.fun = fun
        self.opts = opts
        self.max_width = max_width
        self.pad_width = pad_width
        self.prepare = prepare
        self.iter_cap = None
        self.warmup_iter_cap = None
        self.snapshot = None
        self.last_run_stats: Dict[str, int] = {}

    def width(self, L: int) -> int:
        """The working-set width for L lanes (``lbfgs.py:669-674``)."""
        if self.max_width is not None and L > self.max_width:
            return int(self.max_width)
        if self.pad_width and self.max_width is not None and L < self.max_width:
            return min(1 << max(L - 1, 1).bit_length(), int(self.max_width)) if L > 1 else 1
        return L

    def run(self, params0: Dict[str, torch.Tensor], lane: Dict[str, torch.Tensor],
            shared: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], LbfgsResult]:
        x0, unflatten = _raveler(params0, 1)
        L = x0.shape[0]
        calls = [0]
        syncs0 = sync_count()
        dense0, dense_kernel0 = dense_lbs_rows(), dense_lbs_kernel_rows()

        def fun_on(rows):
            """The closure and the prepare hook on the lanes ``rows`` (None:
            all lanes in order)."""
            lane_w = lane if rows is None else {k: v[rows] for k, v in lane.items()}

            def fun(x, *aux):
                calls[0] += 1
                return self.fun(unflatten(x), lane_w, shared, *aux)

            if self.prepare is None:
                return fun, None
            return fun, lambda x: self.prepare(unflatten(x), lane_w, shared)

        def observe(rows, st):
            if self.snapshot is not None:
                self.snapshot(rows, sync(st.n_iter.cpu).numpy(),
                              {k: sync(v.detach().cpu).numpy()
                               for k, v in unflatten(st.x).items()})

        cap = self.opts.max_iter if self.iter_cap is None else min(self.opts.max_iter,
                                                                    int(self.iter_cap))
        if self.warmup_iter_cap is not None:
            cap = min(cap, int(self.warmup_iter_cap))
        W = self.width(L)
        refills = 0
        if W == L:
            fun, prepare = fun_on(None)
            st, steps = lbfgs_run(fun, x0, self.opts, cap, prepare,
                                  on_segment=lambda st: observe(np.arange(L), st))
        else:
            st, refills, steps = self._stream(fun_on, observe, x0, L, W, cap)
        # one closure call per line-search evaluation and per pool chunk's
        # initial evaluation (and with ``prepare`` one per iteration), plus
        # the reference's extra count per iteration
        device_evals = W * (calls[0] + steps)
        inits = -(-L // W)
        lane_evals, lane_iters, exhausted = sync(torch.stack(
            [st.n_evals.sum(), st.n_iter.sum(), st.ls_exhausted.sum()]).tolist)
        self.last_run_stats = {
            "width": W, "lanes": L, "refills": refills, "lane_evals": lane_evals,
            "device_evals": device_evals, "ride_along_evals": max(device_evals - lane_evals, 0),
            "iterations": steps,
            "ls_evals": calls[0] - inits - (steps if self.prepare is not None else 0),
            "lane_iters": lane_iters, "ls_exhausted": exhausted,
            "host_syncs": sync_count() - syncs0,
            "dense_lbs_rows": dense_lbs_rows() - dense0,
            "dense_lbs_kernel_rows": dense_lbs_kernel_rows() - dense_kernel0}
        return {k: v.detach() for k, v in unflatten(st.x).items()}, _result(st)

    def _stream(self, fun_on, observe, x0: torch.Tensor, L: int, W: int, cap: int
                ) -> Tuple[LbfgsState, int, int]:
        """Refill-on-retire over a working set of W lanes (``lbfgs.py:704-829``).
        Returns the pool's final state, the number of refills and the number
        of working-set iterations."""
        dev = x0.device
        chunks = []
        for s in range(0, L, W):  # row j of chunk s is lane min(s + j, L - 1)
            rows = sync(torch.as_tensor, np.clip(np.arange(s, s + W), 0, L - 1), device=dev)
            fun, prepare = fun_on(rows)
            chunks.append(lbfgs_init(fun, x0[rows], self.opts, prepare))
        pool = LbfgsState(*(t[:L] for t in _cat(chunks)))
        finished = np.zeros(L, bool)

        def pick_active():
            """W working lanes: live lanes first, padded with repeats of them."""
            live = np.where(~finished)[0]
            if len(live) >= W:
                return live[:W]
            return np.concatenate([live, live[np.arange(W - len(live)) % len(live)]])

        def flush(pool, active, ws):
            # write each lane back once: its first row (duplicates carry its state)
            lanes, first = np.unique(active, return_index=True)
            ids = sync(torch.as_tensor, lanes, device=dev)
            pos = sync(torch.as_tensor, first, device=dev)
            return LbfgsState(*(p.index_copy(0, ids, w[pos]) for p, w in zip(pool, ws)))

        active = pick_active()
        rows = sync(torch.as_tensor, active, device=dev)
        ws, (fun, prepare) = _gather(pool, rows), fun_on(rows)
        refills = steps = k = 0  # k: iterations of this working set
        while True:
            alive = (~ws.done) & (ws.n_iter < cap)
            finished[active[~sync(alive.cpu).numpy()]] = True
            new_active = None if finished.all() else pick_active()
            running = new_active is not None and np.array_equal(new_active, active)
            if _segment_ends(k, running):
                observe(active, ws)
            if new_active is None:
                with span("lbfgs.refill"):
                    return flush(pool, active, ws), refills, steps
            if not running:
                with span("lbfgs.refill"):
                    pool = flush(pool, active, ws)
                    active = new_active
                    rows = sync(torch.as_tensor, active, device=dev)
                    ws, (fun, prepare) = _gather(pool, rows), fun_on(rows)
                refills += 1
                k = 0
                continue
            new = lbfgs_step(fun, ws, self.opts, prepare)
            ws = LbfgsState(*(_sel(alive, a, b) for a, b in zip(new, ws)))
            steps += 1
            k += 1
