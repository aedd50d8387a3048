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
lane is still running.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import torch


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


def _strong_wolfe(eval_fd, t, d, f, g, gtd, opts: LbfgsOptions):
    """Per-lane strong-Wolfe search from t [L] along d [L, n], as the
    reference's single-evaluation-site state machine.  ``eval_fd(t)``
    evaluates every lane at x + t*d.  Returns (f_new, g_new, t, n_evals)."""
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
        if not bool(active.any()):
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
            1 + s["ls_iter"])


def _value_and_grad(fun: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fun(xg)
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


def lbfgs_init(fun, x0: torch.Tensor, opts: LbfgsOptions) -> LbfgsState:
    f0, g0 = _value_and_grad(fun, x0)
    L, n = x0.shape
    H = opts.history_size
    z = torch.zeros((L, H, n), dtype=x0.dtype, device=x0.device)
    ints = torch.zeros(L, dtype=torch.long, device=x0.device)
    return LbfgsState(x0.detach(), f0, g0, z, z.clone(),
                      torch.zeros((L, H), dtype=x0.dtype, device=x0.device),
                      ints, ints.clone(), ints + 1,
                      g0.abs().amax(-1) <= opts.tolerance_grad)


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


def lbfgs_step(fun, st: LbfgsState, opts: LbfgsOptions) -> LbfgsState:
    """One L-BFGS iteration for every lane (direction, line search, history
    and convergence update); the caller keeps it only for running lanes."""
    H = opts.history_size
    d = _direction(st, H)
    gtd = _dot(st.g, d)
    dd_break = gtd > -opts.tolerance_change
    t0 = torch.where(
        st.n_iter == 0,
        opts.lr * torch.clamp_max(1.0 / torch.clamp_min(st.g.abs().sum(-1), 1e-20), 1.0),
        torch.full_like(gtd, opts.lr))

    def eval_fd(t):
        return _value_and_grad(fun, st.x + t[:, None] * d)

    f_ls, g_ls, t_ls, ev_ls = _strong_wolfe(eval_fd, t0, d, st.f, st.g, gtd, opts)
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
        done=done)


def lbfgs_run(fun, x0: torch.Tensor, opts: LbfgsOptions, iter_cap: int | None = None
              ) -> Tuple[LbfgsState, int]:
    """Minimize every lane of ``fun(x [L, n]) -> [L]`` from x0 [L, n].
    Returns the final state and the number of lockstep iterations run."""
    cap = opts.max_iter if iter_cap is None else min(opts.max_iter, int(iter_cap))
    st = lbfgs_init(fun, x0, opts)
    steps = 0
    while True:
        alive = (~st.done) & (st.n_iter < cap)
        if not bool(alive.any()):
            return st, steps
        new = lbfgs_step(fun, st, opts)
        st = LbfgsState(*(_sel(alive, a, b) for a, b in zip(new, st)))
        steps += 1


class BatchedLbfgs:
    """``fun(params, lane, shared) -> [L]`` minimized independently for every
    lane (counterpart of ``BatchedLbfgs``, ``lbfgs.py:475-851``).

    ``params`` is a dict of tensors with a leading lane axis; ``lane``
    tensors carry the lane axis too, ``shared`` ones do not.  The parameters
    are flattened per lane in sorted key order (the reference's
    ``ravel_pytree`` order).  ``iter_cap`` caps each lane's iterations below
    ``opts.max_iter``; ``last_run_stats`` reports the work of the last run.
    """

    def __init__(self, fun, opts: LbfgsOptions):
        self.fun = fun
        self.opts = opts
        self.iter_cap = None
        self.last_run_stats: Dict[str, int] = {}

    def run(self, params0: Dict[str, torch.Tensor], lane: Dict[str, torch.Tensor],
            shared: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], LbfgsResult]:
        keys = sorted(params0)
        L = params0[keys[0]].shape[0]
        shapes = [params0[k].shape[1:] for k in keys]
        sizes = [int(torch.Size(s).numel()) for s in shapes]

        def unflatten(x):
            return {k: p.reshape((L,) + tuple(s))
                    for k, p, s in zip(keys, torch.split(x, sizes, dim=1), shapes)}

        calls = [0]

        def fun(x):
            calls[0] += 1
            return self.fun(unflatten(x), lane, shared)

        x0 = torch.cat([params0[k].reshape(L, -1) for k in keys], dim=1).float()
        st, steps = lbfgs_run(fun, x0, self.opts, self.iter_cap)
        # lane_evals: evaluations the lanes used; device_evals: lane
        # evaluations run, since every closure call evaluates all L lanes
        self.last_run_stats = {"lanes": L, "iterations": steps,
                               "lane_evals": int(st.n_evals.sum()),
                               "device_evals": L * calls[0]}
        result = LbfgsResult(x=st.x, f=st.f, grad_norm=st.g.abs().amax(-1),
                             num_iters=st.n_iter, num_evals=st.n_evals)
        return {k: v.detach() for k, v in unflatten(st.x).items()}, result
