#!/usr/bin/env python3
"""How far the JAX package's own batch solve moves when its markers are
scaled by float32-sized amounts, beside how far the port's solve lands from
it (ROADMAP C.15), on the CPU at the batch-option tests' size and settings
(``tests/test_torch_batch_options.py``: 2 x 16 x 20, 5-iteration stages;
the JAX settings of the repository's ``conftest.py``, since the descents
amplify float32 noise and a compile setting changes it).

``spread CASE`` (learned or reprojection, the cases whose free solves part
from the reference beyond the protocol): the case's reference solve, the
port's free solve and the reference's solves on its markers scaled by each
of the tests' SPREAD.  Per sequence, snapshot and parameter: the port's max
|port - reference| and each scaled solve's max |scaled - reference|; per
scaling, the marker labels that move (and whether they are the entries the
port's move) and the winners.

``sdf``: the learned case's first SDF marker stage (lanes = sequence x
surviving hypothesis) from the reference's own inputs, capped at 3 and at
5 iterations in both packages, and the reference's stage again on those
markers scaled by 1 + k 1e-7 (k = -10..10): max |difference| per output of
the descent (the virtual points among them) and the evaluations.

    python3 tools/batch_options_spread.py spread learned
    python3 tools/batch_options_spread.py sdf
"""
from __future__ import annotations

import argparse
import copy
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP

import conftest  # noqa: E402,F401  (the tests' JAX settings: their float32 noise is theirs)
import numpy as np  # noqa: E402

import test_torch_batch_options as T  # noqa: E402
from test_torch_batch_solver import make_batch  # noqa: E402
from uuo_mocap_tpu.body.synthetic import synthetic_body_model  # noqa: E402
from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy  # noqa: E402


def models():
    """Both packages' synthetic body, the port's carried over by convert.py."""
    jm = synthetic_body_model()
    return jm, body_model_from_numpy(body_model_arrays(jm), device="cpu")


def spread(name: str) -> int:
    jm, tm = models()
    batch = make_batch(jm)
    t0 = time.time()
    case = T.Case(name, (jm, tm), batch)
    print(f"reference, free and lockstep solves: {time.time() - t0:.1f} s", flush=True)
    for scale in T.SPREAD:
        t0 = time.time()
        out, _ = case.scaled(scale)
        moved = [o["markers_labels"] != r["markers_labels"]
                 for o, r in zip(out["results"], case.ref["results"])]
        print(f"reference x{scale:.7f}: {time.time() - t0:.1f} s; labels moved per sequence "
              + str([int(m.sum()) for m in moved]) + ", the port's entries "
              + str([bool((m == (o["markers_labels"] != r["markers_labels"])).all())
                     for m, o, r in zip(moved, case.free["results"], case.ref["results"])])
              + f"; winners {out['best_hypothesis'].tolist()} (reference "
              f"{case.ref['best_hypothesis'].tolist()})", flush=True)
    print("port: labels moved per sequence "
          + str([int((o["markers_labels"] != r["markers_labels"]).sum())
                 for o, r in zip(case.free["results"], case.ref["results"])]))
    print("sequence snapshot parameter: port | each scaling's move (" +
          " ".join(f"x{s:.7f}" for s in T.SPREAD) + ")")
    for q in range(len(batch)):
        for what, o in T.param_sets(case.free, q):
            r = case.ref_snapshot(q, what)
            for k in T.PARAMS:
                moves = [float(np.abs(case.ref_snapshot(q, what, s)[k] - r[k]).max())
                         for s in T.SPREAD]
                print(f"{q} {what} {k}: {float(np.abs(o[k] - r[k]).max()):.4g} | "
                      + " ".join(f"{m:.4g}" for m in moves), flush=True)
    return 0


def sdf() -> int:
    import jax.numpy as jnp
    import torch

    import uuo_mocap_tpu.solver.lbfgs as jax_lbfgs
    import uuo_mocap_tpu_torch.solver.lbfgs as port_lbfgs
    from test_torch_batch_options_learned import last_descent
    from uuo_mocap_tpu.parallel.batch_solver import MultiSequenceSolver as JaxMultiSequenceSolver
    from uuo_mocap_tpu_torch.pipeline.stages import MarkerAttachment, SmplParams, SolveStages

    jm, tm = models()
    solver = JaxMultiSequenceSolver(jm, T.case_config("learned"))
    with T.recording(solver, []):
        solver.solve_prepared(T.case_preps(make_batch(jm), False, False))
    mk, wt, op, ob, params, att, fv = solver.sdf_inputs
    jst = solver.stages
    tst = SolveStages(tm, copy.deepcopy(T.case_config("learned")))

    def jax_args(scale):
        return [jnp.asarray(mk * np.float32(scale))] + [
            type(a)(*map(jnp.asarray, a)) if hasattr(a, "_fields") else jnp.asarray(a)
            for a in (wt, op, ob, params, att, fv)]

    def run_ref(scale):
        with last_descent(jax_lbfgs, {}) as out:
            _, res = jst.marker_stage_sdf_lanes(*jax_args(scale))
        return out, np.asarray(res.num_evals).tolist()

    def diff(a, b):
        return {k: float(f"{np.abs(a[k] - b[k]).max():.3g}") for k in b}

    for cap in (3, 5):
        jst._marker_solver_sdf.iter_cap = tst._marker_solver_sdf.iter_cap = cap
        ref, ref_evals = run_ref(1.0)
        with last_descent(port_lbfgs, {}) as ours:
            _, res = tst.marker_stage_sdf_lanes(
                *(torch.as_tensor(a) for a in (mk, wt, op, ob)),
                SmplParams(*map(torch.as_tensor, params)),
                MarkerAttachment(torch.as_tensor(att.vertex_ids).long(),
                                 torch.as_tensor(att.weights)), torch.as_tensor(fv))
        print(f"{cap} iterations: port against reference {diff(ours, ref)}; evaluations "
              f"reference {ref_evals}, port {res.num_evals.tolist()}", flush=True)
        for k in range(-10, 11):
            if k:
                moved, evals = run_ref(1 + k * 1e-7)
                print(f"{cap} iterations, reference x(1 {k:+d}e-7) against reference "
                      f"{diff(moved, ref)}; evaluations {evals}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    s = sub.add_parser("spread")
    s.add_argument("case", choices=T.FREE_SOLVE_PARTS)
    sub.add_parser("sdf")
    args = ap.parse_args()
    return spread(args.case) if args.mode == "spread" else sdf()


if __name__ == "__main__":
    sys.exit(main())
