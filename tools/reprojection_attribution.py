#!/usr/bin/env python3
"""Where the batch solve with the reprojection stages goes astray when the
camera is 4.9 m from the body (ROADMAP C.12), and whether the JAX package
does the same.

``card`` (the port alone, on the GPU; imports no JAX): chip_smoke.py's
random batch with REPROJ_STAGE_CAMERA's streams (the crop camera
(0.04, 0, 0): 4.9 m) through ``MultiSequenceSolver(device="cuda")`` with the
batch phases' config and both reprojection stages at REPROJ_ITERS
iterations over REPROJ_ANGLES yaw seeds.  Prints each sequence's MPJPE after
the prior and every stage (reprojection_part, part, reprojection_full,
chamfer, marker, marker_final) and of the output, each lane's reprojection
and chamfer metrics, iterations and evaluations and each sequence's chosen
seed, and names the first stage after which a sequence is past
MPJPE_GATE_MM and the stage that adds the most to its error, and the worst
sequence.  Then it saves both reprojection stages' inputs and results for
every sequence (its REPROJ_ANGLES lanes, the generating joints beside them)
as ``<out>/<stage>_seq<q>.npz`` and runs the port's stage again on the card
from each file.

``cpu`` (both packages on the CPU): one saved stage alone, the JAX
``ReprojectionStage`` and the port's on the same lanes, iterations and all
of the saved frames, and the JAX stage again on the markers scaled by
1 + 1e-6.  Prints
per lane the final metrics, the iterations and evaluations, the output
angle, the root and trans against the reference's, the output's MPJPE, and
the card's figures from the file; then each package's chosen seed, the
reference's own move, and the wall time.

    python3 tools/reprojection_attribution.py card [--out runs/reprojection_attribution]
    JAX_PLATFORMS=cpu python3 tools/reprojection_attribution.py cpu \\
        --inputs runs/reprojection_attribution/reprojection_full_seq3.npz
"""
from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import chip_smoke as C  # noqa: E402

STAGES = ("reprojection_part", "reprojection_full")
# the stage's arguments in call order (ReprojectionStage.lanes)
ARGS = ("angles", "markers", "weights", "o_pose_body", "betas0", "hmr_betas", "hmr_root_orient",
        "trans0", "pred_cam", "cam_center", "cam_size", "cam_scale", "img_mask")
SCALE = 1 + 1e-6


def reprojection_config():
    """The batch phases' config with both reprojection stages on (the
    reprojection phase's)."""
    cfg = C.bench_parallel_config()
    for key in STAGES:
        cfg["stages"][key].update(num_iters=C.REPROJ_ITERS, num_angles=C.REPROJ_ANGLES)
    return cfg


def joints22(model, pose, betas, root, trans):
    """[F, 22, 3] body joints of one sequence's parameters (any device);
    betas [10], [1, 10] or [F, 10]."""
    import torch

    from uuo_mocap_tpu_torch.body.model import lbs_forward

    dev = model.device
    t = [a.to(dev, torch.float32) if isinstance(a, torch.Tensor)
         else torch.as_tensor(np.array(a, np.float32), device=dev) for a in (pose, betas, root, trans)]
    F = t[0].shape[0]
    t[1] = t[1].reshape(-1, 10).expand(F, 10)
    with torch.no_grad():
        return lbs_forward(model, *t)["joints"][:, :22].cpu().numpy()


def mpjpe_mm(j, j_gt) -> float:
    return float(np.linalg.norm(j - j_gt, axis=-1).mean()) * 1e3


def card(out_dir: str) -> int:
    import torch

    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.parallel.batch_solver import MultiSequenceSolver
    from uuo_mocap_tpu_torch.pipeline.reprojection import ReprojectionStage

    if not torch.cuda.is_available():
        print("card: no CUDA device", file=sys.stderr)
        return 1
    gpu = C.gpu_line()
    print(gpu, flush=True)
    t_start = time.time()
    model = synthetic_body_model(device="cuda")
    cfg = reprojection_config()
    gts, preps = C.make_batch(model, camera=C.REPROJ_STAGE_CAMERA)
    Q, A = len(preps), C.REPROJ_ANGLES
    solver = MultiSequenceSolver(model, cfg, device="cuda")
    stage = solver._reproj = ReprojectionStage(model, cfg, "reprojection_part")
    calls, lanes = [], stage.lanes

    def recorded(*args):
        out = lanes(*args)
        res = stage.last_result
        calls.append({"args": [a.detach().cpu().numpy() for a in args],
                      "out": {k: out[k].detach().cpu().numpy() for k in ("betas", "root_orient",
                                                                          "trans", "output_angle")},
                      "metrics": {k: v.cpu().numpy() for k, v in out["metrics"].items()},
                      "iters": res.num_iters.cpu().numpy(), "evals": res.num_evals.cpu().numpy(),
                      "loss": res.f.cpu().numpy()})
        return out

    stage.lanes = recorded
    t0 = time.time()
    out = solver.solve_prepared(preps, save_stages=True)
    print(f"solve: {time.time() - t0:.2f} s; stage times (s) {out['stage_times_s']}", flush=True)
    if len(calls) != 2:
        print(f"expected one call per reprojection stage, got {len(calls)}", file=sys.stderr)
        return 1

    gt_j = [joints22(model, g.pose_body, g.betas, g.root_orient, g.trans) for g in gts]
    chosen = {}
    for name, call in zip(STAGES, calls):
        met = {k: v.reshape(Q, A) for k, v in call["metrics"].items()}
        chosen[name] = np.argmin(met["reproject"], axis=1)
        for q in range(Q):
            sl = slice(q * A, (q + 1) * A)
            print(f"{name} sequence {q}: reproject {met['reproject'][q].tolist()}, chamfer "
                  f"{met['chamfer'][q].tolist()}, chosen seed {int(chosen[name][q])}, iterations "
                  f"{call['iters'][sl].tolist()}, evaluations {call['evals'][sl].tolist()}, "
                  f"loss {call['loss'][sl].tolist()}", flush=True)

    table = []  # per sequence: [(stage, MPJPE mm)]
    for q, (p, r) in enumerate(zip(preps, out["results"])):
        rows = [("prior", mpjpe_mm(joints22(model, p.o_pose_body, p.o_betas, p.o_root_orient,
                                            p.o_trans), gt_j[q]))]

        def stage_row(name, params):
            rows.append((name, mpjpe_mm(joints22(model, *params), gt_j[q])))

        for name, call in zip(STAGES, calls):
            lane = q * A + int(chosen[name][q])
            o = call["out"]
            if name == "reprojection_full" and "part" in r["stages"]:
                s = r["stages"]["part"]
                stage_row("part", (s["pose_body"], s["betas"], s["root_orient"], s["trans"]))
            stage_row(name, (p.o_pose_body, o["betas"][lane].mean(0), o["root_orient"][lane],
                             o["trans"][lane]))
        for name in ("chamfer", "marker", "marker_final"):
            s = r["stages"][name]
            stage_row(name, (s["pose_body"], s["betas"], s["root_orient"], s["trans"]))
        stage_row("output", (r["pose_body"], r["betas"], r["root_orient"], r["trans"]))
        table.append(rows)
        past = next((n for n, e in rows[1:] if e > C.MPJPE_GATE_MM), None)
        worst_step = max(range(1, len(rows) - 1), key=lambda i: rows[i][1] - rows[i - 1][1])
        print(f"sequence {q} MPJPE (mm) per stage: "
              + ", ".join(f"{n} {e:.3f}" for n, e in rows)
              + f"; first stage past {C.MPJPE_GATE_MM} mm: {past}; largest rise: "
              f"{rows[worst_step][0]} (+{rows[worst_step][1] - rows[worst_step - 1][1]:.3f} mm)",
              flush=True)
    print(json.dumps({"mpjpe_mm_per_stage": [dict(rows) for rows in table],
                      "best_hypothesis": out["best_hypothesis"].tolist()}), flush=True)

    print(f"worst sequence: {int(np.argmax([rows[-1][1] for rows in table]))}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    for (name, call), q in itertools.product(zip(STAGES, calls), range(Q)):
        sl = slice(q * A, (q + 1) * A)
        path = os.path.join(out_dir, f"{name}_seq{q}.npz")
        np.savez(path, **{a: v[sl] for a, v in zip(ARGS, call["args"])},
                 **{f"card_{k}": v[sl] for k, v in call["out"].items()},
                 **{f"card_metric_{k}": v[sl] for k, v in call["metrics"].items()},
                 card_iters=call["iters"][sl], card_evals=call["evals"][sl],
                 gt_joints=gt_j[q], num_iters=C.REPROJ_ITERS, sequence=q, gpu=gpu)
        # the port's stage alone on the card from the saved file
        z = np.load(path)
        alone = ReprojectionStage(model, cfg, "reprojection_part")
        o = alone.lanes(*(torch.as_tensor(z[a], device="cuda") for a in ARGS))
        res = alone.last_result
        met = {k: v.cpu().numpy() for k, v in o["metrics"].items()}
        print(f"{name} alone on the card, sequence {q} ({path}): reproject "
              f"{met['reproject'].tolist()}, chamfer {met['chamfer'].tolist()}, iterations "
              f"{res.num_iters.tolist()}, evaluations {res.num_evals.tolist()}, chosen seed "
              f"{int(np.argmin(met['reproject']))}; max |alone - in the solve|: trans "
              f"{np.abs(o['trans'].cpu().numpy() - z['card_trans']).max():.3g}, root "
              f"{np.abs(o['root_orient'].cpu().numpy() - z['card_root_orient']).max():.3g}",
              flush=True)
    print(f"wall time {time.time() - t_start:.1f} s", flush=True)
    return 0


def cpu(path: str) -> int:
    import jax
    import jax.numpy as jnp
    import torch

    import uuo_mocap_tpu.pipeline.reprojection as jrep
    from uuo_mocap_tpu.body.synthetic import synthetic_body_model as jax_synthetic_body_model
    from uuo_mocap_tpu.data.config import load_config as jax_load_config
    from uuo_mocap_tpu_torch.convert import body_model_arrays, body_model_from_numpy
    from uuo_mocap_tpu_torch.pipeline.reprojection import ReprojectionStage

    t_start = time.time()
    z = np.load(path)
    cut = {a: z[a] for a in ARGS}
    print(f"{path}: sequence {int(z['sequence'])}, {len(z['angles'])} lanes x "
          f"{z['markers'].shape[1]} frames, {int(z['num_iters'])} iterations; the card's run: "
          f"{z['gpu']}", flush=True)
    cfg = jax_load_config(os.path.join(HERE, "configs", "video_mocap.yaml"))
    cfg["stages"]["reprojection_part"]["num_iters"] = int(z["num_iters"])
    jm = jax_synthetic_body_model()
    tm = body_model_from_numpy(body_model_arrays(jm), device="cpu")

    # the reference's iteration counts, read out of its jitted stage (under
    # its vmap the callback runs once per lane, in lane order)
    counts = []
    minimize = jrep.lbfgs_minimize

    def counted(fun, params0, opts):
        p_opt, res = minimize(fun, params0, opts)
        jax.debug.callback(lambda n, e: counts.append((np.asarray(n), np.asarray(e))),
                           res.num_iters, res.num_evals)
        return p_opt, res

    jrep.lbfgs_minimize = counted
    ref_stage = jrep.ReprojectionStage(jm, cfg, "reprojection_part")

    def run_ref(scale):
        args = dict(cut, markers=cut["markers"] * np.float32(scale))
        t0 = time.time()
        counts.clear()
        o = ref_stage.lanes(*(jnp.asarray(args[a]) for a in ARGS))
        o = jax.tree_util.tree_map(np.asarray, o)
        jax.effects_barrier()
        n, e = (np.stack(c).reshape(-1) for c in zip(*counts))
        print(f"reference x{scale}: {time.time() - t0:.1f} s", flush=True)
        return o, n, e

    ref, ref_n, ref_e = run_ref(1.0)
    t0 = time.time()
    port_stage = ReprojectionStage(tm, copy.deepcopy(cfg), "reprojection_part")
    ours = port_stage.lanes(*(torch.as_tensor(cut[a]) for a in ARGS))
    ours = {k: (v.numpy() if k != "metrics" else {m: x.numpy() for m, x in v.items()})
            for k, v in ours.items()}
    print(f"port: {time.time() - t0:.1f} s", flush=True)
    moved, _, _ = run_ref(SCALE)
    gt = z["gt_joints"]
    pose = cut["o_pose_body"]
    L = len(cut["angles"])

    def err(o, i):
        return mpjpe_mm(joints22(tm, pose[i], o["betas"][i].mean(0), o["root_orient"][i],
                                 o["trans"][i]), gt)

    for i in range(L):
        for tag, o, n, e in (("reference", ref, ref_n[i], ref_e[i]),
                             ("port", ours, port_stage.last_result.num_iters[i].item(),
                              port_stage.last_result.num_evals[i].item())):
            print(f"lane {i} (seed {cut['angles'][i]:.4f}) {tag}: reproject "
                  f"{o['metrics']['reproject'][i]:.9g}, chamfer {o['metrics']['chamfer'][i]:.9g}, "
                  f"iterations {int(n)}, evaluations {int(e)}, output angle "
                  f"{float(np.ravel(o['output_angle'][i])[0]):.6f}, max |root - reference's| "
                  f"{np.abs(o['root_orient'][i] - ref['root_orient'][i]).max():.3g}, max |trans - "
                  f"reference's| {np.abs(o['trans'][i] - ref['trans'][i]).max():.3g}, MPJPE "
                  f"{err(o, i):.3f} mm", flush=True)
        print(f"lane {i} card: reproject {float(z['card_metric_reproject'][i]):.9g}, chamfer "
              f"{float(z['card_metric_chamfer'][i]):.9g}, iterations {int(z['card_iters'][i])}, "
              f"evaluations {int(z['card_evals'][i])}, max |trans - reference's| "
              f"{np.abs(z['card_trans'][i] - ref['trans'][i]).max():.3g}", flush=True)
        print(f"lane {i} reference's own move under x{SCALE}: reproject "
              f"{abs(moved['metrics']['reproject'][i] - ref['metrics']['reproject'][i]):.3g}, "
              f"root {np.abs(moved['root_orient'][i] - ref['root_orient'][i]).max():.3g}, trans "
              f"{np.abs(moved['trans'][i] - ref['trans'][i]).max():.3g}", flush=True)
    seeds = {tag: int(np.argmin(o["metrics"]["reproject"])) for tag, o in
             (("reference", ref), ("port", ours), ("reference x1+1e-6", moved))}
    seeds["card"] = int(np.argmin(z["card_metric_reproject"]))
    print(f"chosen seeds: {seeds}", flush=True)
    b = seeds["reference"]
    for tag, trans, root in (("port", ours["trans"][b], ours["root_orient"][b]),
                             ("card", z["card_trans"][b], z["card_root_orient"][b])):
        d_t, d_r = np.abs(trans - ref["trans"][b]).max(), np.abs(root - ref["root_orient"][b]).max()
        m_t = np.abs(moved["trans"][b] - ref["trans"][b]).max()
        m_r = np.abs(moved["root_orient"][b] - ref["root_orient"][b]).max()
        print(f"the chosen lane, {tag} against the reference: trans {d_t:.3g} (twice the "
              f"reference's move {2 * m_t:.3g}), root {d_r:.3g} (twice {2 * m_r:.3g})", flush=True)
    print(f"wall time {time.time() - t_start:.1f} s", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("card")
    c.add_argument("--out", default=os.path.join(HERE, "runs", "reprojection_attribution"))
    p = sub.add_parser("cpu")
    p.add_argument("--inputs", required=True)
    args = ap.parse_args()
    return card(args.out) if args.mode == "card" else cpu(args.inputs)


if __name__ == "__main__":
    sys.exit(main())
