#!/usr/bin/env python3
"""Time the Hopper kernels of several trees in turns on one GPU.

    python3 tools/bench_kernels.py [--tree LABEL=DIR ...] [--diagnose]

Each tree's ``uuo_mocap_tpu_torch/ops/chamfer_kernels.py`` is loaded by
path and builds its own ``csrc/chamfer.cu``; this checkout is the tree
``this``, and another one (for example the parent commit's
``uuo_mocap_tpu_torch`` unpacked from ``git archive`` into a directory that
.gitignore lists) is named with ``--tree parent=DIR``.  On chip_smoke.py's
inputs at the main path's shapes (rank at L = 4 without bias and at L = 8
with the subtree bias, F = 450, M = 41, V = 6890; the forward at B = 3600
in both directions, 41 markers against 6890 vertices and back; the
backward at B = 1800) each kernel is timed through its wrapper, output
allocation included, with CUDA events over ``TIMING_ITERS`` launches: the
trees in the order given, then reversed (parent, this, this, parent), with
``index_add_`` and a zero fill of the same bytes beside the backward.
Prints the nvidia-smi line before and after, one JSON line per timing, the
picks' agreement with this tree and the largest gap in squared distance
between a tree's pick and this tree's, in m^2 (for the forward also the
largest value difference), and the mean of each tree's timings.
``--diagnose`` adds copies of this tree with one part of a kernel taken
out (``DIAGNOSTICS``), to show where its time goes.  Imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

TIMING_ITERS = 50  # launches per timing
FORWARD_CASES = ("forward", "reverse")  # these return (value, index)


# --diagnose: copies of this tree's kernel source with one part of a kernel
# taken out, timed beside it to show where its time goes (their picks are
# wrong by design).  The rank pass and the few-query forward share the
# staged kernel, so its variants show in both cases.
# name -> (what is taken out, substitutions)
DIAGNOSTICS = {
    "staged_no_scan": ("the staged kernel's scan (left: copy, centroid, rewrite, final reduce)", [(
        "for (int item = warp; item < groups * splits; item += nwarps) {",
        "for (int item = warp + (1 << 30); item < groups * splits; item += nwarps) {")]),
    "staged_no_copy": ("the staged kernel's HBM copy (the scan reads stale shared memory)", [(
        "cp_async16(s_f + R + head + 4 * i, tc + head + 4 * i);", "(void)i;")]),
    "staged_2fma": ("one of the staged kernel's three FMAs per pair", [(
        "return fmaf(qx, t.x, fmaf(qy, t.y, fmaf(qz, t.z, t.w)));",
        "return fmaf(qx, t.x, fmaf(qy, t.y, t.w));")]),
    "staged_fadd": ("the staged kernel's min per pair (an add in its place)", [(
        "gmin[i] = fminf(gmin[i], rank_key(qx[i], qy[i], qz[i], tt));",
        "gmin[i] = gmin[i] + rank_key(qx[i], qy[i], qz[i], tt);")]),
    "many_no_scan": ("the many-query kernel's scan (left: loads, staging, stores)", [(
        "for (int i = 0; i < n; ++i) {\n        const float4 tt = s_t[i];",
        "for (int i = n; i < n; ++i) {\n        const float4 tt = s_t[i];")]),
    "many_no_load": ("the many-query kernel's 16-byte query loads (constant queries)", [(
        "const float4 a = qp[i];", "const float4 a = make_float4(i, 0.5f, 0.25f, i);")]),
    "many_min_only": ("the many-query kernel's index tracking (a min in place of the select)", [(
        "          if (d < best[j]) {\n            best[j] = d;\n            bi[j] = v0 + i;\n          }",
        "          best[j] = fminf(best[j], d);")]),
}


def diagnostic_tree(name: str) -> str:
    """A copy of this tree's port package under its _build directory with
    DIAGNOSTICS[name] applied to csrc/chamfer.cu; returns the tree's root."""
    root = os.path.join(HERE, "uuo_mocap_tpu_torch", "_build", "diagnose", name)
    pkg = os.path.join(root, "uuo_mocap_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "uuo_mocap_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(pkg, "csrc", "chamfer.cu")
    with open(src) as f:
        text = f.read()
    for old, new in DIAGNOSTICS[name][1]:
        if old not in text:
            raise RuntimeError(f"{name}: the kernel source no longer contains {old!r}")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return root


def load_kernels(label: str, tree: str):
    """The tree's chamfer_kernels module, built; a module of its own per tree."""
    path = os.path.join(tree, "uuo_mocap_tpu_torch", "ops", "chamfer_kernels.py")
    spec = importlib.util.spec_from_file_location(f"chamfer_kernels_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.time()
    mod.build()
    print(f"{label}: built {mod.SOURCE} in {time.time() - t0:.2f} s", flush=True)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                    help="another checkout to time beside this one")
    ap.add_argument("--diagnose", action="store_true",
                    help="also time this tree's kernels with parts taken out (DIAGNOSTICS)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from chip_smoke import (FLOPS_PER_PAIR, backward_inputs, bound, forward_inputs, gpu_line,
                            index_add_call, make_sequence, pick_gap, rank_inputs, time_ms)
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.ops.chamfer_kernels import ptxas_usage

    print(f"gpu: {gpu_line()}", flush=True)
    trees = [("this", HERE)] + [tuple(t.split("=", 1)) for t in args.tree]
    if args.diagnose:
        for name, (what, _) in DIAGNOSTICS.items():
            print(f"{name}: without {what}", flush=True)
            trees.append((name, diagnostic_tree(name)))
    mods = {label: load_kernels(label, tree) for label, tree in trees}
    for label, mod in mods.items():
        for u in ptxas_usage(mod._Library.log):
            print(f"  {label} ptxas: {u['kernel']}: {u['registers']} registers, spill "
                  f"{u['spill_stores']} / {u['spill_loads']} B", flush=True)

    model = synthetic_body_model(device="cuda")
    gt, markers, _ = make_sequence(model)
    V = model.num_vertices
    cases, gaps, n_targets = {}, {}, {}
    for L, with_bias in ((4, False), (8, True)):
        mk, verts, bias = rank_inputs(model, gt, markers, L, with_bias)
        F, M = mk.shape[1], mk.shape[2]
        B = L * F
        nbytes = (mk.numel() + verts.numel() + (0 if bias is None else bias.numel()) + B * M) * 4
        cases[f"rank_L{L}"] = (lambda K, a=(mk, verts, bias): K.rank_nearest_cuda(*a),
                               bound(nbytes, B * M * V * FLOPS_PER_PAIR))
        bb = None if bias is None else bias[:, None, :].expand(L, F, V).reshape(B, V)
        n_targets[f"rank_L{L}"] = V
        gaps[f"rank_L{L}"] = lambda a, b, q=mk.reshape(B, M, 3), t=verts.reshape(B, V, 3), bb=bb: \
            float(pick_gap(q, t, bb, a.reshape(q.shape[:2]), b.reshape(q.shape[:2])).max())
    x, fverts, vbias, mbias = forward_inputs(model, gt, markers)
    B, M = x.shape[0], x.shape[1]
    for case, q, t, b in zip(FORWARD_CASES, (x, fverts), (fverts, x), (vbias, mbias)):
        Mq, Vt = q.shape[1], t.shape[1]
        cases[case] = (lambda K, a=(q, t, b): K.min_sqdist_forward_cuda(*a),
                       bound((q.numel() + t.numel() + b.numel()) * 4 + B * Mq * 8,
                             B * Mq * Vt * FLOPS_PER_PAIR))
        gaps[case] = lambda a, b_, q=q, t=t, bb=b: float(pick_gap(q, t, bb, a, b_).max())
        n_targets[case] = Vt
    idx, diff, gw = backward_inputs(V)
    B, M = idx.shape
    cases["backward"] = (lambda K: K.min_sqdist_backward_cuda(idx, diff, gw, V),
                         bound(B * M * 20 + B * V * 16, B * M * 4))

    order = [label for label, _ in trees]
    order = order + order[::-1]
    # a process's first timed launches run slow (rank L=4 on an H100: 0.1912
    # ms against 0.1784 ms later in the same process): one untimed round
    # before any timing
    first_call = next(iter(cases.values()))[0]
    time_ms(lambda: first_call(mods["this"]), TIMING_ITERS)
    summary = {}
    for case, (call, (b_ms, b_by)) in cases.items():
        ref = call(mods["this"])
        for label in order:
            out = call(mods[label])
            if case != "backward":
                picks, ref_picks = (out[1], ref[1]) if case in FORWARD_CASES else (out, ref)
                same = {"agreement_with_this": float((picks == ref_picks).float().mean()),
                        # a diagnostic copy's picks may lie outside [0, V)
                        "max_gap_from_this_m2": gaps[case](picks, ref_picks)
                        if bool(((picks >= 0) & (picks < n_targets[case])).all()) else None}
                if case in FORWARD_CASES:
                    same["max_value_diff_from_this"] = float((out[0] - ref[0]).abs().max())
            else:
                same = {"max_diff_from_this": float(max((a - r).abs().max()
                                                        for a, r in zip(out, ref)))}
            ms = time_ms(lambda: call(mods[label]), TIMING_ITERS)
            rec = dict(case=case, tree=label, ms=ms, bound_ms=b_ms, bound_by=b_by,
                       share_of_bound=b_ms / ms, **same)
            print(json.dumps(rec), flush=True)
            summary.setdefault(case, {}).setdefault(label, []).append(ms)
        if case == "backward":
            lib_ms = [time_ms(index_add_call(idx, diff, gw, V), TIMING_ITERS) for _ in range(2)]
            print(json.dumps(dict(case=case, tree="index_add_", ms=sum(lib_ms) / 2,
                                  runs=lib_ms)), flush=True)
            summary[case]["index_add_"] = lib_ms
            # the floor of writing the outputs: one zero fill of the same bytes
            zeros_ms = [time_ms(lambda: torch.zeros((B * V, 4), device="cuda"), TIMING_ITERS)
                        for _ in range(2)]
            print(json.dumps(dict(case=case, tree="zeros", ms=sum(zeros_ms) / 2, runs=zeros_ms)),
                  flush=True)
            summary[case]["zeros"] = zeros_ms
    for case, by_tree in summary.items():
        this = sum(by_tree["this"]) / len(by_tree["this"])
        cells = ", ".join(f"{label} {sum(v) / len(v):.4f} ms ({sum(v) / len(v) / this:.2f}x this)"
                          for label, v in by_tree.items())
        print(f"{case}: {cells}; bound {cases[case][1][0]:.4f} ms", flush=True)
    print(f"gpu: {gpu_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
