#!/usr/bin/env python3
"""The coarse-to-fine ranking (``optimizer.rank_hier``) against the exact
ranking, in both packages on the CPU, at the shape ``chip_smoke.py``'s
ranking-variant phase measures on the card: L = 16 yaw lanes of its
450 x 41 sequence (the first cull's shape, ``chip_smoke.rank_inputs``),
V = 6890.  Prints the share of equal picks of each package's
``hierarchical_nearest`` against its own exact ranking, the largest
squared-distance gap where they differ, and whether the two packages' picks
agree with each other: whether a disagreement seen on the card belongs to
the algorithm or to the port.

    JAX_PLATFORMS=cpu python3 tools/rank_hier_agreement.py [--lanes 16]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import chip_smoke as C  # noqa: E402


def gap_m2(mk, verts, a, b):
    """Largest |d2(pick a) - d2(pick b)| in float64 over [L, F, M] picks."""
    mk, verts = mk.astype(np.float64), verts.astype(np.float64)

    def d2(idx):
        picked = np.take_along_axis(verts, idx[..., None], axis=2)
        return ((mk - picked) ** 2).sum(-1)

    diff = a != b
    return float(np.abs(d2(a) - d2(b))[diff].max()) if diff.any() else 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=16)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from uuo_mocap_tpu.ops.rank_hier import build_rank_table as jax_build_rank_table
    from uuo_mocap_tpu.pipeline.stages import _ranked_nearest as jax_ranked_nearest
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.ops.chamfer_kernels import rank_nearest
    from uuo_mocap_tpu_torch.ops.rank_hier import build_rank_table, hierarchical_nearest

    model = synthetic_body_model(device="cpu")
    gt, markers, _ = C.make_sequence(model, device="cpu")
    mk, verts, _ = C.rank_inputs(model, gt, markers, args.lanes, False)
    L, F, M, V = mk.shape[0], mk.shape[1], mk.shape[2], verts.shape[2]
    template = model.v_template.cpu().numpy()
    table, jtable = build_rank_table(template), jax_build_rank_table(template)
    assert (np.array_equal(table.coarse_ids, jtable.coarse_ids)
            and np.array_equal(table.cand_ids, jtable.cand_ids)), "the tables differ"

    picks = {}
    t0 = time.time()
    with torch.no_grad():
        picks["port exact"] = rank_nearest(mk, verts).numpy()
        picks["port coarse-to-fine"] = hierarchical_nearest(mk, verts, table).numpy()
    print(f"port: {time.time() - t0:.1f} s", flush=True)
    exact = jax.jit(lambda m, v: jax_ranked_nearest(m, v))
    hier = jax.jit(lambda m, v: jax_ranked_nearest(m, v, table=jtable))
    mk_np, verts_np = mk.numpy(), verts.numpy()
    t0 = time.time()
    for name, fn in (("JAX exact", exact), ("JAX coarse-to-fine", hier)):
        picks[name] = np.stack([np.asarray(fn(jnp.asarray(mk_np[i]), jnp.asarray(verts_np[i])))
                                for i in range(L)]).astype(np.int64)
    print(f"JAX: {time.time() - t0:.1f} s", flush=True)

    print(f"L={L}, F={F}, M={M}, V={V}; table: {table.coarse_ids.shape[0]} centres, "
          f"{table.cand_ids.shape[1]} candidates per cell, top {table.top_p}")
    for a, b in (("port coarse-to-fine", "port exact"), ("JAX coarse-to-fine", "JAX exact"),
                 ("port coarse-to-fine", "JAX coarse-to-fine"), ("port exact", "JAX exact")):
        equal = picks[a] == picks[b]
        print(f"{a} against {b}: {float(equal.mean()):.6f} of picks equal "
              f"({int((~equal).sum())} of {equal.size} differ), largest d2 gap where they "
              f"differ {gap_m2(mk_np, verts_np, picks[a], picks[b]):.3e} m^2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
