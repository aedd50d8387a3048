#!/usr/bin/env python3
"""Does frame-bucket padding change network-mode segmentation?

    python3 tools/network_padding_check.py [--seeds 0 1 2 3] [--frames 450] [--cpu]

Exports chip_smoke.py's CLI-phase data (``export_synthetic_c3d``: 41
random-vertex markers, no occlusion, the perturbed prior pkl) into a
temporary directory, loads each sequence as ``cli.test`` loads it, and
prepares it two ways: padded to the 64-frame bucket as ``cli.test --batch``
pads it (450 -> 512; the padded frames carry no markers), and without the
bucket.  On each it segments as the reference's batch solve does
(``uuo_mocap_tpu/parallel/batch_solver.py:317-331``: the multimodal
segmenter on every frame it is given, padding included, with the prior's
joints; the per-marker mode; the left/right merge; the chains) and as the
port does (``network_segmentation``: the real frames only).  Prints per
sequence, for the reference's way, the count of markers whose merged label
the padding changes, the share of real frames whose labels it changes, the
chains both ways and the accuracy of the per-marker mode against the
generating vertices' parts; and whether the port's labels, merged labels
and chains are the same padded and unpadded.  Runs on the card unless
``--cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--frames", type=int, default=450)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()

    import numpy as np
    import torch

    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.cli import export_synthetic_c3d
    from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
    from uuo_mocap_tpu_torch.data.markers import Markers
    from uuo_mocap_tpu_torch.data.markers_synthetic import MarkersSynthetic
    from uuo_mocap_tpu_torch.data.pkl_io import load_pkl
    from uuo_mocap_tpu_torch.pipeline.multimodal import (
        _mode_per_column, network_segmentation, prepare_sequence)
    from uuo_mocap_tpu_torch.pipeline.segmentation import (
        chains_from_labels, merge_symmetric_labels, segment_markers_network)
    from uuo_mocap_tpu_torch.pipeline.stages import SmplParams, _forward

    device = "cpu" if args.cpu else "cuda"
    model = synthetic_body_model(device=device)
    part_of = model.vertex_part_labels().cpu().numpy()
    ckpt = os.path.join(HERE, "checkpoints")
    F_pad = -(-args.frames // 64) * 64
    rows = []
    with tempfile.TemporaryDirectory(prefix="network_padding_") as d:
        for seed in args.seeds:
            ds = f"s{seed}"
            export_synthetic_c3d.main(["--input_dir", d, "--dataset", ds, "--sequences", "seq",
                                       "--num_frames", str(args.frames), "--seed", str(seed)]
                                      + (["--cpu_only"] if args.cpu else []))
            base = os.path.join(d, ds)
            markers = Markers(os.path.join(base, f"mocap_synthetic___{seed}_41", "s1", "seq.c3d"))
            img = ImgSmpl(load_pkl(os.path.join(base, "comparisons", "4d_humans", "s1", "seq",
                                                "results", "demo_seq.pkl")), 30.0)
            truth = part_of[MarkersSynthetic(model, num_frames=args.frames, num_markers=41,
                                             seed=seed).vertex_ids]
            def dev(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=device)

            ref, port = {}, {}
            for name, prep in (("padded", prepare_sequence(img, markers, offset=0,
                                                           pad_to_frames=F_pad)),
                               ("unpadded", prepare_sequence(img, markers, offset=0,
                                                             frame_bucket=None))):
                prior = SmplParams(dev(prep.o_pose_body), dev(prep.o_betas),
                                   dev(prep.o_root_orient), dev(prep.o_trans))
                with torch.no_grad():
                    joints = _forward(model, prior)["joints"][:, :22]
                labels = segment_markers_network(prep.markers, prep.mocap_freq, ckpt,
                                                 joints=joints, device=device)
                mode = _mode_per_column(labels)
                merged = merge_symmetric_labels(mode)
                ref[name] = (labels[:prep.F_real], merged,
                             chains_from_labels(merged, model.parents),
                             float((mode == truth).mean()))
                port[name] = network_segmentation(model, prep, ckpt)
            (lp, mp, cp, ap), (lu, mu, cu, au) = ref["padded"], ref["unpadded"]
            (pl, pm, pc), (ul, um, uc) = port["padded"], port["unpadded"]
            rows.append({"seed": seed, "frames": [args.frames, F_pad],
                         "reference_merged_labels_differ": int((mp != mu).sum()),
                         "reference_real_frame_labels_differ": round(float((lp != lu).mean()), 6),
                         "reference_chains_padded": [[int(j) for j in c] for c in cp],
                         "reference_chains_unpadded": [[int(j) for j in c] for c in cu],
                         "mode_accuracy_padded": round(ap, 4),
                         "mode_accuracy_unpadded": round(au, 4),
                         "port_same_padded_and_unpadded": bool(
                             np.array_equal(pl[:args.frames], ul) and np.array_equal(pm, um)
                             and pc == uc),
                         "port_unpadded_equals_reference_way": bool(
                             np.array_equal(ul, lu) and np.array_equal(um, mu) and uc == cu)})
            print(json.dumps(rows[-1]), flush=True)
    changed = sum(r["reference_merged_labels_differ"] > 0 for r in rows)
    print(json.dumps({"device": device, "sequences": len(rows),
                      "sequences_whose_merged_labels_change": changed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
