"""Time one segmenter training step on the card, with the temporal
convolutions through cuDNN and in the GEMM form ``temporal_conv`` uses while
training, each eager and replayed as a CUDA graph, and show where an eager
cuDNN step's device time goes.

    python3 tools/train_step_profile.py [--steps 200] [--multimodal]

The step is ``models/train.py``'s: MANIFEST.json's recipe (latent 128,
batch 32, 41 markers, a pool of 192 motions x 512 vertices), Adam on the
cosine schedule.  Prints ms per step (CUDA-synchronised host clock, after 5
warm-up steps) and the profiler's top kernels by device time.  Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cudnn_conv(conv, x):
    """The convolution through cuDNN, also while the weights take gradients."""
    import torch

    return torch.relu(conv(x.transpose(1, 2))).transpose(1, 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200, help="timed steps per variant")
    ap.add_argument("--multimodal", action="store_true", help="the multimodal segmenter")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.models import marker_segmenter as MS
    from uuo_mocap_tpu_torch.models import train as T
    from uuo_mocap_tpu_torch.models.marker_segmenter_multimodal import MarkerSegmenterMultimodal

    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    body = synthetic_body_model(device="cuda")
    pool = T.segmentation_pool(body, 192, 512, seed=41)
    gemm_conv = MS.temporal_conv

    def make_step():
        net = (MarkerSegmenterMultimodal(128) if args.multimodal else MS.MarkerSegmenter(128))
        net = T.flax_init_(net, 0).cuda()
        params = list(net.parameters())
        opt = T.Adam(params, T.cosine_decay(1e-3, 6000), 6000)
        gen = torch.Generator(device="cuda").manual_seed(1)

        def step():
            loss = T._backward(params, T.segmenter_loss(
                net, pool, T.segmenter_draws(gen, pool, 32, 41), args.multimodal))
            opt.step()
            return loss
        return step, gen

    def ms_per_step(run, n):
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            out = run()
        float(out)
        return (time.time() - t0) / n * 1e3

    for label, conv in (("cuDNN convolution", cudnn_conv), ("GEMM form", gemm_conv)):
        MS.temporal_conv = conv
        step, _ = make_step()
        eager = ms_per_step(step, max(args.steps // 5, 10))
        step, gen = make_step()
        graphed = ms_per_step(T._GraphedStep(step, gen), args.steps)
        print(f"{label}: {eager:.3f} ms/step eager, {graphed:.3f} ms/step as a CUDA graph",
              flush=True)

    MS.temporal_conv = cudnn_conv
    step, _ = make_step()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    print("5 eager steps with the cuDNN convolution:")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12), flush=True)
    MS.temporal_conv = gemm_conv
    return 0


if __name__ == "__main__":
    sys.exit(main())
