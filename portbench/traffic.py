"""The one traffic generator: a pool of batches of capture windows, made
from a traffic file's parameters, a configuration's marker layout and the
run's seed.

Window q of pool batch k takes its ground-truth, marker and prior seeds from
(seed, k, q), as ``chip_smoke.make_batch`` does from its ``seed0``, so a
seed gives the same pool on every machine, and two seeds give pools of the
same sizes.  Batch 0 warms the program up; the window solves batches 1,
2, ... in order, none twice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import generators as G


@dataclass
class Batch:
    """One solve's inputs: per window the ground truth and prior (float64
    dicts of pose_body, betas, root_orient, trans) and the markers as the
    program and the reference receive them (float32 [F, M, 3], zero where
    occluded; the program pads the columns to the configuration's)."""
    index: int
    gts: List[Dict[str, np.ndarray]]
    priors: List[Dict[str, np.ndarray]]
    markers: List[np.ndarray]

    @property
    def frames(self) -> int:
        return sum(m.shape[0] for m in self.markers)

    @property
    def markers_real(self) -> int:
        return self.markers[0].shape[1]


def window_seeds(seed: int, k: int, q: int) -> List[int]:
    """The ground-truth, marker and prior seeds of window q of batch k."""
    state = np.random.SeedSequence([int(seed) % 2**64, k, q]).generate_state(3)
    return [int(s) & 0x7FFFFFFF for s in state]


def make_batch(traffic: dict, config: dict, model64: Dict[str, torch.Tensor], faces: np.ndarray,
               seed: int, k: int) -> Batch:
    """Batch k of the pool.  ``model64``: ``body.model_tensors`` (float64,
    CPU)."""
    mk_cfg = config["markers"]
    vids = mk_cfg.get("vertex_ids")
    columns = int(mk_cfg["columns"])
    motion, noise = traffic["motion"], traffic["prior_noise"]
    gts, priors, markers = [], [], []
    for q in range(int(traffic["sequences_per_solve"])):
        s_gt, s_mk, s_pr = window_seeds(seed, k, q)
        gt = G.random_pose_sequence(int(traffic["frames"]), seed=s_gt, freq=float(motion["freq_hz"]),
                                    yaw=float(motion["yaw"]), travel=float(motion["travel"]))
        mk = G.generate_markers(model64, faces, gt, num_markers=columns, seed=s_mk,
                                occlusion_rate=float(traffic["occlusion_rate"]),
                                vertex_ids=None if vids is None else np.asarray(vids, np.int64),
                                surface_offset=float(mk_cfg["surface_offset_m"]))
        gts.append(gt)
        priors.append(G.perturb_params(gt, s_pr, pose_noise=float(noise["pose"]),
                                       trans_noise=float(noise["trans"]),
                                       betas_noise=float(noise["betas"])))
        markers.append(mk["points"].astype(np.float32))
    return Batch(k, gts, priors, markers)


def make_pool(traffic: dict, config: dict, model64: Dict[str, torch.Tensor], faces: np.ndarray,
              seed: int) -> List[Batch]:
    """Batches 0 .. ``pool_batches`` of the traffic file (0 is the warm-up)."""
    return [make_batch(traffic, config, model64, faces, seed, k)
            for k in range(int(traffic["pool_batches"]) + 1)]
