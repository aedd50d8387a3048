"""The benchmark's inputs, pinned by digests: the same seed gives the same
bits.  The generators are frozen copies of the program's
(``uuo_mocap_tpu_torch/data/synthetic.py``, ``body/synthetic.py``); the
digests were read when they were copied (commit 1ed4835)."""
import json
import os

import numpy as np
import pytest

from portbench import traffic as T
from portbench.reference import body, generators as G
from portbench.tests.tiny import REPO
from portbench.yardstick import digest


@pytest.fixture(scope="module")
def arrays():
    return body.build_arrays()


def test_body_arrays(arrays):
    assert digest(*(arrays[k] for k in sorted(arrays))) == "8456304fac348e25"
    assert arrays["v_template"].shape == (6890, 3) and arrays["faces"].shape == (13776, 3)


def test_motion_markers_and_prior(arrays):
    m = body.model_tensors(arrays)
    gt = G.random_pose_sequence(450, seed=2000, yaw=0.9, travel=0.5)
    assert digest(*(gt[k] for k in sorted(gt))) == "0912c155c701ffe1"
    mk = G.generate_markers(m, arrays["faces"].astype(np.int64), gt, 41, seed=2001,
                            occlusion_rate=0.05)
    # as both sides receive them: float32 (the float64 points' last bits follow
    # the thread count of the CPU's matmuls)
    assert digest(mk["points"].astype(np.float32), mk["vertex_ids"]) == "546a15f0f1534647"
    prior = G.perturb_params(gt, 2002, 0.05, 0.08, 0.2)
    assert digest(*(prior[k] for k in sorted(prior))) == "07fbf8738b7f4cd8"


def test_a_pool_batch_from_a_seed_past_32_bits(arrays):
    with open(os.path.join(REPO, "portbench", "configs", "video_mocap.cmu41.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "portbench", "traffic", "gappy.b16.json")) as f:
        traffic = json.load(f)
    traffic.update(sequences_per_solve=2, frames=30)
    m, faces = body.model_tensors(arrays), arrays["faces"].astype(np.int64)
    b = T.make_batch(traffic, config, m, faces, 2**31 + 7, 3)
    assert b.markers_real == 39 and b.markers[0].shape == (30, 39, 3) and b.frames == 60
    assert digest(*b.markers, *(g[k] for g in b.gts for k in sorted(g)),
                  *(p[k] for p in b.priors for k in sorted(p))) == "35ded8e6ddd7a18c"
    again = T.make_batch(traffic, config, m, faces, 2**31 + 7, 3)
    assert all(np.array_equal(x, y) for x, y in zip(b.markers, again.markers))
    other = T.make_batch(traffic, config, m, faces, 2**31 + 8, 3)
    assert not np.array_equal(b.markers[0], other.markers[0])
    assert T.window_seeds(2**31 + 7, 3, 1) == [965024898, 49018001, 1090552508]


def test_occlusion_rate_and_layouts(arrays):
    m, faces = body.model_tensors(arrays), arrays["faces"].astype(np.int64)
    gt = G.random_pose_sequence(200, seed=5)
    gappy = G.generate_markers(m, faces, gt, 41, seed=6, occlusion_rate=0.05)["points"]
    share = float((np.abs(gappy).sum(-1) == 0).mean())
    assert 0.03 < share < 0.07
    clean = G.generate_markers(m, faces, gt, 41, seed=6)["points"]
    assert (np.abs(clean).sum(-1) > 0).all()
    assert len(np.unique(G.generate_markers(m, faces, gt, 41, seed=6)["vertex_ids"])) == 41
