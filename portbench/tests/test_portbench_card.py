"""On the card: the harness's whole run at the tiny size through the Hopper
kernels, traced.  Marked ``cuda``; skips without a card (decided inside the
test).  Run on the card with ``python -m pytest --noconftest -m cuda
portbench/tests``."""
import tempfile
import time

import pytest
import torch

from portbench import harness
from portbench.manifest import Manifest
from portbench.tests.tiny import tiny_root


@pytest.mark.cuda
def test_a_tiny_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU mode)")
    manifest = Manifest.load(tiny_root(tempfile.mkdtemp(), pool_batches=3))
    r = harness.run(manifest, "random41.gappy.b16", 2**31 + 9, 0.5, True, "cuda",
                    time.perf_counter(), lambda s: None)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and r["metrics"]["launches_per_solve"]["value"] > 0
    assert 0 < r["metrics"]["nearest_roofline"]["value"] <= 100
