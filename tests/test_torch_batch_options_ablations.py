"""The batch solve under the shipped ablation configs
(``configs/hmr_full.yaml``: the part fit on the full 24-joint skeleton with
the later stages off; ``hmr_part.yaml``: the part fit alone;
``mht_rotation.yaml``: one yaw hypothesis): the port's
``MultiSequenceSolver`` against the JAX package's on the CPU.  Size,
tolerances and the free and lockstep solves: ``test_torch_batch_options.py``.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import pytest

from test_torch_batch_options import (  # noqa: F401  (batch, models: fixtures)
    Case, batch, check_free_solve, check_free_solve_values, models)


@pytest.fixture(scope="module", params=["hmr_full", "hmr_part", "mht_rotation"])
def ablation(request, models, batch):
    return Case(request.param, models, batch)


def test_ablation_free_solve_matches_jax(ablation):
    check_free_solve(ablation)


def test_ablation_labels_survivors_and_parameters_match_jax(ablation):
    check_free_solve_values(ablation)
