"""The batch solve with both reprojection stages (5 iterations over 4 yaw
seeds, lanes = sequence x seed), the priors carrying
``tests/test_torch_reprojection.py``'s camera streams (the crop camera
(0.04, 0, 0), 4.9 m from the body): the port's ``MultiSequenceSolver``
against the JAX package's on the CPU.  Size, tolerances and the free and
lockstep solves: ``test_torch_batch_options.py``.

The two batch solves file different seeds under ``stages["part"]``: the
reference the seeds after ``reprojection_full`` (it overwrites them at
``uuo_mocap_tpu/parallel/batch_solver.py:416-418`` before it writes the
snapshot at ``:720-723``), the port the part fit's own result, as both
packages' single-sequence solves do (ROADMAP C, "Stage names in the batch
solve").  ``test_part_snapshot_is_the_part_fit_not_reprojection_full``
asserts that difference.
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import numpy as np
import pytest

from test_torch_batch_options import (  # noqa: F401  (batch, models: fixtures)
    PARAM_ATOL, Case, batch, check_free_solve, check_free_solve_values, check_lockstep,
    models)


@pytest.fixture(scope="module")
def reprojection(models, batch):
    return Case("reprojection", models, batch)


def test_reprojection_free_solve_matches_jax(reprojection):
    check_free_solve(reprojection)
    assert {"reprojection_part", "reprojection_full"} <= set(reprojection.free["stage_times_s"])


def test_reprojection_free_solve_within_the_references_own_spread(reprojection):
    check_free_solve_values(reprojection)


def test_reprojection_lockstep_solve_matches_jax(reprojection):
    check_lockstep(reprojection)
    assert [k for k, _ in reprojection.lockstep_diffs].count("reprojection") == 2


def test_part_snapshot_is_the_part_fit_not_reprojection_full(reprojection):
    """The reference's ``part`` snapshot is its reprojection_full result, the
    port's (in the lockstep solve, from the reference's descents) the part
    fit's; the two are apart by more than the tolerance."""
    c = reprojection
    full = [call for kind, call in c.ref_calls if kind == "reprojection"][-1]
    for q in range(len(c.batch)):
        ref_part = c.ref["results"][q]["stages"]["part"]
        np.testing.assert_array_equal(ref_part["trans"], full["trans"][q])
        np.testing.assert_array_equal(ref_part["betas"], full["betas"][q].reshape(-1))
        ours = c.lockstep["results"][q]["stages"]["part"]
        root, trans, betas = c.ref_seen["fit"][q]
        np.testing.assert_allclose(ours["trans"], trans, atol=PARAM_ATOL, rtol=0)
        np.testing.assert_allclose(ours["root_orient"], root, atol=PARAM_ATOL, rtol=0)
        assert np.abs(ours["trans"] - ref_part["trans"]).max() > PARAM_ATOL, q
