"""Sequential mode of the whole-slice test (``test_torch_cli.py``): both
packages' ``cli.test`` without ``--batch`` on the first sequence of the same
export (``--num_files 0``), with that file's config and tolerances.  The
port's run saves its iteration journal (``--save_iterations``), which
``test_torch_cli.check_journal`` reads back."""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import pytest

from test_torch_cli import (  # noqa: F401  (exported: a fixture)
    check_journal, compare_outputs, compare_params, exported, solve_runs)


@pytest.fixture(scope="module")
def seq_runs(exported):  # noqa: F811  (exported: a fixture)
    return solve_runs(exported, "seq", ["--num_files", "0"],
                      port_args=["--save_iterations", str(exported[0] / "seq_iterations")])


def test_cli_sequential_outputs_match_jax(seq_runs):
    # 1 sequence x (final + chamfer, marker, marker_final stages)
    compare_outputs(seq_runs, "seq", expected=4)


def test_cli_sequential_matches_jax(seq_runs):
    for key in ("trans", "betas", "rotations"):
        compare_params(seq_runs, "seq", key)


def test_cli_sequential_saves_the_iteration_journal(exported, seq_runs):  # noqa: F811
    entries = check_journal(exported[0] / "seq_iterations" / "s1_a_iterations.pkl",
                            ["chamfer", "marker", "marker_final_0"], 20)
    assert entries["chamfer"][0]["scores"].shape == (4,)  # the 4 yaw hypotheses
