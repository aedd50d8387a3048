"""Sequential mode of the whole-slice test (``test_torch_cli.py``): both
packages' ``cli.test`` without ``--batch`` on the first sequence of the same
export (``--num_files 0``), with that file's config and tolerances."""
from test_torch_cli import compare_results, exported, solve_runs  # noqa: F401  (exported: a fixture)


def test_cli_sequential_matches_jax(exported):  # noqa: F811
    dirs = solve_runs(exported, "seq", ["--num_files", "0"])
    # 1 sequence x (final + chamfer, marker, marker_final stages)
    compare_results(dirs, "seq", expected=4)
