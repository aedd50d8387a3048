"""The reader of the dense LBS forward's row counters (``lbs_kernel_pct``):
the kernel's rows over all dense rows, summed over every stage of every
solve, and None for a program without the counters or with no dense rows."""
import pytest

from portbench.manifest import reader


def _record(stats):
    return {"solves": [{"wall_s": 10.0, "stage_times_s": {}, "eval_stats": s, "frames": 7200}
                       for s in stats], "peak_bytes": 0, "setup_s": 1.0}


def _rows(rows, kernel_rows):
    return {"width": 64, "lanes": 64, "dense_lbs_rows": rows, "dense_lbs_kernel_rows": kernel_rows}


def test_share_over_every_stage_of_every_solve():
    read = reader("lbs_kernel_pct")
    stats = [{"part_fit": _rows(7200, 7200), "chamfer": _rows(28800, 0), "marker": _rows(0, 0)},
             {"part_fit": _rows(14400, 14400), "chamfer": _rows(28800, 28800)}]
    kernel, rows = 7200 + 14400 + 28800, 7200 + 28800 + 14400 + 28800
    assert read(_record(stats)) == pytest.approx(100.0 * kernel / rows, rel=1e-12)
    everything = [{"chamfer": _rows(28800, 28800)}]
    assert read(_record(everything)) == 100.0


@pytest.mark.parametrize("stats", [
    [{"part_fit": {"width": 64, "device_evals": 640}}],  # a program without the counters
    [{"marker": _rows(0, 0)}],                            # no dense rows at all
    [],                                                   # no solve
])
def test_none_where_there_is_nothing_to_read(stats):
    assert reader("lbs_kernel_pct")(_record(stats)) is None
