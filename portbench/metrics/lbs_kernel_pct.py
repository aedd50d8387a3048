"""Share of the dense LBS forward's rows that the hand-written kernel
computed, in %: ``eval_stats[*]["dense_lbs_kernel_rows"]`` over
``["dense_lbs_rows"]``, summed over every stage of every solve.  None where
the program counts no dense rows (a program without the counters)."""


def read(record):
    stats = [v for s in record["solves"] for v in s["eval_stats"].values()
             if "dense_lbs_rows" in v and "dense_lbs_kernel_rows" in v]
    rows = sum(v["dense_lbs_rows"] for v in stats)
    if not rows:
        return None
    return 100.0 * sum(v["dense_lbs_kernel_rows"] for v in stats) / rows
