"""Share of the lanes' L-BFGS iterations whose line search stopped at its
``max_ls`` evaluations without meeting the strong-Wolfe conditions
(``eval_stats[*]["ls_exhausted"] / ["lane_iters"]`` over every stage of every
solve), in %."""


def read(record):
    stats = [v for s in record["solves"] for v in s["eval_stats"].values()
             if "ls_exhausted" in v and "lane_iters" in v]
    lane_iters = sum(v["lane_iters"] for v in stats)
    if not lane_iters:
        return None
    return 100.0 * sum(v["ls_exhausted"] for v in stats) / lane_iters
