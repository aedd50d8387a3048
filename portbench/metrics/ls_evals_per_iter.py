"""Closure calls per working-set iteration inside the line searches, over
every stage of every solve (``eval_stats[*]["ls_evals"] / ["iterations"]``,
summed before dividing)."""


def read(record):
    stats = [v for s in record["solves"] for v in s["eval_stats"].values()
             if "ls_evals" in v and "iterations" in v]
    iterations = sum(v["iterations"] for v in stats)
    if not iterations:
        return None
    return sum(v["ls_evals"] for v in stats) / iterations
