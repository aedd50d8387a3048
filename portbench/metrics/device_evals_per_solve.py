"""Closure evaluations the lockstep working sets ran per solve, summed over
the stages (``eval_stats[*]["device_evals"]``)."""


def read(record):
    solves = record["solves"]
    if not solves:
        return None
    return sum(v.get("device_evals", 0) for s in solves for v in s["eval_stats"].values()) / len(
        solves)
