"""Seconds per solve in the chamfer stage, its hypothesis rounds included
(``stage_times_s["chamfer"]``)."""


def read(record):
    solves = record["solves"]
    if not solves:
        return None
    return sum(s["stage_times_s"].get("chamfer", 0.0) for s in solves) / len(solves)
