"""Seconds per solve in the part fit (``stage_times_s["part_fit"]``: a host
clock ending in a synchronize)."""


def read(record):
    solves = record["solves"]
    if not solves:
        return None
    return sum(s["stage_times_s"].get("part_fit", 0.0) for s in solves) / len(solves)
