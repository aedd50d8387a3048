"""Seconds per solve in the marker stage and the final marker pass
(``stage_times_s["marker"] + ["marker_final"]``)."""


def read(record):
    solves = record["solves"]
    if not solves:
        return None
    return sum(s["stage_times_s"].get("marker", 0.0) + s["stage_times_s"].get("marker_final", 0.0)
               for s in solves) / len(solves)
