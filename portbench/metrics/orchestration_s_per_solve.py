"""Seconds per solve outside the four stage timers: segmentation, AABB,
prune scoring, nearest points, assembly and host dispatch between them
(the solve's wall time, ending in a synchronize, minus ``stage_times_s``'s
part_fit, chamfer, marker and marker_final)."""

STAGES = ("part_fit", "chamfer", "marker", "marker_final")


def read(record):
    solves = record["solves"]
    if not solves:
        return None
    return sum(s["wall_s"] - sum(s["stage_times_s"].get(k, 0.0) for k in STAGES)
               for s in solves) / len(solves)
