"""Device kernels the profiler counted in the traced window, per solve."""


def read(record):
    trace, solves = record.get("trace"), record["solves"]
    if not trace or not trace["kernel_launches"] or not solves:
        return None
    return trace["kernel_launches"] / len(solves)
