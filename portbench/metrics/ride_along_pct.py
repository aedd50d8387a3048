"""Share of the working sets' evaluations spent on lanes that had finished
or were duplicates (``ride_along_evals / device_evals`` over every stage of
every solve), in %."""


def read(record):
    stats = [v for s in record["solves"] for v in s["eval_stats"].values()]
    device = sum(v.get("device_evals", 0) for v in stats)
    if not device:
        return None
    return 100.0 * sum(v.get("ride_along_evals", 0) for v in stats) / device
