"""Share of the traced window in which no operation ran on the card
(``1 - busy_s / window_s``, busy time the union of the device ops), in %.
The profiler records only the benchmark's ``record_function`` ranges on the
host, which slows dispatch by 10-20 %, so this reads a little above an
untraced window's idle share."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
