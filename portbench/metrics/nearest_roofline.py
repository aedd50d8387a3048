"""The nearest-vertex kernels' share of their roofline in the traced window:
the sum of each dispatcher call's bound (``yardstick.*_call_bound_ms``, from
the call's shapes, against the H100 SXM's published HBM bandwidth and FP32
rate) over the device time of the kernels those calls launched, in %."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["nearest_kernel_s"] <= 0:
        return None
    return 100.0 * trace["nearest_bound_s"] / trace["nearest_kernel_s"]
