"""The device's idle share of the training cell's profiled stretch, read
only where the trace holds the captured step's replayed kernels (at least
MIN_PER_STEP device operations per step); otherwise nothing."""

MIN_PER_STEP = 50


def read(record):
    trace = record.get("trace", {})
    steps = record.get("stretch_steps")
    if not steps or not trace.get("window_s"):
        return None
    if len(trace.get("kernels", ())) < MIN_PER_STEP * steps:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
