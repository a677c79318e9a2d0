"""ms of device time per Adam step over the profiled stretch: the union of
the device's operations (``busy_s``) over the steps the stretch's calls
ran. Read only where the trace holds the captured step's replayed kernels
(at least MIN_PER_STEP device operations per step);
otherwise nothing."""

MIN_PER_STEP = 50


def read(record):
    trace = record.get("trace", {})
    steps = record.get("stretch_steps")
    if not steps or not trace.get("busy_s"):
        return None
    if len(trace.get("kernels", ())) < MIN_PER_STEP * steps:
        return None
    return 1e3 * trace["busy_s"] / steps
