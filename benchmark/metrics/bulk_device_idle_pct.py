"""The device's idle share of the bulk cells' profiled stretch: one minus
the union of device operations over the stretch."""


def read(record):
    trace = record.get("trace", {})
    if "patches" not in record or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
