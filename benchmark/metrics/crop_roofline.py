"""The crop kernel's share of its roofline over the profiled stretch: the
benchmark's bound for the stretch's crops (``costs.crop_work``) over the
device time of ``crop_kernel`` launches in the trace."""

from benchmark.trace import kernel_seconds

PATTERN = r"(?<![A-Za-z0-9_])crop_kernel\b"


def read(record):
    seconds, launches = kernel_seconds(record.get("trace", {}), PATTERN)
    work = record.get("work", {}).get("crop")
    if not launches or not work:
        return None
    return 100.0 * sum(w.bound_s() for w in work) / seconds
