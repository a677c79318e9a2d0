"""The fused-MBConv kernel's share of its roofline over the profiled
stretch: the benchmark's bound for every fused-route block over the
stretch's patches (``costs.fused_block_work``) over the device time of
the kernel's three passes (expand and depthwise, squeeze-excite,
project) in the trace."""

from benchmark.trace import kernel_seconds

PATTERN = r"(?<![A-Za-z0-9_])(expand_dw_kernel|se_kernel|project_kernel)\b"


def read(record):
    seconds, launches = kernel_seconds(record.get("trace", {}), PATTERN)
    work = record.get("work", {}).get("fused_mbconv")
    if not launches or not work:
        return None
    return 100.0 * sum(w.bound_s() for w in work) / seconds
