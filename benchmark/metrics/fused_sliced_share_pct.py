"""The sliced pass 1's share of the fused-MBConv kernel's device time over
the profiled stretch: the device seconds of the ``expand_dw_kernel``
instances whose last template argument is ``true``
(``expand_dw_kernel<__nv_bfloat16, 5, true>``: Cin streamed in slices)
over those of the kernel's three passes, ``fused_mbconv_roofline``'s
pattern. Nothing where the trace holds no sliced instance."""

from benchmark.trace import kernel_seconds

FUSED = r"(?<![A-Za-z0-9_])(expand_dw_kernel|se_kernel|project_kernel)\b"
SLICED = r"(?<![A-Za-z0-9_])expand_dw_kernel<[^()]*?(\btrue|\(bool\)1)>"


def read(record):
    trace = record.get("trace", {})
    sliced, launches = kernel_seconds(trace, SLICED)
    total, _ = kernel_seconds(trace, FUSED)
    if not launches or total <= 0:
        return None
    return 100.0 * sliced / total
