"""The profiled stretch of a ``--trace 1`` run, reduced to what the
per-layer readers and the result's ``device`` and ``breakdown`` need.

The stretch runs after the measured window, under ``torch.profiler``
with CPU and CUDA activity, inside a ``record_function`` range named
``stretch``. From the trace:

- ``kernels``: every operation on the device (kernels, copies, sets) with
  its name and interval, clipped to the stretch;
- ``busy_s``: the union of those intervals; ``window_s`` the stretch;
- ``idle_gaps``: the idle time between them, labelled by the benchmark's
  host span that covers each gap's middle (the stretch's own thread
  first), summed by label;
- ``device_ops``: device time summed by operation name.
"""

from __future__ import annotations

import re
from collections import Counter

STRETCH = "stretch"
TOP = 10


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(events, span_names) -> dict:
    """Reduce ``prof.events()`` of one stretch; {} if the trace holds no
    stretch or no device operation."""
    from torch.autograd import DeviceType

    window, main_thread, device, host = None, None, [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.name, start, end))
        elif e.name == STRETCH:
            window, main_thread = (start, end), e.thread
        elif e.name in span_names:
            host.append((e.name, e.thread, start, end))
    if window is None or not device:
        return {}
    lo, hi = window
    kernels = [(n, max(s, lo), min(t, hi)) for n, s, t in device if t > lo and s < hi]
    merged = _merge((s, t) for _, s, t in kernels)
    busy = sum(t - s for s, t in merged)
    gaps = []
    cursor = lo
    for s, t in merged + [[hi, hi]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    by_label = Counter()
    for s, t in gaps:
        mid = (s + t) / 2
        covering = [(th != main_thread, name) for name, th, a, b in host if a <= mid <= b]
        label = min(covering)[1] if covering else "host outside the benchmark's spans"
        by_label[label] += (t - s) / 1e6
    by_name = Counter()
    for n, s, t in kernels:
        by_name[n] += (t - s) / 1e6
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": [(n, (t - s) / 1e6) for n, s, t in kernels],
        "device_ops": [[n[:160], v] for n, v in by_name.most_common(TOP)],
        "idle_gaps": [[n, v] for n, v in by_label.most_common(TOP)],
    }


def kernel_seconds(trace: dict, pattern: str) -> tuple[float, int]:
    """(device seconds, launches) of the operations whose name matches
    ``pattern`` (a regular expression, searched)."""
    rx = re.compile(pattern)
    hits = [d for n, d in trace.get("kernels", ()) if rx.search(n)]
    return sum(hits), len(hits)
