"""The program's own host spans over the measured window, for the readers
of the per-layer metrics that are read from them.

The program (``mermaid_classifier_tpu_torch.utils.profiling``) keeps its
spans in memory in the run's own process. The window's spans are those not
marked ``profiled`` whose start lies within the record's ``window_s`` of
the latest such span's end: set-up's warm call starts before that, and a
traced run's profiled stretch, which follows the window, is marked. Where
the program keeps no spans (a checkout from before it had them) or the
record has no window, a reader gets nothing and returns None.
"""

from __future__ import annotations

from collections import defaultdict


def window(record) -> dict[str, list]:
    """{span name: [spans]} of the window; {} where there is none."""
    try:
        from mermaid_classifier_tpu_torch.utils import profiling
    except ImportError:
        return {}
    snapshot = getattr(profiling, "snapshot", None)
    window_s = record.get("window_s")
    if snapshot is None or not window_s:
        return {}
    spans = [s for s in snapshot() if not s.profiled]
    if not spans:
        return {}
    lo = max(s.end_ns for s in spans) - window_s * 1e9
    by_name = defaultdict(list)
    for s in spans:
        if s.start_ns >= lo:
            by_name[s.name].append(s)
    return dict(by_name)


def total_ms(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6


def mean_ms(record, name: str):
    """Mean ms of the window's spans ``name``; None without any."""
    spans = window(record).get(name)
    return total_ms(spans) / len(spans) if spans else None
