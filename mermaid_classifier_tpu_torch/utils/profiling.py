"""Section profiling: wall time + memory snapshots per pipeline phase.

The port's own copy of ``mermaid_classifier_tpu/utils/profiling.py``,
without psutil: the memory share comes from ``/proc/meminfo``
(``memory_used_percent``). The accumulated list is logged as a run
artifact by the runner.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from datetime import datetime, timezone

from mermaid_classifier_tpu_torch.utils.system_metrics import memory_used_percent


def _hms(seconds: float) -> str:
    m, s = divmod(int(round(seconds)), 60)
    h, m = divmod(m, 60)
    return f"{h:d}:{m:02d}:{s:02d}"


@contextmanager
def section_profiling(profiled_sections: list[dict], name: str):
    """Append {name, seconds, hms, started_at, memory_used_percent} to
    ``profiled_sections`` when the block exits (also on exceptions, so a
    failed run still shows where the time went)."""
    start = time.perf_counter()
    started_at = datetime.now(timezone.utc).isoformat(timespec="seconds")
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        profiled_sections.append(
            {
                "name": name,
                "seconds": round(elapsed, 3),
                "hms": _hms(elapsed),
                "started_at": started_at,
                "memory_used_percent": memory_used_percent(),
            }
        )
