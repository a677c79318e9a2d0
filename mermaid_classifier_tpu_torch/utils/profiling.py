"""Section profiling and host spans.

Section profiling: wall time + memory snapshots per pipeline phase. The
port's own copy of ``mermaid_classifier_tpu/utils/profiling.py``, without
psutil: the memory share comes from ``/proc/meminfo``
(``memory_used_percent``). The accumulated list is logged as a run
artifact by the runner.

Host spans: named intervals of the program's own work, always recorded,
kept in memory. A span holds its name, its start and end on
``time.perf_counter_ns()``, its thread, the enclosing span on the same
thread (its parent) and a key shared by one unit of work (an image id in
the bulk path, a call's index in training); a span without a key takes
its parent's, or the one ``keyed`` set on its thread. Spans sit at
per-image and per-call boundaries only; each costs a few clock reads and
one append to its name's ring (``SPAN_CAPACITY`` entries, the oldest
dropped) beside its name's running count and total, which ``summary``
reads, so a long run's totals are whole.

While ``torch.profiler`` records, a span is marked ``profiled``, and on
the thread that started the profiler it is also a ``record_function``
range, so it sits on the profiler's clock beside the device's operations
(the profiler keeps ranges of that thread only). Readers of per-layer
times leave profiled spans out: they carry the profiler's overhead.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from datetime import datetime, timezone
from typing import Any, NamedTuple

import torch

from mermaid_classifier_tpu_torch.utils.system_metrics import memory_used_percent

SPAN_CAPACITY = 65536


class Span(NamedTuple):
    name: str
    key: Any
    start_ns: int
    end_ns: int
    thread: int
    parent: str | None
    profiled: bool


def _profiler_recording() -> tuple[bool, bool]:
    """(a profiler records on this thread, one records anywhere in the
    process)."""
    here = torch._C._autograd._profiler_enabled()
    return here, here or getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


class SpanRecorder:
    """Spans in memory, one bounded ring and one running [count, total ns]
    per name; the lock is held only for an append and a copy."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = int(capacity)
        self._rings: dict[str, deque] = {}
        self._totals: dict[str, list[int]] = defaultdict(lambda: [0, 0])
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list[tuple[str | None, Any]]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextmanager
    def keyed(self, key):
        """Spans opened inside, on this thread, take ``key``; records
        nothing itself."""
        stack = self._stack()
        stack.append((stack[-1][0] if stack else None, key))
        try:
            yield
        finally:
            stack.pop()

    @contextmanager
    def span(self, name: str, key=None):
        """Record the enclosed block as the span ``name`` (also when it
        raises)."""
        stack = self._stack()
        parent, inherited = stack[-1] if stack else (None, None)
        key = inherited if key is None else key
        ranged, profiled = _profiler_recording()
        stack.append((name, key))
        handle = torch.profiler.record_function(name) if ranged else None
        if handle is not None:
            handle.__enter__()
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            end = time.perf_counter_ns()
            if handle is not None:
                handle.__exit__(None, None, None)
            stack.pop()
            record = Span(name, key, start, end, threading.get_ident(), parent, profiled)
            with self._lock:
                ring = self._rings.get(name)
                if ring is None:
                    ring = self._rings[name] = deque(maxlen=self.capacity)
                ring.append(record)
                total = self._totals[name]
                total[0] += 1
                total[1] += end - start

    def snapshot(self) -> list[Span]:
        """Every span still held, by start."""
        with self._lock:
            spans = [s for ring in self._rings.values() for s in ring]
        return sorted(spans, key=lambda s: s.start_ns)

    def summary(self) -> dict[str, dict]:
        """{name: {count, total_s, mean_ms}} over every span recorded, also
        those the rings have dropped."""
        with self._lock:
            totals = {name: tuple(total) for name, total in self._totals.items()}
        return {name: {"count": n, "total_s": ns / 1e9, "mean_ms": ns / 1e6 / n}
                for name, (n, ns) in sorted(totals.items())}


#: The process's recorder: the program's spans and the readers' source.
RECORDER = SpanRecorder()
span = RECORDER.span
keyed = RECORDER.keyed
snapshot = RECORDER.snapshot
summary = RECORDER.summary


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
