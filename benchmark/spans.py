"""Host spans that the benchmark records around its calls into the program.

A span is a name and a duration on the host clock, kept in memory. While
a profiled stretch runs, each span is also a ``record_function`` range, so
the trace can say what the host was doing in each of the device's idle
gaps.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from threading import Lock

import torch


class Spans:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.profiling = False
        self.ms: dict[str, list[float]] = defaultdict(list)
        self._lock = Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        ranged = (torch.profiler.record_function(name) if self.profiling
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ranged:
            yield
        elapsed = (time.perf_counter() - t0) * 1e3
        if not self.profiling:
            with self._lock:
                self.ms[name].append(elapsed)

    def wrap(self, name: str, fn):
        """``fn`` with each call recorded as a span ``name``."""
        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return timed
