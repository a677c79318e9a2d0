"""Background system-metrics sampling into a tracking run.

The port's own copy of ``mermaid_classifier_tpu/utils/system_metrics.py``,
without psutil. The numbers are the ones psutil reports on Linux, read from
``/proc``:

- memory used percent: (MemTotal - MemAvailable) / MemTotal, one decimal;
- memory available: MemAvailable;
- swap used percent: (SwapTotal - SwapFree) / SwapTotal, one decimal, 0.0
  without swap;
- CPU percent: the busy share of the ``/proc/stat`` cpu time since the
  previous sample (busy = all - idle - iowait, guest time counted once in
  user time), one decimal; 0.0 on the first sample.

A daemon thread logs them as step metrics every ``interval`` seconds for
the life of the run, under the JAX record keys.
"""

from __future__ import annotations

import threading

from mermaid_classifier_tpu_torch.config.settings import meminfo_bytes


def _percent(used: float, total: float) -> float:
    return round(used / total * 100, 1) if total > 0 else 0.0


def memory_used_percent() -> float:
    total = meminfo_bytes("MemTotal")
    return _percent(total - meminfo_bytes("MemAvailable"), total)


def swap_used_percent() -> float:
    total = meminfo_bytes("SwapTotal")
    return _percent(total - meminfo_bytes("SwapFree"), total)


def cpu_times() -> tuple[float, float]:
    """(all, busy) cpu time of ``/proc/stat``'s aggregate line, in ticks."""
    with open("/proc/stat") as f:
        fields = [float(x) for x in f.readline().split()[1:]]
    fields += [0.0] * (10 - len(fields))
    user, nice, system, idle, iowait, irq, softirq, steal, guest, guest_nice = (
        fields[:10]
    )
    total = sum(fields[:10]) - guest - guest_nice
    return total, total - idle - iowait


class SystemMetricsSampler:
    """Start/stop a daemon sampler bound to a tracking Run."""

    def __init__(self, run, interval: float = 10.0):
        self.run = run
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._step = 0
        self._last_cpu: tuple[float, float] | None = None

    def _cpu_percent(self) -> float:
        now = cpu_times()
        last, self._last_cpu = self._last_cpu, now
        if last is None or now[0] <= last[0]:
            return 0.0
        return _percent(now[1] - last[1], now[0] - last[0])

    def _sample_once(self) -> None:
        self.run.log_metrics(
            {
                "system/cpu_percent": self._cpu_percent(),
                "system/memory_used_percent": memory_used_percent(),
                "system/memory_available_gb": meminfo_bytes("MemAvailable") / 1e9,
                "system/swap_used_percent": swap_used_percent(),
            },
            step=self._step,
        )
        self._step += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 - sampling must never kill a run
                pass

    def start(self) -> "SystemMetricsSampler":
        self._sample_once()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1)
        try:
            self._sample_once()
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self) -> "SystemMetricsSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
