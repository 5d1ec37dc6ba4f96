"""Hierarchical wall-clock profiler (mrpt CTimeLogger contract).

Copy of ``mola_lidar_odometry_tpu/utils/profiler.py``.  Host-side spans;
the reference wraps every pipeline stage in RAII ``ProfilerEntry`` spans and
exposes mean/last queries that feed the GUI Hz display
(module/src/LidarOdometry.cpp:361-367, 1848-1853).  A span measures host
wall time only and adds no device synchronization of its own: around an
asynchronous CUDA launch it times the launch, around a call that reads a
result back it includes the wait.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._times: Dict[str, List[float]] = defaultdict(list)
        self._counters: Dict[str, List[float]] = defaultdict(list)
        self._stack: List[str] = []

    @contextmanager
    def enter(self, name: str):
        if not self.enabled:
            yield
            return
        full = ".".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stack.pop()
            self._times[full].append(time.perf_counter() - t0)

    def register_user_measure(self, name: str, value: float) -> None:
        if self.enabled:
            self._counters[name].append(value)

    def mean(self, name: str) -> float:
        v = self._times.get(name) or self._counters.get(name) or []
        return sum(v) / len(v) if v else 0.0

    def last(self, name: str) -> float:
        v = self._times.get(name) or self._counters.get(name) or []
        return v[-1] if v else 0.0

    def times(self, name: str) -> List[float]:
        """Every recorded duration of a span, oldest first (seconds)."""
        return list(self._times.get(name, []))

    def count(self, name: str) -> int:
        return len(self._times.get(name) or self._counters.get(name) or [])

    def mean_hz(self, name: str) -> float:
        """Mean rate of a span (the GUI Hz display, reference :1848-1853)."""
        m = self.mean(name)
        return 1.0 / m if m > 0 else 0.0

    def report(self) -> str:
        lines = ["-- profiler report --"]
        for k in sorted(self._times):
            v = self._times[k]
            lines.append(
                f"{k}: n={len(v)} mean={1e3 * sum(v) / len(v):.2f}ms "
                f"min={1e3 * min(v):.2f}ms max={1e3 * max(v):.2f}ms"
            )
        for k in sorted(self._counters):
            v = self._counters[k]
            lines.append(f"{k}: n={len(v)} mean={sum(v) / len(v):.3f}")
        return "\n".join(lines)
