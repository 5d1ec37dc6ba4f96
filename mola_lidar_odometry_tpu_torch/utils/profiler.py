"""Hierarchical wall-clock profiler (mrpt CTimeLogger contract).

The reference wraps every pipeline stage in RAII ``ProfilerEntry`` spans
and exposes mean/last queries that feed the GUI Hz display
(module/src/LidarOdometry.cpp:361-367, 1848-1853).  A span measures host
wall time only and adds no device synchronization of its own: around an
asynchronous CUDA launch it times the launch, around a call that reads a
result back it includes the wait.

One profiler is the process's active one (:func:`active`; :func:`use` sets
it for a block).  The fleet step opens its spans and bumps its counters on
it, so that whoever runs the step decides what is recorded: the host API
its own profiler, a benchmark a profiler with a timeline, everyone else a
disabled one, whose spans are one shared no-op context.

With ``timeline=True`` each span keeps a record ``(full name, step index,
t0_ns, t1_ns)`` on the monotonic clock (``time.perf_counter_ns``) until
the caller takes it (:meth:`Profiler.take`); a span entered with
``new_step=True`` opens a new step index.  :meth:`Profiler.epoch_ns` maps
a record's times onto ``time.time_ns()``'s clock, the clock of a
``torch.profiler`` chrome trace (``ts`` in us x 1000 +
``baseTimeNanoseconds``).

The active profiler is held in a context variable, so that each thread
(an ``AsyncLidarOdometry`` worker, a fleet step beside it) sees the one
it set itself.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, List, Tuple

Record = Tuple[str, int, int, int]  # (full span name, step index, t0_ns, t1_ns)


class _NoSpan:
    """The span of a disabled profiler: reads no clock, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("prof", "name", "new_step", "full", "index", "t0")

    def __init__(self, prof: "Profiler", name: str, new_step: bool):
        self.prof, self.name, self.new_step = prof, name, new_step

    def __enter__(self):
        p = self.prof
        p._stack.append(self.name)
        self.full = ".".join(p._stack)
        if self.new_step:
            p.step_index += 1
        self.index = p.step_index
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        p = self.prof
        p._stack.pop()
        if p.timeline:
            p._records.append((self.full, self.index, self.t0, t1))
        else:
            p._times[self.full].append((t1 - self.t0) * 1e-9)
        return False


class Profiler:
    def __init__(self, enabled: bool = True, timeline: bool = False):
        self.enabled = enabled
        self.timeline = timeline
        self.step_index = -1
        self._times: Dict[str, List[float]] = defaultdict(list)  # without a timeline
        self._records: List[Record] = []  # with one
        self._counters: Dict[str, List[float]] = defaultdict(list)
        self._stack: List[str] = []
        # one reading of both clocks, taken together
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def enter(self, name: str, new_step: bool = False):
        """A span ``name`` under the spans open now (a context manager);
        ``new_step`` opens the next step index."""
        return _Span(self, name, new_step) if self.enabled else NO_SPAN

    def add(self, name: str, value: float = 1) -> None:
        """Count ``value`` under the counter ``name`` (one record each)."""
        if self.enabled:
            self._counters[name].append(value)

    def mean(self, name: str) -> float:
        v = self.times(name) or self._counters.get(name) or []
        return sum(v) / len(v) if v else 0.0

    def last(self, name: str) -> float:
        v = self.times(name) or self._counters.get(name) or []
        return v[-1] if v else 0.0

    def times(self, name: str) -> List[float]:
        """Every recorded duration of a span, oldest first (seconds)."""
        if self.timeline:
            return [(t1 - t0) * 1e-9 for n, _, t0, t1 in self._records if n == name]
        return list(self._times.get(name, []))

    def mean_hz(self, name: str) -> float:
        """Mean rate of a span (the GUI Hz display, reference :1848-1853)."""
        m = self.mean(name)
        return 1.0 / m if m > 0 else 0.0

    def take(self) -> Tuple[List[Record], Dict[str, List[float]]]:
        """The timeline's records (in the order the spans closed) and every
        counter's values, and forget both."""
        records, counters = self._records, dict(self._counters)
        self._records, self._counters = [], defaultdict(list)
        return records, counters

    def epoch_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` reading on ``time.time_ns()``'s clock."""
        return t_ns - self.anchor[0] + self.anchor[1]


_active: ContextVar[Profiler] = ContextVar("active_profiler", default=Profiler(enabled=False))


def active() -> Profiler:
    """The active profiler of this thread (a disabled one unless :func:`use`
    set another)."""
    return _active.get()


@contextmanager
def use(profiler: Profiler):
    """Make ``profiler`` the active one for the block, in this thread."""
    token = _active.set(profiler)
    try:
        yield profiler
    finally:
        _active.reset(token)


def host_bool(flag) -> bool:
    """``bool(flag)`` of a device value, the host waiting for it: counted
    as ``host_syncs`` on the active profiler."""
    _active.get().add("host_syncs")
    return bool(flag)
