"""What the per-layer readers read: the window's counts, the device line
of a stretch of steps traced without stacks beside the same steps'
untraced host time (``timeline``), and the device events of the stretch
traced with stacks (``traced``), each event with the port's source that
launched it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from port_bench.harness import trace as T
from port_bench.harness.program import COLUMNS, Window

DeviceEvent = Tuple[float, float, str, str]  # (start_us, end_us, name, launching site)


@dataclass
class Traced:
    events: List[DeviceEvent]
    steps: int
    wall_s: float  # the traced stretch on the host clock
    busy_s: float  # the union of the device events
    recorder: object  # harness.work.Recorder of the stretch


@dataclass
class Timeline:
    events: List[Tuple[float, float, str]]  # (start_us, end_us, name)
    steps: int
    wall_s: float  # the stretch on the host clock
    busy_s: float  # the union of the device events
    span_s: float  # from the first device event's start to the last one's end
    untraced_s: float  # the same steps untraced, on the host clock


@dataclass
class Readings:
    window: Window
    rows: np.ndarray  # every step of the window, (steps, B, columns)
    traced: Optional[Traced] = None
    timeline: Optional[Timeline] = None

    def column(self, name: str) -> np.ndarray:
        return self.rows[..., COLUMNS[name]]


def traced(trace: dict, steps: int, wall_s: float, recorder) -> Traced:
    lines = T.device_events(trace)
    sites = T.attribute(trace, lines)
    raw = [ev for line in lines.values() for ev in line]
    events = [(s, e, name, sites.get(id(ev), "")) for ev, (s, e, name) in zip(raw, T.as_events(raw))]
    busy = T.gap_analysis([e[:3] for e in events])["busy"] if events else 0.0
    return Traced(events, steps, wall_s, busy * 1e-6, recorder)


def timeline(trace: dict, steps: int, wall_s: float, untraced_s: float) -> Timeline:
    """The device line of a stretch traced without stacks (on a CPU run,
    its top-level host ops), and the same steps' untraced host time."""
    events = T.as_events([ev for line in T.device_events(trace).values() for ev in line])
    if not events:
        return Timeline([], steps, wall_s, 0.0, 0.0, untraced_s)
    g = T.gap_analysis(events)
    return Timeline(events, steps, wall_s, g["busy"] * 1e-6, g["span"] * 1e-6, untraced_s)


def module_of(site: str) -> str:
    """``ops/filters.py(42): fn aten::sort`` -> ``ops/filters.py``."""
    return site.split("(", 1)[0]


def device_ms_per_step(r: Readings, modules: Sequence[str]) -> Optional[float]:
    """Device time a traced step of the ops launched from ``modules``."""
    t = r.traced
    if t is None or not any(site for *_, site in t.events):
        return None
    us = sum(e - s for s, e, _, site in t.events if module_of(site) in modules)
    return us * 1e-3 / t.steps


def breakdown(line: Timeline, t: Traced, top: int = 10) -> dict:
    """The device ops that took the most time, from the stretch traced
    without stacks, and the idle gaps of the stretch traced with stacks
    summed by the source that launched the op after each (gaps stretched
    by the profiler's cost on the host), in seconds."""
    rows, _ = T.aggregate(line.events)
    gaps = T.gap_analysis([(s, e, site or name) for s, e, name, site in t.events])["idle_by_next"] if t.events else []
    return dict(device_ops=[[n, us * 1e-6] for n, us, _ in rows[:top]],
                idle_gaps=[[n, us * 1e-6] for n, us in gaps[:top]])
