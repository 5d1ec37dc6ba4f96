"""The fleet step's own spans and counters over the traced stretch's steps,
and the device's idle split by the span open on the host.

The port's fleet step opens a span a layer on the active profiler
(``utils/profiler.py``: ``step``, ``step.filters``, ``step.icp``,
``step.map``) and counts its host syncs (``host_syncs``) and kernel B3's
waves (``b3.waves``) there.  :func:`spanned_stretch` runs the run's own
step over the steps of the cell's trace stretch twice more, through
``harness/program.py``'s stretches, with an enabled profiler of its own
active from the stretch's first step: pass (a) ``timed_stretch`` (host
times, counters, wall time), pass (b) ``traced_stretch`` without stacks
(the device line, and the spans mapped onto the trace's clock through the
profiler's clock anchor).

The per-layer readers get only a run's ``Readings``; :func:`of` makes the
stretch on the first read of a ``--trace 1`` run, from the program and cell
of the run in the calling frames (``run.py::run_cell``'s locals ``prog``
and ``cell``), and keeps it on the ``Readings``.  It runs nothing where
the program has no active profiler to set (a checkout older than its
spans), and says so where a traced run has no program and cell in its
frames.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from port_bench.harness import trace as T

LAYERS = ("filters", "icp", "map")  # the step's children; the rest of ``step`` is its own
Interval = Tuple[str, int, float, float]  # (full span name, step index, start, end)


@dataclass
class Spans:
    steps: int
    host: List[Interval]  # pass (a), in ns on the host's monotonic clock
    counters: Dict[str, List[float]]  # pass (a)
    wall_s: float  # pass (a): the first step's call to the last one's outputs on the host
    on_trace: List[Interval]  # pass (b), in us on the trace's clock
    device: List[T.Event]  # pass (b)'s device events


def _layer(name: str) -> str:
    """``step.icp`` -> ``icp``; ``step`` -> ``step``."""
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else parts[0]


def host_ms(s: Spans) -> Dict[str, float]:
    """Host ms a step: each layer's span, and ``step`` less its children."""
    total = {k: 0.0 for k in ("step",) + LAYERS}
    top = {"step"} | {"step." + k for k in LAYERS}
    for name, _, t0, t1 in s.host:
        if name in top:
            total[_layer(name)] += (t1 - t0) * 1e-6
    total["step"] -= sum(total[k] for k in LAYERS)
    return {k: v / s.steps for k, v in total.items()}


def _overlap(gaps: np.ndarray, spans: List[Interval]) -> float:
    if not spans or not len(gaps):
        return 0.0
    iv = np.array([(t0, t1) for *_, t0, t1 in spans])
    lo = np.maximum(gaps[:, None, 0], iv[None, :, 0])
    hi = np.minimum(gaps[:, None, 1], iv[None, :, 1])
    return float(np.clip(hi - lo, 0.0, None).sum())


def idle_ms(s: Spans) -> Optional[Dict[str, float]]:
    """The gaps of pass (b)'s device busy union, ms a step, split over the
    span open on the host innermost during each: to its layer (the
    ``step`` child it lies in), to ``step`` where only the step's own span
    is open, and to ``outside`` where none is (the harness between steps).
    Children nest inside their parent and do not overlap each other, so a
    layer's share is its spans' overlap with the gaps."""
    if not s.device:
        return None
    g = T.gap_analysis(s.device)
    gaps = np.array([(at, at + us) for us, at, _ in g["gaps"]]).reshape(-1, 2)
    by = {k: [iv for iv in s.on_trace if iv[0] == "step." + k] for k in LAYERS}
    out = {k: _overlap(gaps, by[k]) for k in LAYERS}
    in_step = _overlap(gaps, [iv for iv in s.on_trace if iv[0] == "step"])
    out["step"] = in_step - sum(out[k] for k in LAYERS)
    out["outside"] = g["idle"] - in_step
    return {k: v * 1e-3 / s.steps for k, v in out.items()}


def counter_per_step(s: Spans, name: str) -> float:
    return sum(s.counters.get(name, [])) / s.steps


def counter_mean(s: Spans, name: str) -> Optional[float]:
    v = s.counters.get(name, [])
    return sum(v) / len(v) if v else None


# ---------------------------------------------------------------------------
# the stretch
# ---------------------------------------------------------------------------


def _profiler_module():
    """The port's profiler module, where it has an active profiler to set."""
    from mola_lidar_odometry_tpu_torch.utils import profiler

    return profiler if hasattr(profiler, "use") and hasattr(profiler.Profiler, "take") else None


def _profiled_from(prog, prof, start_frame: int):
    """``prog`` whose step runs with ``prof`` active from its
    ``start_frame``-th call on: the stretch, not the replay before it."""
    P = _profiler_module()
    calls = itertools.count()

    def step(carry, scan):
        if next(calls) < start_frame:
            return prog.step(carry, scan)
        with P.use(prof):
            return prog.step(carry, scan)

    return dataclasses.replace(prog, step=step)


def spanned_stretch(prog, start_frame: int, steps: int, tmpdir: str) -> Optional[Spans]:
    from port_bench.harness import program

    P = _profiler_module()
    if P is None:
        return None
    pa_ = P.Profiler(timeline=True)
    wall = program.timed_stretch(_profiled_from(prog, pa_, start_frame), start_frame, steps)
    host, counters = pa_.take()

    pb_ = P.Profiler(timeline=True)
    trace, _, _ = program.traced_stretch(_profiled_from(prog, pb_, start_frame), start_frame, steps, tmpdir,
                                         stacks=False)
    base = float(trace.get("baseTimeNanoseconds", 0))
    on_trace = [(n, k, (pb_.epoch_ns(t0) - base) * 1e-3, (pb_.epoch_ns(t1) - base) * 1e-3)
                for n, k, t0, t1 in pb_.take()[0]]
    device = T.as_events([ev for line in T.device_events(trace).values() for ev in line])
    return Spans(steps, host, counters, wall, on_trace, device)


def _the_run():
    """``(program, cell)`` of the run in the calling frames, if any."""
    from port_bench.harness import program

    f = sys._getframe(1)
    while f is not None:
        prog, cell = f.f_locals.get("prog"), f.f_locals.get("cell")
        if isinstance(prog, program.Program) and isinstance(cell, program.Cell):
            return prog, cell
        f = f.f_back
    return None


def of(r) -> Optional[Spans]:
    """The spanned stretch of the run whose ``Readings`` is ``r``: made on
    the first call of a traced run, ``None`` without a trace, a run or a
    program with spans."""
    if "spans" in vars(r):
        return r.spans
    r.spans = None
    if r.timeline is None or _profiler_module() is None:
        return None
    run = _the_run()
    if run is None:
        print("spans: a traced run with no `prog` and `cell` of port_bench's types in the calling frames; "
              "the spans' metrics read nothing", file=sys.stderr, flush=True)
        return None
    prog, cell = run
    ts = cell.settings["trace"]
    with tempfile.TemporaryDirectory() as tmp:
        r.spans = s = spanned_stretch(prog, ts["start_frame"], ts["steps"], tmp)
    print(summary(s, r.timeline.untraced_s), file=sys.stderr, flush=True)
    return r.spans


def summary(s: Spans, untraced_s: float) -> str:
    """One log line: the stretch's walls, host split, idle split, counters."""
    h, idle = host_ms(s), idle_ms(s)
    g = T.gap_analysis(s.device) if s.device else dict(idle=0.0, span=0.0)
    step_s = sum(t1 - t0 for n, _, t0, t1 in s.host if n == "step") * 1e-9
    return (f"spans: {s.steps} steps; pass (a) {s.wall_s!r} s, its `step` spans {step_s!r} s, against "
            f"{untraced_s!r} s in the untraced stretch; host ms a step {h}; pass (b) device idle "
            f"{g['idle'] * 1e-6!r} s of a {g['span'] * 1e-6!r} s span, split in ms a step {idle}; "
            f"host_syncs {s.counters.get('host_syncs')}, b3.waves {s.counters.get('b3.waves')}")
