"""The arithmetic that turns a torch.profiler chrome trace into figures.

A copy of the port's ``apps/trace_step.py`` (``device_events``,
``aggregate``, ``gap_analysis``, ``attribute``) kept with the benchmark, so
that no change to the program moves the yardstick: the device events of
the trace by line, their time by name, the busy union and idle gaps of a
line, and the source in the port that launched each device event (the
innermost frame of the port's package around its launch, with the aten op
around that).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

PORT = "mola_lidar_odometry_tpu_torch/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# frames that launch every kernel alike (and the kernels' own ``launch``
# closures): the site is the frame above them, the kernel's wrapper
GENERIC_FRAMES = ("ops/cuda_build.py",)
LAUNCH_FRAME = ": launch"

Event = Tuple[float, float, str]  # (start_us, end_us, name)


def _top_level(evs: List[dict]) -> List[dict]:
    """The events of one thread that no other of them encloses."""
    out, end = [], -float("inf")
    for ev in sorted(evs, key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0)))):
        s = float(ev["ts"])
        if s >= end:
            out.append(ev)
            end = s + float(ev.get("dur", 0.0))
    return out


def device_events(trace: dict) -> Dict[Tuple, List[dict]]:
    """The device events of a trace by line ``(pid, tid)``, as raw trace
    events: a torch trace's ``kernel``/``gpu_memcpy``/``gpu_memset``
    events; else (a CPU run) each thread's top-level ``cpu_op`` events."""
    evs = trace["traceEvents"]
    lines = collections.defaultdict(list)
    for ev in evs:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            lines[(ev["pid"], ev["tid"])].append(ev)
    if lines:
        return dict(lines)
    for ev in evs:
        if ev.get("ph") == "X" and ev.get("cat") == "cpu_op":
            lines[(ev["pid"], ev["tid"])].append(ev)
    return {k: _top_level(v) for k, v in lines.items()}


def as_events(raw: Sequence[dict]) -> List[Event]:
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "?")) for e in raw]


# ---------------------------------------------------------------------------
# pure analysis over (start_us, end_us, name) events
# ---------------------------------------------------------------------------


def aggregate(events: Sequence[Event]):
    """Device time by name: ``(rows, total_us)`` with rows ``(name, us,
    count)`` from the most time to the least (ties in first-seen order)."""
    agg, count = {}, collections.Counter()
    total = 0.0
    for s, e, name in events:
        agg[name] = agg.get(name, 0.0) + (e - s)
        count[name] += 1
        total += e - s
    rows = sorted(((n, us, count[n]) for n, us in agg.items()), key=lambda r: -r[1])
    return rows, total


def gap_analysis(events: Sequence[Event]) -> dict:
    """``eval/trace_gaps.py``'s analysis of one device line: the number of
    events, the span from the first start to the last event's end (in
    start order), the busy union, the idle rest, the gaps ``(gap_us,
    at_us, next_name)`` from the largest, and the idle summed by the op
    that follows each gap."""
    evs = sorted(events)
    span = evs[-1][1] - evs[0][0]
    busy, cur_s, cur_e = 0.0, evs[0][0], evs[0][1]
    gaps = []
    for s, e, name in evs[1:]:
        if s > cur_e:
            gaps.append((s - cur_e, cur_e, name))
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    gaps.sort(reverse=True)
    by_next = collections.defaultdict(float)
    for g, _, nxt in gaps:
        by_next[nxt] += g
    return dict(events=len(evs), span=span, busy=busy, idle=span - busy, gaps=gaps,
                idle_by_next=sorted(by_next.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# attribution to the port's source
# ---------------------------------------------------------------------------


def _frame_site(name: str) -> str:
    i = name.find(PORT)
    return name[i + len(PORT):] if i >= 0 else ""


def _enclosing(intervals: List[dict], queries: List[Tuple[float, int]], pick) -> Dict[int, str]:
    """For each query ``(ts, key)`` of one thread, ``pick(stack)`` over the
    stack of ``intervals`` (nested trace events) open at ``ts``."""
    ivs = sorted(intervals, key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
    out, stack, i = {}, [], 0
    for ts, key in sorted(queries):
        while i < len(ivs) and float(ivs[i]["ts"]) <= ts:
            s = float(ivs[i]["ts"])
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, s + float(ivs[i].get("dur", 0.0)), ivs[i]["name"]))
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[key] = pick(stack)
    return out


def _innermost_port_frame(stack) -> str:
    for _, _, name in reversed(stack):
        site = _frame_site(name)
        if site and not site.startswith(GENERIC_FRAMES) and not site.endswith(LAUNCH_FRAME):
            return site
    return ""


def _innermost_op(stack) -> str:
    return stack[-1][2] if stack else ""


def attribute(trace: dict, lines: Dict[Tuple, List[dict]]) -> Dict[int, str]:
    """The launching site of each device event (by ``id`` of the raw
    event): ``"<port file>(<first line>): <function> <aten op>"``, empty
    where the trace carries no Python stack."""
    evs = trace["traceEvents"]
    by_corr = {}
    for ev in evs:
        if ev.get("ph") == "X" and ev.get("cat") in RUNTIME_CATS:
            c = (ev.get("args") or {}).get("correlation")
            if c is not None:
                by_corr[c] = ev
    frames, ops = collections.defaultdict(list), collections.defaultdict(list)
    for ev in evs:
        if ev.get("ph") == "X" and ev.get("cat") == "python_function":
            frames[ev["tid"]].append(ev)
        elif ev.get("ph") == "X" and ev.get("cat") == "cpu_op":
            ops[ev["tid"]].append(ev)
    queries = collections.defaultdict(list)  # host thread -> [(ts, id of the device event)]
    for line in lines.values():
        for ev in line:
            if ev.get("cat") == "cpu_op":
                host = ev  # a CPU run: the op is its own launch
            else:
                host = by_corr.get((ev.get("args") or {}).get("correlation"))
            if host is not None:
                queries[host["tid"]].append((float(host["ts"]), id(ev)))
    sites = {}
    for tid, qs in queries.items():
        fr = _enclosing(frames.get(tid, []), qs, _innermost_port_frame)
        op = _enclosing(ops.get(tid, []), qs, _innermost_op)
        for _, key in qs:
            sites[key] = " ".join(x for x in (fr[key], op[key]) if x)
    return sites
