"""Per-op device profile of the bench step, and the idle gaps of its timeline.

Port of ``eval/trace_step.py`` and ``eval/trace_gaps.py``.  Runs the bench
configuration (``pipelines/lidar3d-default.yaml``, B=8, the bench's
131072-ray scans sized by ``apps/bench_sequence.py``) for ``--warmup`` (10)
steps, then profiles ``--steps`` (6) steps under ``torch.profiler`` (CPU and
CUDA activities, ``with_stack=True``) and reads the chrome trace it writes:

  * **per-op profile** — the device events (the trace categories ``kernel``,
    ``gpu_memcpy`` and ``gpu_memset``) summed by name, in ms per step and
    share of the device time.  Each row names the Python source that
    launched it: a kernel event's ``correlation`` id leads to its
    ``cudaLaunchKernel``/``cudaLaunchKernelExC``/``cuLaunchKernelEx`` launch event,
    and the innermost frame of the port's package around that event, with
    the aten op around it, is the row's site.  The port's own kernels
    (B1-B4, launched through ``ctypes`` with no aten op above them) are
    named by their Python wrapper's frame.  torch's Python tracer records a
    frame's function and its first line, not the line of the call inside
    it.
  * **gaps** — per device line (one per ``(device, stream)``): events, span,
    busy union, idle and idle per step; the largest single gaps with the op
    after each, and the idle summed by the op that follows and by the
    source that launched it.

``--trace PATH`` skips the run and analyses a trace already written: one of
this tool's (a ``.json``/``.json.gz`` file or the ``--out`` directory) or a
JAX profiler directory (``plugins/profile/*/*.trace.json.gz``, read by the
JAX script's rule: the device processes' events, ``jit_`` containers
skipped).  ``--scan`` profiles the bench's whole sequence (30 scans) from a
fresh carry as one window and reports device time per step as the window's
total over the steps: the nearest counterpart of the JAX script's single
``lax.scan`` dispatch, which the port does not have.  The JAX script's
``--hlo`` has no counterpart (there is no compiled program to dump) and is
dropped.

On the CPU (``--device cpu``) there are no device events: the "device" line
is the CPU thread's top-level aten ops.

Usage:
    python -m mola_lidar_odometry_tpu_torch.apps.trace_step [--steps 6] [--top 40] [--batch 8] [--scan]
    python -m mola_lidar_odometry_tpu_torch.apps.trace_step --trace <dir or file> [--steps 30]
    python -m mola_lidar_odometry_tpu_torch.apps.trace_step --device cpu --batch 2 --rings 16 --azimuth 256 \\
        --warmup 2 --steps 2
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
PORT = "mola_lidar_odometry_tpu_torch/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# frames that launch for every kernel alike (and the kernels' own ``launch``
# closures): the site is the frame above them, the kernel's wrapper
GENERIC_FRAMES = ("ops/cuda_build.py", "apps/trace_step.py")
LAUNCH_FRAME = ": launch"

Event = Tuple[float, float, str]  # (start_us, end_us, name)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def trace_file(path: str) -> str:
    """The trace file at ``path``: the file itself, or the newest of a
    directory's chrome traces (this tool's, or a JAX profiler's
    ``plugins/profile/*/*.trace.json.gz``)."""
    if os.path.isfile(path):
        return path
    found = (glob.glob(os.path.join(path, "plugins/profile/*/*.trace.json.gz"))
             + glob.glob(os.path.join(path, "*.json")) + glob.glob(os.path.join(path, "*.json.gz")))
    if not found:
        raise FileNotFoundError(f"no trace under {path}")
    return max(found, key=os.path.getmtime)


def load_trace(path: str) -> dict:
    path = trace_file(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _jax_device_pids(trace: dict) -> set:
    names = {ev["pid"]: ev["args"].get("name", "") for ev in trace["traceEvents"]
             if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    return {p for p, n in names.items() if "TPU" in n or "/device" in n.lower()}


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
    events; else a JAX trace's "X" events of its device processes without
    the ``jit_`` program containers (``eval/trace_step.py``'s rule); else
    (a CPU run) each thread's top-level ``cpu_op`` events."""
    evs = trace["traceEvents"]
    lines = collections.defaultdict(list)
    for ev in evs:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            lines[(ev["pid"], ev["tid"])].append(ev)
    if lines:
        return dict(lines)
    pids = _jax_device_pids(trace)
    for ev in evs:
        if ev.get("ph") != "X" or ev.get("pid") not in pids:
            continue
        name = ev.get("name", "?")
        if name.startswith("jit_") or ("program_id" in name and not (ev.get("args") or {})):
            continue
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


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


def analyse(trace: dict, steps: int, wall_ms: float = None) -> dict:
    """Every figure of the report from a loaded trace: per-op rows with
    their sites, the device ms per step, the busy union, and the gap
    analysis of each device line."""
    lines = device_events(trace)
    if not lines:
        raise ValueError("the trace holds no device events")
    sites = attribute(trace, lines)
    raw = [ev for line in lines.values() for ev in line]
    every = as_events(raw)
    rows, total = aggregate(every)
    by_site = collections.defaultdict(collections.Counter)
    for ev, (s, e, name) in zip(raw, every):
        by_site[name][sites.get(id(ev), "")] += e - s
    busy = gap_analysis(every)["busy"]
    window = (max(e for _, e, _ in every) - min(s for s, _, _ in every)) if every else 0.0
    tnames = {(ev["pid"], ev["tid"]): ev["args"].get("name", "") for ev in trace["traceEvents"]
              if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    gaps = {}
    for key, line in sorted(lines.items(), key=lambda kv: -len(kv[1])):
        g = gaps[key] = dict(gap_analysis(as_events(line)), thread=tnames.get(key, ""))
        if any(sites.get(id(ev)) for ev in line):  # the same gaps, each by the source of the op after it
            named = [(s, e, sites.get(id(ev)) or name) for ev, (s, e, name) in zip(line, as_events(line))]
            g["idle_by_next_site"] = gap_analysis(named)["idle_by_next"]
    return dict(rows=rows, total_us=total, steps=steps, sites={n: c.most_common() for n, c in by_site.items()},
                busy_us=busy, device_span_us=window, wall_ms=wall_ms, lines=gaps,
                device_ops=sum(r[2] for r in rows))


def print_profile(rep: dict, top: int = 40, out=sys.stdout, batch: int = None) -> None:
    steps, total = rep["steps"], rep["total_us"]
    b = f"B={batch}, " if batch else ""
    print(f"total device time: {total / 1e3 / steps:.3f} ms/step  ({b}{steps} steps)", file=out)
    print(f"{'ms/step':>9}  {'%':>5}  name / source", file=out)
    shown = 0.0
    for name, us, n in rep["rows"][:top]:
        shown += us
        print(f"{us / 1e3 / steps:9.3f}  {100 * us / total:5.1f}  {name[:110]}  x{n / steps:g}/step", file=out)
        for site, s_us in rep["sites"].get(name, [])[:3]:
            if site:
                print(f"{'':17}{s_us / 1e3 / steps:.3f} ms/step at {site[:100]}", file=out)
    print(f"(top {top} = {100 * shown / total:.1f}% of device time)", file=out)
    if rep["wall_ms"]:
        print(f"busy union {rep['busy_us'] / 1e3:.3f} ms of the {rep['wall_ms']:.3f} ms profiled window "
              f"({100 * rep['busy_us'] / 1e3 / rep['wall_ms']:.1f}% busy)", file=out)


def print_gaps(rep: dict, top: int = 25, out=sys.stdout) -> None:
    steps = rep["steps"]
    for (pid, tid), g in rep["lines"].items():
        span, busy, idle = g["span"], g["busy"], g["idle"]
        print(f"\nline pid={pid} tid={tid} [{g['thread']}]: {g['events']} events, span {span / 1e3:.2f} ms, "
              f"busy {busy / 1e3:.2f} ms, idle {idle / 1e3:.2f} ms ({100 * idle / span if span else 0.0:.1f}%)"
              f" -> idle/step {idle / 1e3 / steps:.3f} ms", file=out)
        print("  largest single gaps (ms, before op):", file=out)
        for gap, _, nxt in g["gaps"][:top]:
            print(f"    {gap / 1e3:8.3f}  before {nxt[:90]}", file=out)
        print("  idle aggregated by the op that follows the gap (ms total):", file=out)
        for nxt, gap in g["idle_by_next"][:top]:
            print(f"    {gap / 1e3:8.3f}  {nxt[:90]}", file=out)
        if "idle_by_next_site" in g:
            print("  idle aggregated by the source that launched the op after the gap (ms total):", file=out)
            for site, gap in g["idle_by_next_site"][:top]:
                print(f"    {gap / 1e3:8.3f}  {site[:90]}", file=out)


# ---------------------------------------------------------------------------
# the profiled program
# ---------------------------------------------------------------------------


def synchronize(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def profile_window(fn, device, path: str, with_stack: bool = True):
    """Runs ``fn()`` under ``torch.profiler`` (CPU activity, and CUDA on a
    card), writes the chrome trace to ``path``; returns (fn's result, the
    window's wall ms, the loaded trace)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if str(device).startswith("cuda") else [])
    with profile(activities=acts, with_stack=with_stack) as prof:
        t0 = time.perf_counter()
        res = fn()
        synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(path)
    return res, wall, load_trace(path)


def profile_device(fn, device):
    """Runs ``fn()`` under ``torch.profiler`` without Python stacks; returns
    (fn's result, the window's wall ms, the device events' rows by name as
    :func:`aggregate` gives them, their total us)."""
    with tempfile.TemporaryDirectory() as d:
        res, wall, trace = profile_window(fn, device, os.path.join(d, "trace.json"), with_stack=False)
    lines = device_events(trace)
    rows, total = aggregate(as_events([ev for line in lines.values() for ev in line]))
    return res, wall, rows, total


def bench_program(args, device, sequence=None):
    """The bench's spec, step and packed scans at ``--batch``; the scans and
    trajectory are ``sequence`` when given (at least as many scans as the
    run steps; with ``--scan``, all of them), else simulated."""
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    if args.scan:
        n = len(sequence[0]) if sequence is not None else bs.N_SCANS
    else:
        n = args.warmup + args.steps
    if sequence is None:
        sequence = bs.gen_scans(n, n_rings=args.rings, n_azimuth=args.azimuth)
    scans, traj = sequence[0][:n], sequence[1]
    if len(scans) < n:
        raise ValueError(f"trace_step: {n} scans needed, {len(scans)} given")
    cfg = load_yaml_file(os.path.join(ROOT, "pipelines", "lidar3d-default.yaml"), env={})
    spec = spec_from_yaml(cfg, kf_ring_capacity=256, **bs.resolve_sizing(cfg, scans))
    B = args.batch
    stamps = traj.stamps[:n].astype("float32")
    packed = [pb.pack_scans(spec, [s] * B, [stamps[k]] * B, device=device) for k, s in enumerate(scans)]
    return spec, pb.make_fleet_step(spec), packed


def run(args, device, sequence=None) -> dict:
    """Profiles the bench step as the flags say (over ``sequence``, the
    bench's ``(scans, trajectory)``, when given); returns the analysis."""
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb

    spec, fstep, packed = bench_program(args, device, sequence)
    B = args.batch
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "torch_trace.json")
    carry = pb.init_fleet_carry(spec, B, device=device)
    if args.scan:
        for scan in packed:  # the whole sequence once: kernels built and loaded, caches warm
            carry, _ = fstep(carry, scan)
        synchronize(device)
        t0 = time.perf_counter()
        carry = pb.init_fleet_carry(spec, B, device=device)
        for scan in packed:
            carry, _ = fstep(carry, scan)
        synchronize(device)
        plain_ms = (time.perf_counter() - t0) * 1e3 / len(packed)
        carry = pb.init_fleet_carry(spec, B, device=device)

        def window():
            c = carry
            for scan in packed:
                c, _ = fstep(c, scan)
            return c

        steps = len(packed)
    else:
        for k in range(args.warmup):  # into steady state: map built, tracking converged
            t0 = time.perf_counter()
            carry, _ = fstep(carry, packed[k])
            synchronize(device)
        plain_ms = (time.perf_counter() - t0) * 1e3  # the last warm-up step, unprofiled

        def window():
            c = carry
            for k in range(args.warmup, args.warmup + args.steps):
                c, _ = fstep(c, packed[k])
            return c

        steps = args.steps
    _, wall, trace = profile_window(window, device, path)
    rep = analyse(trace, steps, wall)
    rep.update(plain_step_ms=plain_ms, trace_path=path, batch=B)
    return rep


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="trace_step", description="per-op device profile of the bench step "
                                 "and the idle gaps of its device timeline (PyTorch/CUDA engine)")
    ap.add_argument("--steps", type=int, default=6, help="profiled steps (with --trace: the steps the trace holds)")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "mola_torch_trace"))
    ap.add_argument("--scan", action="store_true",
                    help="profile the bench's whole sequence (30 scans) from a fresh carry as one window; "
                         "device time per step = total / steps")
    ap.add_argument("--warmup", type=int, default=10, help="unprofiled steps before the window (the JAX script's 10)")
    ap.add_argument("--trace", default="", help="analyse this trace (file or directory) instead of running")
    ap.add_argument("--gaps-top", type=int, default=25, help="gaps listed per device line (trace_gaps.py's --top)")
    ap.add_argument("--rings", type=int, default=64)
    ap.add_argument("--azimuth", type=int, default=2048)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.trace:
        rep = analyse(load_trace(args.trace), args.steps)
        print(f"trace: {trace_file(args.trace)}")
        print_profile(rep, args.top)
        print_gaps(rep, args.gaps_top)
        return rep
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("trace_step: no CUDA device visible; pass --device cpu to run on the CPU")
    rep = run(args, args.device)
    print(f"trace: {rep['trace_path']}", file=sys.stderr)
    print_profile(rep, args.top, batch=args.batch)
    print(f"profiled window {rep['wall_ms']:.3f} ms for {rep['steps']} steps = "
          f"{rep['wall_ms'] / rep['steps']:.3f} ms/step wall; one step unprofiled {rep['plain_step_ms']:.3f} ms")
    print_gaps(rep, args.gaps_top)
    return rep


if __name__ == "__main__":
    main()
