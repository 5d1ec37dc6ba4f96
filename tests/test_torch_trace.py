"""The port's trace tool (``apps/trace_step.py``) against the JAX repo's.

A synthetic gzipped chrome trace with a ``/device:TPU:0`` process (two
device lines, overlapping, nested and gapped events, a ``jit_`` program
container, a ``program_id`` row and host events) is written where a JAX
profile lands (``<tmp>/plugins/profile/x/``).  The unchanged
``eval/trace_gaps.py`` (it imports no JAX) runs on it as a subprocess; the
port's gap analysis must print the same events, span, busy, idle, ranked
gaps and idle by next op, and its aggregation must give the totals and
ranking of ``eval/trace_step.py``'s rule (device processes only, ``jit_``
containers and bare ``program_id`` rows skipped).  The attribution of a
device event to the port's source is held on a synthetic torch trace (a
kernel's correlation id to its launch, the launch to the enclosing frames).
Last the tool runs on the CPU at a tiny size (B=2, 16 x 256 scans, 2 warm-up
and 2 profiled steps, and with ``--scan`` over a 2-scan sequence): its rows
sum to its total."""

import gzip
import io
import json
import os
import re
import subprocess
import sys

import pytest

from mola_lidar_odometry_tpu_torch.apps import trace_step as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port steps on one torch thread (the tests run beside others)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(pid, tid, ts_, dur, name, **args):
    ev = {"ph": "X", "pid": pid, "tid": tid, "ts": ts_, "dur": dur, "name": name}
    if args:
        ev["args"] = args
    return ev


def _jax_trace(shift: int) -> dict:
    """A TPU process (pid 1) with two lines, a host process (pid 7)."""
    meta = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2, "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 3, "args": {"name": "XLA Modules"}},
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "/host:CPU"}},
    ]
    s = shift
    ops = [
        _x(1, 2, s + 0, 5000, "jit_step(17)"),  # the program container: skipped
        _x(1, 2, s + 10, 120, "fusion.1", source="ops/filters.py:88"),
        _x(1, 2, s + 100, 250, "sort.3", long_name="sort(...)"),  # overlaps fusion.1
        _x(1, 2, s + 150, 40, "fusion.1", source="ops/filters.py:88"),  # nested in sort.3
        _x(1, 2, s + 1350, 300, "scatter.7", source="ops/voxel_hash.py:400"),  # after a 1000 us gap
        _x(1, 2, s + 1650, 100, "fusion.9"),  # touches the last one: no gap
        _x(1, 2, s + 2000, 60, "program_id=3"),  # a bare program row: skipped
        _x(1, 2, s + 2250, 500, "sort.3", long_name="sort(...)"),
        _x(1, 2, s + 4750, 250, "fusion.1", source="ops/filters.py:88"),
        _x(1, 3, s + 500, 700, "copy.2"),
        _x(1, 3, s + 3200, 800, "fusion.9"),
        _x(7, 9, s + 0, 9000, "host work"),  # not a device: skipped
    ]
    return {"traceEvents": meta + ops}


def _write(tmp, trace) -> str:
    d = os.path.join(tmp, "plugins", "profile", "x")
    os.makedirs(d, exist_ok=True)
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as f:
        json.dump(trace, f)
    return str(tmp)


def _parse_gaps(text: str) -> dict:
    """The figures of ``eval/trace_gaps.py``'s printout, by ``(pid, tid)``."""
    out, cur, section = {}, None, None
    for line in text.splitlines():
        m = re.match(r"line pid=(\d+) tid=(\d+) \[(.*)\]: (\d+) events, span ([\d.]+) ms, busy ([\d.]+) ms, "
                     r"idle ([\d.]+) ms \(([\d.]+)%\) -> idle/step ([\d.]+) ms", line)
        if m:
            cur = out[(int(m[1]), int(m[2]))] = dict(head=m.groups()[2:], gaps=[], by_next=[])
            continue
        if "largest single gaps" in line:
            section = "gaps"
        elif "idle aggregated" in line:
            section = "by_next"
        elif cur is not None and line.startswith("    "):
            cur[section].append(line.strip())
    return out


@pytest.mark.parametrize("shift", [0, 1000000])
def test_gaps_equal_the_jax_script(tmp_path, shift):
    d = _write(tmp_path, _jax_trace(shift))
    res = subprocess.run([sys.executable, os.path.join(ROOT, "eval", "trace_gaps.py"), "--trace", d, "--steps",
                          str(STEPS)], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    want = _parse_gaps(res.stdout)
    buf = io.StringIO()
    rep = ts.analyse(ts.load_trace(d), STEPS)
    ts.print_gaps(rep, out=buf)
    got = _parse_gaps(buf.getvalue())
    assert sorted(got) == sorted(want) == [(1, 2), (1, 3)]
    assert got == want
    g = rep["lines"][(1, 2)]  # the figures themselves, not only their print
    assert (g["events"], g["span"], g["busy"], g["idle"]) == (7, 4990.0, 1490.0, 3500.0)
    assert [(gap, nxt) for gap, _, nxt in g["gaps"]] == [(2000.0, "fusion.1"), (1000.0, "scatter.7"), (500.0, "sort.3")]


def test_aggregation_follows_the_jax_scripts_rule(tmp_path):
    """Totals and ranking as ``eval/trace_step.py`` computes them (its loop,
    restated): X events of the device processes, ``jit_`` containers and
    argument-less ``program_id`` rows skipped, durations summed by name."""
    trace = ts.load_trace(_write(tmp_path, _jax_trace(0)))
    pid_name = {ev["pid"]: ev["args"].get("name", "") for ev in trace["traceEvents"]
                if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    dev_pids = {p for p, n in pid_name.items() if "TPU" in n or "/device" in n.lower()}
    agg, total = {}, 0.0
    for ev in trace["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("pid") not in dev_pids:
            continue
        name, a = ev.get("name", "?"), ev.get("args", {}) or {}
        if name.startswith("jit_") or ("program_id" in name and not a):
            continue
        agg[name] = agg.get(name, 0.0) + float(ev.get("dur", 0.0))
        total += float(ev.get("dur", 0.0))
    want = sorted(agg.items(), key=lambda kv: -kv[1])
    rep = ts.analyse(trace, STEPS)
    assert rep["total_us"] == total == 3060.0
    assert [(n, us) for n, us, _ in rep["rows"]] == want
    buf = io.StringIO()
    ts.print_profile(rep, top=40, out=buf)
    assert buf.getvalue().splitlines()[0] == f"total device time: {total / 1e3 / STEPS:.3f} ms/step  ({STEPS} steps)"


def _torch_trace() -> dict:
    """A torch-style trace: two kernels on stream 7 and a memcpy on stream
    13 of device 0, launched from host thread 5 inside the port's frames."""
    port = "/x/mola_lidar_odometry_tpu_torch/"
    py = "python_function"
    evs = [
        dict(_x(5, 5, 0, 1000, f"{port}models/step.py(228): step"), cat=py),
        dict(_x(5, 5, 10, 300, f"{port}ops/voxel_hash.py(220): _seg_cumsum"), cat=py),
        dict(_x(5, 5, 20, 100, "torch/_tensor.py(40): wrapped"), cat=py),
        dict(_x(5, 5, 30, 50, "aten::cumsum"), cat="cpu_op"),
        dict(_x(5, 5, 40, 5, "cudaLaunchKernel", correlation=11), cat="cuda_runtime"),
        dict(_x(5, 5, 400, 300, f"{port}ops/pallas_capture.py(280): capture_planar"), cat=py),
        dict(_x(5, 5, 405, 200, f"{port}ops/pallas_capture.py(345): launch"), cat=py),
        dict(_x(5, 5, 410, 100, f"{port}ops/cuda_build.py(150): launch"), cat=py),
        dict(_x(5, 5, 420, 5, "cuLaunchKernelEx", correlation=12), cat="cuda_driver"),
        dict(_x(5, 5, 800, 5, "cudaMemcpyAsync", correlation=13), cat="cuda_runtime"),
        dict(_x(0, 7, 60, 20, "void cub::DeviceScanKernel<int>", correlation=11), cat="kernel"),
        dict(_x(0, 7, 430, 60, "capture_gather_kernel", correlation=12), cat="kernel"),
        dict(_x(0, 13, 810, 30, "Memcpy DtoH (Device -> Pinned)", correlation=13), cat="gpu_memcpy"),
    ]
    return {"traceEvents": evs}


def test_attribution_follows_correlation_to_the_port_frame():
    rep = ts.analyse(_torch_trace(), 1)
    assert sorted(rep["lines"]) == [(0, 7), (0, 13)]  # one line per stream
    assert rep["sites"]["void cub::DeviceScanKernel<int>"] == [("ops/voxel_hash.py(220): _seg_cumsum aten::cumsum",
                                                              20.0)]
    # a kernel launched through ctypes: no aten op, the wrapper's frame above its launch closure and the
    # generic launcher
    assert rep["sites"]["capture_gather_kernel"] == [("ops/pallas_capture.py(280): capture_planar", 60.0)]
    assert rep["sites"]["Memcpy DtoH (Device -> Pinned)"] == [("models/step.py(228): step", 30.0)]
    assert rep["total_us"] == 110.0 and rep["busy_us"] == 110.0 and rep["device_ops"] == 3
    # the gap on stream 7 by the op after it, and by the source that launched that op
    assert rep["lines"][(0, 7)]["idle_by_next"] == [("capture_gather_kernel", 350.0)]
    assert rep["lines"][(0, 7)]["idle_by_next_site"] == [("ops/pallas_capture.py(280): capture_planar", 350.0)]


def test_tool_runs_on_the_cpu_at_a_tiny_size(tmp_path):
    rep = ts.main(["--device", "cpu", "--batch", "2", "--rings", "16", "--azimuth", "256", "--warmup", "2",
                   "--steps", "2", "--top", "5", "--out", str(tmp_path)])
    assert rep["steps"] == 2 and rep["batch"] == 2
    assert sum(us for _, us, _ in rep["rows"]) == pytest.approx(rep["total_us"], rel=1e-12)
    assert sum(n for _, _, n in rep["rows"]) == rep["device_ops"] > 0
    # every row's sites sum to the row, and the port's step frames name most of the time
    for name, us, _ in rep["rows"]:
        assert sum(s_us for _, s_us in rep["sites"][name]) == pytest.approx(us, rel=1e-9)
    named = sum(s_us for sites in rep["sites"].values() for site, s_us in sites if site.startswith(("ops/", "models/")))
    assert named > 0.5 * rep["total_us"]
    (line,) = rep["lines"].values()  # one host thread: its top-level ops
    assert line["busy"] <= line["span"] and rep["busy_us"] <= 1e3 * rep["wall_ms"]


def test_scan_window_profiles_the_whole_sequence(tmp_path):
    """``--scan``: every scan of the sequence stepped from a fresh carry in
    one profiled window, device time per step over all of them."""
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs

    seq = bs.gen_scans(2, n_rings=16, n_azimuth=256)
    args = ts.build_parser().parse_args(["--device", "cpu", "--batch", "2", "--scan", "--out", str(tmp_path)])
    rep = ts.run(args, "cpu", seq)
    assert rep["steps"] == 2 and rep["batch"] == 2 and rep["plain_step_ms"] > 0
    assert sum(us for _, us, _ in rep["rows"]) == pytest.approx(rep["total_us"], rel=1e-12)
    assert rep["device_ops"] > 0 and os.path.exists(rep["trace_path"])
    (line,) = rep["lines"].values()
    assert line["busy"] <= line["span"] and rep["busy_us"] <= 1e3 * rep["wall_ms"]


def test_profile_device_sums_one_call():
    """``profile_device`` (``chip_smoke.py``'s one-step profile and the
    stage split's device column): the call's result, and its top-level ops
    on the CPU, by name, summing to the total."""
    import torch

    x = torch.arange(4096, dtype=torch.float32)
    res, wall, rows, total = ts.profile_device(lambda: torch.sort(-x)[0].cumsum(0), "cpu")
    assert torch.equal(res, torch.sort(-x)[0].cumsum(0))
    assert {"aten::sort", "aten::cumsum"} <= {n for n, _, _ in rows}
    assert sum(us for _, us, _ in rows) == pytest.approx(total) and 0 < total <= 1e3 * wall
