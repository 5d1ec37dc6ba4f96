"""The port's profiler (``utils/profiler.py``) and the spans and counters of
the fleet step, port only (no JAX).

On the CPU: a disabled profiler records nothing; spans nest and share a
step index; each thread has its own active profiler; counters; a span's
start maps onto a ``torch.profiler`` trace's clock; a B=2
``lidar3d-default`` fleet step opens every layer's span once a step,
counts one host sync a loop test and gives bit-identical outputs and
carries with the profiler on and off; the host API's ``onLidar.step``
carries the layers' spans.

The card tests are marked ``cuda`` and skip without a CUDA device.  On a
machine with a GPU and nvcc:

    python -m pytest tests/test_torch_profiler.py -q -m cuda --noconftest
"""

import contextlib
import json
import math
import os
import threading
import time
import warnings

import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry
from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
from mola_lidar_odometry_tpu_torch.parallel import batch as pb, point_axis as pa
from mola_lidar_odometry_tpu_torch.utils import profiler, sim
from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file
from mola_lidar_odometry_tpu_torch.utils.profiler import Profiler

HERE = os.path.dirname(os.path.abspath(__file__))
PIPE = os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")
CAPS = {  # tests/test_torch_step.py's small capacities
    "raw": 1 << 15, "decimated_for_map_raw": 16384, "decimated_for_icp_skewed": 8192,
    "decimated_for_icp": 8192, "decimated_for_map": 16384,
}
SIZING = dict(raw_capacity=1 << 15, map_slots=1 << 16, layer_capacities=CAPS)
B, FRAMES = 2, 2
LAYERS = ("step", "step.filters", "step.icp", "step.map")


def test_a_disabled_profiler_records_nothing():
    p = Profiler(enabled=False, timeline=True)
    assert p.enter("step") is profiler.NO_SPAN and p.enter("icp") is profiler.NO_SPAN
    with p.enter("step"):
        p.add("host_syncs")
    assert p.take() == ([], {}) and p.times("step") == [] and p.mean("host_syncs") == 0.0
    assert not profiler.active().enabled  # the process's default


def test_spans_nest_by_full_name_and_share_the_step_index():
    p = Profiler(timeline=True)
    with profiler.use(p):
        for _ in range(2):
            with profiler.active().enter("step", new_step=True):
                with p.enter("icp"):
                    with p.enter("inner"):
                        pass
                with p.enter("map"):
                    pass
    assert profiler.active() is not p
    assert len(p.times("step.icp")) == 2  # read from the records, until they are taken
    records, _ = p.take()
    assert [(n, k) for n, k, _, _ in records] == [
        ("step.icp.inner", 0), ("step.icp", 0), ("step.map", 0), ("step", 0),
        ("step.icp.inner", 1), ("step.icp", 1), ("step.map", 1), ("step", 1)]
    assert all(t0 <= t1 for *_, t0, t1 in records)
    assert p.times("step.icp") == [] and p.take() == ([], {})


def test_each_thread_has_its_own_active_profiler():
    """Two threads, each with its own profiler active, interleave their
    spans step by step; neither sees the other's spans or counters, and
    the process's default stays disabled in both."""
    profs = [Profiler(timeline=True) for _ in range(2)]
    turn = [threading.Barrier(2) for _ in range(6)]

    def work(p):
        with profiler.use(p):
            for k in range(3):
                turn[2 * k].wait()
                with profiler.active().enter("step", new_step=True):
                    turn[2 * k + 1].wait()
                    profiler.host_bool(torch.tensor(True))
        assert not profiler.active().enabled

    threads = [threading.Thread(target=work, args=(p,)) for p in profs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for p in profs:
        records, counters = p.take()
        assert [(n, k) for n, k, _, _ in records] == [("step", 0), ("step", 1), ("step", 2)]
        assert counters == {"host_syncs": [1, 1, 1]}
    assert not profiler.active().enabled


def test_counters_add_and_mean():
    p = Profiler()
    p.add("host_syncs")
    p.add("host_syncs")
    p.add("b3.waves", 4)
    p.add("b3.waves", 5)
    assert p.mean("b3.waves") == 4.5 and p.last("b3.waves") == 5 and p.mean("host_syncs") == 1.0
    _, counters = p.take()
    assert counters == {"host_syncs": [1, 1], "b3.waves": [4, 5]}


def _trace(tmp_path, prof) -> dict:
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)


def _trace_ns(trace: dict, ts_us: float) -> float:
    """A chrome trace's ``ts`` on ``time.time_ns()``'s clock."""
    return float(ts_us) * 1e3 + float(trace.get("baseTimeNanoseconds", 0))


def test_a_span_maps_onto_the_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    p = Profiler(timeline=True)
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        with p.enter("step"):
            with record_function("marker"):
                torch.ones(64).sum()
    trace = _trace(tmp_path, tp)
    (marker,) = [e for e in trace["traceEvents"] if e.get("name") == "marker" and e.get("ph") == "X"]
    ((_, _, t0, t1),) = p.take()[0]
    at = _trace_ns(trace, marker["ts"])
    assert abs(at - p.epoch_ns(t0)) < 1e6
    assert at <= p.epoch_ns(t1) + 1e6


@pytest.fixture(scope="module")
def seqs():
    return [sim.simulate_sequence(FRAMES, traj_seed=s) for s in (1, 2)]


def _scans(spec, seqs, device):
    return [pb.pack_scans(spec, [seqs[b][1][k] for b in range(B)], [seqs[b][0].stamps[k] for b in range(B)],
                          device=device) for k in range(FRAMES)]


def _leaves(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in _leaves(y)]
    return []


def _assert_identical(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _run(spec, scans, device, prof=None):
    """The fleet's outputs and last carry; with ``prof`` active, also the
    loop tests the step made (calls of ``point_axis.all_any``)."""
    step = pb.make_fleet_step(spec)
    carry = pb.init_fleet_carry(spec, B, device=device)
    outs, tests = [], [0]
    real = pa.all_any

    def counted(t, axis):
        tests[0] += 1
        return real(t, axis)

    mp = pytest.MonkeyPatch()
    mp.setattr(pa, "all_any", counted)
    try:
        with profiler.use(prof) if prof is not None else contextlib.nullcontext():
            for scan in scans:
                carry, out = step(carry, scan)
                outs.append(out)
    finally:
        mp.undo()
    return outs, carry, tests[0]


def _check_spans(records, counters, steps, loop_tests):
    by_step = [[r for r in records if r[1] == k] for k in range(steps)]
    assert sum(map(len, by_step)) == len(records)
    for recs in by_step:
        names = [n for n, *_ in recs]
        assert sorted(names) == sorted(LAYERS), names
        opened = {n: (t0, t1) for n, _, t0, t1 in recs}
        for n, _, t0, t1 in recs:
            if n != "step":
                p0, p1 = opened["step"]
                assert p0 <= t0 <= t1 <= p1, n
    assert len(counters["host_syncs"]) == loop_tests >= steps


def test_fleet_step_spans_syncs_and_identical_outputs(seqs):
    spec = spec_from_yaml(load_yaml_file(PIPE, env={}), **SIZING)
    scans = _scans(spec, seqs, "cpu")
    outs_off, carry_off, _ = _run(spec, scans, "cpu")
    prof = Profiler(timeline=True)
    outs_on, carry_on, loop_tests = _run(spec, scans, "cpu", prof)
    _assert_identical(outs_off, outs_on)
    _assert_identical(carry_off, carry_on)
    records, counters = prof.take()
    _check_spans(records, counters, FRAMES, loop_tests)
    assert int(outs_on[1].iterations.min()) > 0  # frame 1 ran the ICP


def test_host_api_step_span_carries_the_layers(seqs):
    lo = LidarOdometry.from_yaml_file(PIPE, env={}, device="cpu", **SIZING)
    traj, scans = seqs[0]
    for k in range(2):
        xyz, times, rings, valid = scans[k]
        lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid], ring=rings[valid])
    for name in ("onLidar", "onLidar.step", "onLidar.step.filters", "onLidar.step.icp", "onLidar.step.map"):
        assert len(lo.profiler.times(name)) == 2, name
    assert lo.profiler.mean_hz("onLidar") > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel B3 and the device trace have no CPU mode)")
    return "cuda"


@pytest.mark.cuda
def test_card_fleet_step_syncs_waves_and_identical_outputs(dev, seqs):
    """On the card: the outputs and carries are bit-identical with the
    profiler on and off; ``host_syncs`` equals the synchronizing operations
    that ``torch.cuda.set_sync_debug_mode("warn")`` reports inside the step
    span; each B3 launch counts ceil(B / max active clusters) waves."""
    from mola_lidar_odometry_tpu_torch.ops import pallas_icp

    spec = spec_from_yaml(load_yaml_file(PIPE, env={}), **SIZING)
    scans = _scans(spec, seqs, dev)
    _run(spec, scans, dev)  # builds and loads the kernels
    outs_off, carry_off, _ = _run(spec, scans, dev)
    prof = Profiler(timeline=True)
    seen = []

    def show(message, *a, **kw):
        if "synchronizing" in str(message):
            seen.append(tuple(prof._stack))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            launches0 = pallas_icp.align_fused.launches
            outs_on, carry_on, loop_tests = _run(spec, scans, dev, prof)
            launches = pallas_icp.align_fused.launches - launches0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    _assert_identical(outs_off, outs_on)
    _assert_identical(carry_off, carry_on)
    records, counters = prof.take()
    _check_spans(records, counters, FRAMES, loop_tests)
    inside = [s for s in seen if s and s[0] == "step"]
    assert len(inside) == len(counters["host_syncs"]), seen
    assert all(s[:2] == ("step", "icp") for s in inside), inside
    waves = counters["b3.waves"]
    assert len(waves) == launches > 0
    assert set(waves) <= {math.ceil(B / n) for n in pallas_icp._clusters.values()}


@pytest.mark.cuda
def test_card_spans_contain_the_device_gap_they_cause(dev, tmp_path):
    """Between two kernels, a span around a 2 ms sleep and a span around the
    second kernel's launch, mapped onto the trace's clock, hold the device's
    gap between the kernels within 50 us at each end: the sleep's span
    starts within 50 us after the first kernel ends, and the second kernel
    starts inside the launch's span (or within 50 us after it closes).  The
    host issues that launch for ~150 us after a sleep, under the trace; the
    first of the six rounds, which pays the profiler's start, is not held."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 12, device=dev)
    (x * 2).sum()
    torch.cuda.synchronize()
    p = Profiler(timeline=True)
    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        for _ in range(6):
            torch.mul(x, 3.0)
            torch.cuda.synchronize()
            with p.enter("sleep"):
                time.sleep(0.002)
            with p.enter("launch"):
                torch.mul(x, 5.0)
            torch.cuda.synchronize()
    trace = _trace(tmp_path, tp)
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                     for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "kernel")
    assert len(kernels) == 12
    records = p.take()[0]
    sleeps = [(p.epoch_ns(t0), p.epoch_ns(t1)) for n, _, t0, t1 in records if n == "sleep"]
    launches = [(p.epoch_ns(t0), p.epoch_ns(t1)) for n, _, t0, t1 in records if n == "launch"]
    ends = []
    for i, ((s0, s1), (l0, l1)) in enumerate(zip(sleeps, launches)):
        gap0, gap1 = _trace_ns(trace, kernels[2 * i][1]), _trace_ns(trace, kernels[2 * i + 1][0])
        ends.append((s0 - gap0, gap1 - l0, gap1 - l1))
        assert s1 - s0 >= 2e6
    print("sleep span start - gap start, gap end - launch span start, gap end - launch span end (ns):", ends)
    assert all(0 <= a < 50e3 and b >= 0 and c < 50e3 for a, b, c in ends[1:]), ends
