"""The benchmark's arithmetic on the CPU: the per-layer readers on a small
trace, the kernels' work against ``chip_smoke.py``'s bound functions at its
phase 3 shapes, and the ATE against ``gt_error_f64``."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from port_bench import run  # noqa: E402
from port_bench.gen import world  # noqa: E402
from port_bench.harness import accuracy, readings, work  # noqa: E402
from port_bench.harness.program import COLUMNS, FIELDS, Window  # noqa: E402

PORT = "mola_lidar_odometry_tpu_torch/"


def small_trace():
    """Two steps; each: a filter op (10 us), B3 (30 us), a map op (20 us),
    launched by their modules, with idle gaps of 5, 15 and 50 us."""
    evs, corr = [], [0]

    def launch(t, dur, kernel, frame, op):
        corr[0] += 1
        c = corr[0]
        evs.append(dict(ph="X", cat="python_function", name=PORT + frame, pid=1, tid=100, ts=t - 3, dur=4))
        if op:
            evs.append(dict(ph="X", cat="cpu_op", name=op, pid=1, tid=100, ts=t - 2, dur=2))
        evs.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", pid=1, tid=100, ts=t - 1, dur=1,
                        args=dict(correlation=c)))
        evs.append(dict(ph="X", cat="kernel", name=kernel, pid=0, tid=7, ts=t, dur=dur, args=dict(correlation=c)))

    t = 100.0
    for _ in range(2):
        launch(t, 10, "sort_kernel", "ops/filters.py(59): decimate_voxels", "aten::sort")
        launch(t + 15, 30, "void align_kernel<1>(float const*)", "ops/pallas_icp.py(401): align_fused", "")
        launch(t + 60, 20, "scan_kernel", "ops/voxel_hash.py(300): insert_stats", "aten::cumsum")
        t += 130
    return dict(traceEvents=evs)


class FakeRecorder:
    complete = True
    calls = [("align", 8, 3072, 16, 3072, 300, 2, torch.tensor([10] * 8))]

    def bound_ms_by_kind(self):
        return work.Recorder.bound_ms_by_kind(self)


def test_per_layer_readers_on_a_small_trace():
    rows = np.zeros((4, 2, sum(w for _, w in FIELDS)), np.float32)
    rows[..., COLUMNS["iterations"]] = 6.0
    rows[:2, 0, COLUMNS["kf_local"]] = 1.0
    w = Window(seconds=1.0, steps=4, issue_s=0.02, peak_bytes=3_500_000_000)
    r = readings.Readings(w, rows)
    r.traced = readings.traced(small_trace(), 2, 300e-6, FakeRecorder())
    r.timeline = readings.timeline(small_trace(), 2, 250e-6, 240e-6)
    read = {name: run.reader(name)(r) for name in (
        "step.issue_ms", "step.device_ops", "filters.device_ms", "icp.device_ms", "map.device_ms", "icp.iterations",
        "map.insert_pct", "kernels.roofline_pct", "device.idle_pct", "device.peak_gb")}
    assert read["step.issue_ms"] == pytest.approx(5.0)
    assert read["step.device_ops"] == 3
    assert read["filters.device_ms"] == pytest.approx(0.010)
    assert read["icp.device_ms"] == pytest.approx(0.030)
    assert read["map.device_ms"] == pytest.approx(0.020)
    assert read["icp.iterations"] == pytest.approx(6.0)
    assert read["map.insert_pct"] == pytest.approx(25.0)
    bound = work.bound_ms(*work.align_work(8, 3072, 16, 3072, 300, 80, 2))[0]
    assert read["kernels.roofline_pct"] == pytest.approx(100 * bound / 0.060)
    assert read["device.idle_pct"] == pytest.approx(100 * (1 - 120 / 240))  # against the untraced steps' time
    assert read["device.peak_gb"] == pytest.approx(3.5)
    b = readings.breakdown(r.timeline, r.traced)
    assert b["device_ops"][0] == ["void align_kernel<1>(float const*)", pytest.approx(60e-6)]
    assert [n for n, _ in b["idle_gaps"]] == ["ops/filters.py(59): decimate_voxels aten::sort",
                                             "ops/voxel_hash.py(300): insert_stats aten::cumsum",
                                             "ops/pallas_icp.py(401): align_fused"]
    assert b["idle_gaps"][0][1] == pytest.approx(50e-6)


def test_a_reader_without_a_trace_reads_nothing():
    r = readings.Readings(Window(seconds=1.0, steps=1), np.zeros((1, 1, 18), np.float32))
    for name in ("step.device_ops", "filters.device_ms", "kernels.roofline_pct", "device.idle_pct"):
        assert run.reader(name)(r) is None


def test_kernel_work_equals_chip_smoke_bounds_at_phase_3_shapes():
    """B3 and B4 as ``chip_smoke.b3_bound`` and phase 3's B4 bound count
    them; B2's bytes as ``capture_bounds`` counts them without map words;
    B1 at most ``capture_bounds``' (the map rows it fetches are left out)."""
    B, N, C, P, maxit = chip_smoke.BATCH, 3072, 16, 8, 300
    iters = torch.tensor([7, 9, 11, 13, 20, 3, 5, 8])
    planes = tuple(torch.zeros(B, C, N) for _ in range(4))
    args = (planes, torch.zeros(B, N, 3)) + (None,) * 6 + (torch.zeros(B, maxit),)
    assert work.bound_ms(*work.align_work(B, N, C, N, maxit, int(iters.sum()), 2)) == chip_smoke.b3_bound(args, iters, 2)
    for C4 in (20, 160, 540):
        assert work.bound_ms(*work.select_work(B, N, C4)) == chip_smoke.bound(B * N * (16 * C4 + 12 + 16),
                                                                             B * N * C4 * 9)
    vs = torch.full((B,), 1.0)
    m = SimpleNamespace(voxel_size=vs, data=torch.zeros(B, 1 << 16, 4))
    q0 = torch.rand(B, N, 3) * 50
    b1, b2 = chip_smoke.capture_bounds(m, q0, torch.ones(B, N, dtype=torch.bool), P, 0, 0)
    assert work.bound_ms(*work.capture_work(B, N, P, N, True))[0] == pytest.approx(b2[0], rel=1e-12)
    assert work.bound_ms(*work.capture_work(B, N, P, N, False))[0] < b1[0]


def test_ate_equals_gt_error_f64_on_a_known_trajectory():
    """Estimates off the ground truth by known translations (rotations
    exact): the ATE is the RMS of ``gt_error_f64`` over the frames."""
    from mola_lidar_odometry_tpu_torch.apps.cross_pipeline import gt_error_f64

    rng = np.random.default_rng(3)
    trajs = []
    for i in range(2):
        tr = world.make_trajectory(np.random.default_rng([5, i]), 20, 0.1, 8.0, 0.25, 3.0)
        c, s = np.cos(0.7 * i), np.sin(0.7 * i)
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        trajs.append(world.Trajectory(tr.stamps, Rz @ tr.R, tr.t @ Rz.T + [3.0 * i, -2.0, 0], tr.twists))
    rows = np.zeros((20, 2, sum(w for _, w in FIELDS)), np.float32)
    errs = []
    for i, tr in enumerate(trajs):
        for k in range(20):
            gR = tr.R[0].T @ tr.R[k]
            gt = tr.R[0].T @ (tr.t[k] - tr.t[0])
            off = rng.normal(0, 0.2, 3) if k else np.zeros(3)
            rows[k, i, COLUMNS["R"]] = gR.reshape(-1)
            rows[k, i, COLUMNS["t"]] = gt + off
            class T:  # noqa: N801 - gt_error_f64 reads R and t of a trajectory
                R, t = tr.R, tr.t
            errs.append(gt_error_f64(T, k, rows[k, i, COLUMNS["R"]].reshape(3, 3), rows[k, i, COLUMNS["t"]]))
    assert accuracy.ate_rmse(rows[None], trajs) == pytest.approx(float(np.sqrt(np.mean(np.square(errs)))), rel=2e-5)
