"""The port's accuracy table (``apps/cross_pipeline.py``) against the JAX repo's.

The sequence is the port's copy of ``eval/cross_pipeline.py``'s generator
(``apps/bench_sequence.py``), cut to 3 frames of 16 rings x 512 azimuths: it
must equal the JAX script's own construction (the JAX package's simulator)
bit for bit.  lidar3d-default then runs over it through the port tool's
per-pipeline function and through the JAX package's ``LidarOdometry`` as the
JAX script drives it (its CPU algorithm, fed the same points, stamps, times,
rings and intensities), at the same small capacities: the per-frame
gauge-aligned errors and the worst error within 1e-4.  The tool's command
line prints the script's table.  Last the multi-LiDAR grouping of
``chip_smoke.py``'s phase 13 (d) (``apps/multi_lidar.py``) at this size on
the CPU: every group formed, no observation dropped, every frame accepted,
each group holding the scan's valid points; the same observations through
the JAX package's ``LidarOdometry`` and async runtime (its TPU algorithm, as
the port runs) give the same groups and iterations, the qualities within
1e-4 and the final pose within 1e-5.  And the fault that run found on the
card: kissicp-like handed kernel B3 a strided point array."""

import io
import os
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest

from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs, cross_pipeline as cp, multi_lidar as ml

FRAMES, RINGS, AZIMUTH = 3, 16, 512
RAW = RINGS * AZIMUTH
ERR_TOL = 1e-4
QUALITY_TOL = 1e-4
FUSED = {"MOLA_TPU_PALLAS": "1", "MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_PALLAS_CAPTURE": "1"}
POSE_TOL = 1e-5  # the final pose's largest difference measured 7.5e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port steps on one torch thread (the tests run beside others)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    scans, traj = bs.gen_scans(FRAMES, n_rings=RINGS, n_azimuth=AZIMUTH)
    return scans, traj, bs.scan_intensities(scans)


def test_sequence_is_the_jax_scripts(seq):
    """``eval/cross_pipeline.py:62-77`` at this size, with the JAX package's
    simulator; the first frames of a longer sequence are the frames of a
    shorter one; simulating in worker processes changes nothing."""
    from mola_lidar_odometry_tpu.utils import sim

    scans, traj, intens = seq
    world = sim.make_world(0, extent=60.0, n_boxes=100, n_plates=50)
    jtraj = sim.make_trajectory(FRAMES, dt=0.1, seed=1, speed=8.0, accel=3.0)
    for k in range(FRAMES):
        want = sim.simulate_scan(world, jtraj.R[k], jtraj.t[k], jtraj.twists[k], n_rings=RINGS, n_azimuth=AZIMUTH,
                                 fov_up_deg=3.0, fov_down_deg=-24.0, spin_period=0.1, noise=0.01, max_range=80.0,
                                 seed=1000 + k)
        for a, b in zip(scans[k], want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(traj.stamps, jtraj.stamps)
    rng = np.random.default_rng(0)
    for k in range(FRAMES):
        np.testing.assert_array_equal(intens[k], rng.uniform(0, 100, scans[k][0].shape[0]).astype(np.float32))
    longer, ltraj = bs.gen_scans(FRAMES + 1, n_rings=RINGS, n_azimuth=AZIMUTH, workers=2)
    head = bs.head(ltraj, FRAMES)
    for k in range(FRAMES):
        for a, b in zip(longer[k], scans[k]):
            np.testing.assert_array_equal(a, b)
    for f in ("stamps", "R", "t", "twists"):
        np.testing.assert_array_equal(getattr(head, f), getattr(traj, f))


def test_default_frames_match_jax(seq):
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu.ops import se3

    scans, traj, intens = seq
    caps = cp.caps_for(RAW)
    path = os.path.join(cp.ROOT, "lidar3d-default.yaml")
    lo = LidarOdometry.from_yaml_file(path, **caps)
    G0 = se3.Pose(jnp.asarray(traj.R[0], jnp.float32), jnp.asarray(traj.t[0], jnp.float32))
    want = []
    for k, (xyz, times, rings, valid) in enumerate(scans):
        out = lo.on_lidar_scan(xyz[valid], float(traj.stamps[k]), times=times[valid], ring=rings[valid],
                               intensity=intens[k][valid])
        Gk = se3.Pose(jnp.asarray(traj.R[k], jnp.float32), jnp.asarray(traj.t[k], jnp.float32))
        want.append(float(jnp.linalg.norm(se3.se3_log(se3.relative(se3.relative(G0, Gk),
                                                                   se3.Pose(out.pose_R, out.pose_t))))))
    got = cp.run_pipeline(path, scans, traj, intens, caps, "cpu")
    assert got["name"] == "lidar3d-default.yaml" and len(got["errors"]) == FRAMES
    np.testing.assert_allclose(got["errors"], want, atol=ERR_TOL, rtol=0)
    assert abs(got["worst"] - max(want)) <= ERR_TOL
    assert got["worst"] > 1e-3 and got["iterations"][0] == 0 and min(got["iterations"][1:]) > 0


def test_command_line_prints_the_table():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rows = cp.main(["--device", "cpu", "--frames", "1", "--rings", str(RINGS), "--azimuth", str(AZIMUTH),
                        "--pipelines", "lidar3d-default.yaml"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("lidar3d-default.yaml: worst=")
    assert lines[-3:-1] == ["| pipeline | worst error |", "|---|---|"]
    assert lines[-1] == f"| lidar3d-default.yaml | {rows[0]['worst']:.3f} |"


def test_multi_lidar_grouping_on_the_cpu(seq, monkeypatch):
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu.utils import runtime

    scans, traj, _ = seq
    r = ml.run("cpu", scans, traj, cp.caps_for(RAW), n_azimuth=AZIMUTH)
    halves = [ml.split_by_azimuth(s, AZIMUTH) for s in scans]
    assert r["groups"] == FRAMES and r["dropped"] == 0 and all(r["accepted"])
    assert r["points"] == [len(a[0]) + len(b[0]) for a, b in halves] == [int(s[3].sum()) for s in scans]
    assert all(len(a[0]) and len(b[0]) for a, b in halves)
    assert r["final_pose_gt_error"] < 0.05
    # the same observations through the JAX package's odometry and runtime,
    # running the algorithm the port runs (its TPU algorithm)
    for k, v in FUSED.items():
        monkeypatch.setenv(k, v)
    lo = LidarOdometry.from_yaml_file(os.path.join(cp.ROOT, ml.PIPELINE), env={"MOLA_LIDAR_COUNT": "2"},
                                      **cp.caps_for(RAW))
    want = ml.feed(lo, runtime, scans, traj, AZIMUTH)
    for key in ("groups", "dropped", "accepted", "points", "iterations"):
        assert r[key] == want[key], key
    np.testing.assert_allclose(r["quality"], want["quality"], atol=QUALITY_TOL, rtol=0)
    np.testing.assert_allclose(r["final_pose"], want["final_pose"], atol=POSE_TOL, rtol=0)
    assert abs(r["final_pose_gt_error"] - want["final_pose_gt_error"]) <= ERR_TOL


def test_kissicp_like_hands_b3_contiguous_points(seq, monkeypatch):
    """lidar3d-kissicp-like aligns its decimation's output directly, a
    strided view of the decimation's packed rows; kernel B3's launcher on
    the card refuses a non-contiguous point array (the accuracy table's
    first run on an H100 stopped there).  Every fused align must hand the
    kernel contiguous points and candidate planes, as the card needs."""
    from mola_lidar_odometry_tpu_torch.ops import pallas_icp

    scans, traj, intens = seq
    calls, real = [], pallas_icp.align_fused

    def check(planar, pts, *a, **k):
        calls.append(pts.is_contiguous() and all(p.is_contiguous() for p in planar))
        return real(planar, pts, *a, **k)

    monkeypatch.setattr(pallas_icp, "align_fused", check)
    r = cp.run_pipeline(os.path.join(cp.ROOT, "extras", "lidar3d-kissicp-like.yaml"), scans[:2], bs.head(traj, 2),
                        intens, cp.caps_for(RAW), "cpu")
    assert calls and all(calls), calls
    assert r["worst"] < 0.05


def test_error_metric_in_float64(seq):
    """``gt_error_f64`` against constructed poses: the gauge-aligned ground
    truth itself reads 0; a pure offset ``d`` in the frame-0 gauge reads
    ``|d|``; and at a relative rotation of 1.01 mrad (theta^2 just above the
    float32 series' 1e-6 threshold, ROADMAP C16) it reads the exact
    log-norm to 2e-4 (``V^-1 t`` differs from ``t`` by half of
    ``w x t``)."""
    from scipy.spatial.transform import Rotation

    _, traj, _ = seq
    R0, t0 = traj.R[0], traj.t[0]
    k = FRAMES - 1
    gR, gt = R0.T @ traj.R[k], R0.T @ (traj.t[k] - t0)
    assert cp.gt_error_f64(traj, k, gR, gt) < 1e-12
    d = np.array([0.3, -0.05, 0.02])
    assert abs(cp.gt_error_f64(traj, k, gR, gt + gR @ d) - np.linalg.norm(d)) < 1e-12
    w = np.array([6.6e-4, 3.9e-4, -6.6e-4])
    dR = Rotation.from_rotvec(w).as_matrix()
    want = np.linalg.norm(np.concatenate([d, w]))
    assert abs(cp.gt_error_f64(traj, k, gR @ dR, gt + gR @ d) - want) < 2e-4
