"""The auxiliary observation handlers of the port's ``LidarOdometry``
(GNSS/IMU/wheel odometry, relocalize), its ICP debug logs, publisher
callbacks and fatal latch, mirroring the second half of
tests/test_runtime.py on mola_lidar_odometry_tpu_torch (``device="cpu"``)."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def tiny_lo():
    import os

    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry

    path = os.path.join(os.path.dirname(__file__), "..", "pipelines", "lidar3d-default.yaml")
    return LidarOdometry.from_yaml_file(
        path,
        device="cpu",
        raw_capacity=1 << 10,
        map_slots=1 << 12,
        layer_capacities={"raw": 1 << 10, "decimated_for_map_raw": 512,
                          "decimated_for_icp_skewed": 512, "decimated_for_icp": 512,
                          "decimated_for_map": 512},
    )


class TestAuxHandlers:
    def test_wheel_odometry_feeds_navstate(self, tiny_lo):
        lo = tiny_lo
        lo.reset()
        T0 = np.eye(4)
        lo.on_wheel_odometry(0.0, T0)
        T1 = np.eye(4)
        T1[:3, 3] = [0.5, 0.0, 0.0]
        lo.on_wheel_odometry(0.1, T1)
        T2 = np.eye(4)
        T2[:3, 3] = [1.0, 0.0, 0.0]
        lo.on_wheel_odometry(0.2, T2)
        # odometry is velocity evidence ONLY: the navstate window advanced
        # but the pose estimate did not move (reference feeds fuse_odometry,
        # never writes the pose — LidarOdometry.cpp:1357-1373)
        assert abs(float(lo.carry.pose_t[0, 0])) < 1e-6
        assert int(lo.carry.nav.head[0]) >= 2
        # ...and the fused window carries the odometric velocity
        import torch

        from mola_lidar_odometry_tpu_torch.models import navstate as ns

        est = ns.estimate(lo.carry.nav, lo.spec.navstate, torch.tensor([0.25]))
        assert bool(est.valid[0])
        assert abs(float(est.twist[0, 0]) - 5.0) < 1.0  # ~0.5 m / 0.1 s

    def test_relocalize_near_pose(self, tiny_lo):
        lo = tiny_lo
        lo.reset()
        R = np.eye(3)
        t = np.asarray([10.0, -3.0, 1.0])
        lo.relocalize_near_pose_pdf(R, t)
        np.testing.assert_allclose(lo.carry.pose_t[0].numpy(), t, atol=1e-6)

    def test_relocalize_from_gnss(self, tiny_lo):
        lo = tiny_lo
        lo.reset()
        assert not lo.relocalize_from_gnss()  # nothing buffered
        lo.on_gnss(1.0, {"enu": [5.0, 6.0, 0.0]})
        assert lo.relocalize_from_gnss()
        np.testing.assert_allclose(lo.carry.pose_t[0].numpy(), [5.0, 6.0, 0.0])

    def test_imu_buffered(self, tiny_lo):
        lo = tiny_lo
        lo.reset()
        lo.on_imu(0.0, {"wx": 0.1})
        assert len(lo._imu_buffer) == 1


def test_icp_debug_logs(tmp_path, monkeypatch, tiny_lo):
    """MP2P_ICP_GENERATE_DEBUG_FILES=1 produces .icplog.npz files."""
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu_torch.utils import sim

    monkeypatch.setenv("MP2P_ICP_GENERATE_DEBUG_FILES", "1")
    monkeypatch.setenv("MP2P_ICP_LOG_FILES_DECIMATION", "1")
    monkeypatch.chdir(tmp_path)
    lo = LidarOdometry(tiny_lo.spec, device="cpu")  # same spec, fresh instance
    assert lo._icp_log is not None
    traj, scans = sim.simulate_sequence(2, n_rings=8, n_azimuth=128)
    for k, (xyz, times, rings, valid) in enumerate(scans):
        lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid])
    logs = sorted((tmp_path / "icp-logs").glob("*.icplog.npz"))
    assert len(logs) == 2
    d = np.load(logs[1])
    assert d["poses_t"].shape[1] == 3 and d["paired"].shape[0] == 30
    # full per-iteration pairing details (saveIterationDetails analogue):
    # [lx ly lz tx ty tz d2 valid] per local point, every 3rd iteration
    det = d["pair_details"]
    assert det.shape[0] == 10 and det.shape[2] == 8
    assert list(d["detail_iters"][:3]) == [0, 3, 6]
    v = det[0, :, 7] > 0
    assert v.any()
    assert np.isfinite(det[0][v]).all()


def test_publisher_callbacks(tiny_lo):
    """advertiseUpdatedLocalization / advertiseUpdatedMap counterparts."""
    import numpy as np

    from mola_lidar_odometry_tpu_torch.utils import sim

    lo = tiny_lo
    lo.reset()
    loc_updates, map_updates = [], []
    lo.subscribe_localization_updates(loc_updates.append)
    lo.subscribe_map_updates(map_updates.append)
    lo.publish_map_updates_every_n = 1
    traj, scans = sim.simulate_sequence(3, n_rings=8, n_azimuth=128)
    for k, (xyz, times, rings, valid) in enumerate(scans):
        lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid])
    assert len(loc_updates) == 3
    assert "t" in loc_updates[0] and loc_updates[0]["t"].shape == (3,)
    assert len(map_updates) >= 1
    assert map_updates[0].ndim == 2 and map_updates[0].shape[1] == 3


def test_reset_clears_fatal_latch(tiny_lo):
    lo = tiny_lo
    lo.reset()
    lo._fatal_error = True
    assert lo.on_lidar_scan(np.zeros((10, 3), np.float32), 0.0) is None  # dead
    lo.reset()
    out = lo.on_lidar_scan(np.random.default_rng(0).uniform(-10, 10, (500, 3)).astype(np.float32), 0.0)
    assert out is not None and bool(out.processed)
