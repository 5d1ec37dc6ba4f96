"""The port's module runtime (worker pool, dispatch, backpressure),
mirroring the first half of tests/test_runtime.py case for case on
mola_lidar_odometry_tpu_torch; the auxiliary handlers and the ICP debug
logs of a real ``LidarOdometry`` are in ``test_torch_runtime_host.py``."""

import threading
import time

import numpy as np

from mola_lidar_odometry_tpu_torch.utils.runtime import (
    AsyncLidarOdometry,
    Observation,
    WorkerThreadsPool,
)


class FakeSpec:
    lidar_sensor_labels = ("lidar", "/ouster/points")
    imu_sensor_label = "imu"
    gnss_sensor_label = "gps"
    wheel_odometry_sensor_label = "odometry"
    multiple_lidar_count = 1
    multiple_lidar_max_time_offset = 0.1


class FakeLO:
    def __init__(self):
        self.spec = FakeSpec()
        self.active = True
        self.calls = []

    def on_lidar_scan(self, xyz, stamp, times=None, intensity=None, ring=None):
        self.calls.append(("lidar", stamp, len(xyz)))

    def on_gnss(self, stamp, data):
        self.calls.append(("gnss", stamp))

    def on_imu(self, stamp, data):
        self.calls.append(("imu", stamp))

    def on_wheel_odometry(self, stamp, pose):
        self.calls.append(("odom", stamp))


class TestWorkerPool:
    def test_fifo_ordering(self):
        pool = WorkerThreadsPool(1)
        out = []
        for i in range(20):
            pool.enqueue(lambda i=i: out.append(i))
        pool.wait_all()
        assert out == list(range(20))
        pool.shutdown()

    def test_is_busy(self):
        pool = WorkerThreadsPool(1)
        pool.enqueue(lambda: time.sleep(0.15))
        time.sleep(0.03)
        assert pool.is_busy()
        pool.wait_all()
        assert not pool.is_busy()
        pool.shutdown()


class TestDispatch:
    def test_label_routing(self):
        lo = FakeLO()
        rt = AsyncLidarOdometry(lo)
        xyz = np.zeros((10, 3), np.float32)
        rt.on_new_observation(Observation("lidar", "lidar", 0.0, {"xyz": xyz}))
        rt.on_new_observation(Observation("lidar", "/ouster/points", 0.1, {"xyz": xyz}))
        rt.on_new_observation(Observation("gnss", "gps", 0.2, {}))
        rt.on_new_observation(Observation("imu", "imu", 0.3, {}))
        rt.on_new_observation(Observation("odometry", "odometry", 0.4, {"pose": None}))
        rt.on_new_observation(Observation("lidar", "unknown_sensor", 0.5, {"xyz": xyz}))
        rt.worker.wait_all()
        kinds = [c[0] for c in lo.calls]
        assert kinds == ["lidar", "lidar", "gnss", "imu", "odom"]
        rt.shutdown()

    def test_fatal_error_latch(self):
        lo = FakeLO()

        def boom(*a, **kw):
            raise RuntimeError("sensor exploded")

        lo.on_gnss = boom
        rt = AsyncLidarOdometry(lo)
        rt.on_new_observation(Observation("gnss", "gps", 0.0, {}))
        time.sleep(0.2)
        assert rt.fatal_error
        # further observations are discarded silently
        rt.on_new_observation(
            Observation("lidar", "lidar", 1.0, {"xyz": np.zeros((5, 3))})
        )
        time.sleep(0.1)
        assert lo.calls == []

    def test_worker_survives_handler_exception(self):
        # A raising handler latches fatal but must NOT kill the sole worker
        # thread: queued tasks drain and wait_all()/shutdown() terminate
        # (ADVICE round 1 — reference keeps its pool alive,
        # LidarOdometry.cpp:614-619).
        lo = FakeLO()

        def boom(*a, **kw):
            raise RuntimeError("sensor exploded")

        lo.on_gnss = boom
        rt = AsyncLidarOdometry(lo)
        # enqueue the bomb AND more work behind it in one burst
        rt.on_new_observation(Observation("gnss", "gps", 0.0, {}))
        rt.worker.enqueue(lambda: lo.calls.append(("after",)))
        done = threading.Event()

        def waiter():
            rt.worker.wait_all()
            done.set()

        threading.Thread(target=waiter, daemon=True).start()
        assert done.wait(timeout=5.0), "wait_all() deadlocked after exception"
        assert rt.fatal_error
        assert ("after",) in lo.calls  # queued task still executed
        assert not rt.worker.is_busy()
        rt.shutdown()  # terminates because the worker thread is alive

    def test_enqueue_request_runs_before_next_scan(self):
        lo = FakeLO()
        rt = AsyncLidarOdometry(lo)
        hits = []
        rt.enqueue_request(lambda: hits.append("req"))
        rt.on_new_observation(
            Observation("lidar", "lidar", 0.0, {"xyz": np.zeros((5, 3))})
        )
        rt.worker.wait_all()
        assert hits == ["req"] and lo.calls
        rt.shutdown()

    def test_multi_lidar_grouping(self):
        lo = FakeLO()
        lo.spec.multiple_lidar_count = 2
        rt = AsyncLidarOdometry(lo)
        xyz = np.zeros((10, 3), np.float32)
        rt.on_new_observation(Observation("lidar", "lidar", 0.00, {"xyz": xyz}))
        rt.worker.wait_all()
        assert lo.calls == []  # waiting for the second sensor
        rt.on_new_observation(Observation("lidar", "/ouster/points", 0.02, {"xyz": xyz}))
        rt.worker.wait_all()
        assert len(lo.calls) == 1
        assert lo.calls[0][2] == 20  # merged point count
        rt.shutdown()


def test_queue_overflow_drop():
    """Observations past max_worker_thread_queue_before_drop are dropped."""
    lo = FakeLO()
    lo.spec.max_worker_thread_queue_before_drop = 3

    import threading
    gate = threading.Event()
    slow_calls = []

    def slow(xyz, stamp, **kw):
        gate.wait(2.0)
        slow_calls.append(stamp)

    lo.on_lidar_scan = slow
    rt = AsyncLidarOdometry(lo)
    xyz = np.zeros((5, 3), np.float32)
    for k in range(10):
        rt.on_new_observation(Observation("lidar", "lidar", float(k), {"xyz": xyz}))
    assert rt.dropped_observations > 0
    gate.set()
    rt.worker.wait_all()
    assert len(slow_calls) < 10
    rt.shutdown()
