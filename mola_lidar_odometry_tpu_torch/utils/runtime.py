"""Module runtime: worker queue, observation dispatch, backpressure.

Host-side counterpart of the reference's L5 module runtime as used by the
odometry (SURVEY.md §2.1/§2.4): a 1-thread FIFO worker pool
(``mrpt::WorkerThreadsPool``, reference LidarOdometry.h:546-549) consuming
observations pushed by the dataset/ROS thread through ``onNewObservation``
(LidarOdometry.cpp:503-603), with

  * regex sensor-label dispatch to onLidar / onIMU / onGPS / onWheelOdometry,
  * queue-overflow observation dropping past
    ``max_worker_thread_queue_before_drop`` (= 500, :580-586),
  * ``is_busy()`` backpressure for the offline CLI busy-wait
    (apps/mola-lidar-odometry-cli.cpp:519-521),
  * fatal-error latch: a worker exception discards all further input
    (:614-619),
  * ``enqueue_request`` marshalling of user/GUI mutations onto the worker
    thread (:2216-2245), drained before each scan,
  * multi-LiDAR grouping of ``lidar_count`` scans within
    ``max_time_offset`` into one synchronized frame (:664-689).

Copy of ``mola_lidar_odometry_tpu/utils/runtime.py`` on top of the port's
``LidarOdometry`` (``models/odometry.py``).  The step stays synchronous
inside the worker; this layer only reproduces the reference's threading and
backpressure contract so live (ROS-like) producers can push observations
without blocking on the card.
"""

from __future__ import annotations

import queue
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class WorkerThreadsPool:
    """N-thread FIFO task pool (N=1 gives strict ordering, like the ref)."""

    def __init__(self, num_threads: int = 1, name: str = "worker"):
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self.last_exception: Exception | None = None
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}", daemon=True)
            for i in range(num_threads)
        ]
        self._busy = 0
        self._lock = threading.Lock()
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            with self._lock:
                self._busy += 1
            try:
                # A raising task must NOT kill the worker: the loop keeps
                # consuming (and task_done-ing) queued tasks so
                # wait_all()/shutdown() always terminate — the reference
                # latches fatal_error but keeps its pool alive
                # (LidarOdometry.cpp:614-619).  The exception is recorded
                # for callers that care (AsyncLidarOdometry latches fatal).
                task()
            except Exception as e:  # noqa: BLE001
                self.last_exception = e
            finally:
                with self._lock:
                    self._busy -= 1
                self._q.task_done()

    def enqueue(self, fn: Callable[[], None]) -> None:
        self._q.put(fn)

    def pending_tasks(self) -> int:
        return self._q.qsize()

    def is_busy(self) -> bool:
        with self._lock:
            busy = self._busy > 0
        return busy or not self._q.empty()

    def wait_all(self) -> None:
        self._q.join()

    def shutdown(self) -> None:
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=5.0)


@dataclass
class Observation:
    """A raw observation pushed into the runtime."""

    kind: str  # "lidar" | "imu" | "gnss" | "odometry"
    label: str
    stamp: float
    data: Dict[str, Any] = field(default_factory=dict)


class AsyncLidarOdometry:
    """Asynchronous front end over a :class:`LidarOdometry` instance.

    Reproduces ``onNewObservation``'s contract: non-blocking push, strict
    scan ordering via the 1-thread pool, drop-on-overflow, fatal-error
    latch, and multi-LiDAR synchronization.
    """

    def __init__(self, odometry):
        self.lo = odometry
        spec = odometry.spec
        # queue-overflow drop threshold (reference LidarOdometry.h:141,
        # YAML param max_worker_thread_queue_before_drop)
        self.max_queue_before_drop = getattr(
            spec, "max_worker_thread_queue_before_drop", 500
        )
        self.worker = WorkerThreadsPool(1, "lidar_odometry")
        self._requests: List[Callable[[], None]] = []
        self._req_mtx = threading.Lock()
        self._fatal = False
        self._lidar_res = [re.compile(s) for s in spec.lidar_sensor_labels]
        self._imu_re = re.compile(spec.imu_sensor_label)
        self._gps_re = re.compile(spec.gnss_sensor_label)
        self._odom_re = re.compile(spec.wheel_odometry_sensor_label)
        self._dropped = 0
        # multi-LiDAR sync buffer (label -> latest pending frame)
        self._sync: Dict[str, Observation] = {}

    # -- dispatch (reference LidarOdometry.cpp:503-603) --------------------
    def on_new_observation(self, obs: Observation) -> None:
        if self._fatal or not self.lo.active:
            return
        if self.worker.pending_tasks() > self.max_queue_before_drop:
            self._dropped += 1
            return
        if any(r.match(obs.label) for r in self._lidar_res):
            self.worker.enqueue(lambda: self._guard(self._on_lidar, obs))
        elif self._gps_re.match(obs.label):
            self.worker.enqueue(lambda: self._guard(self._on_gnss, obs))
        elif self._odom_re.match(obs.label):
            self.worker.enqueue(lambda: self._guard(self._on_wheel_odometry, obs))
        elif self._imu_re.match(obs.label):
            self.worker.enqueue(lambda: self._guard(self._on_imu, obs))
        # unmatched labels are silently ignored, like the reference

    def _guard(self, fn, obs) -> None:
        try:
            fn(obs)
        except Exception as e:  # noqa: BLE001
            # reference: fatal_error latch discards future input (:614-619).
            # Do NOT re-raise: the sole worker thread must stay alive so
            # already-queued tasks drain and wait_all()/shutdown() terminate.
            self._fatal = True
            self._fatal_exception = e

    # -- handlers ----------------------------------------------------------
    def _on_lidar(self, obs: Observation) -> None:
        self._process_pending_requests()
        spec = self.lo.spec
        if spec.multiple_lidar_count > 1:
            # group lidar_count scans within max_time_offset (:664-689)
            self._sync[obs.label] = obs
            stamps = [o.stamp for o in self._sync.values()]
            if len(self._sync) < spec.multiple_lidar_count or (
                max(stamps) - min(stamps) > spec.multiple_lidar_max_time_offset
            ):
                # incomplete group: wait (oldest entries age out implicitly
                # when their label is overwritten by a newer scan)
                return
            group = sorted(self._sync.values(), key=lambda o: o.stamp)
            self._sync.clear()
            xyz = np.concatenate([o.data["xyz"] for o in group])
            times_list = []
            for o in group:
                tt = o.data.get("times")
                if tt is None:
                    tt = np.zeros(len(o.data["xyz"]), np.float32)
                # per-sensor time offset relative to the group's frame
                times_list.append(tt + np.float32(o.stamp - group[0].stamp))
            times = np.concatenate(times_list)
            self.lo.on_lidar_scan(xyz, group[0].stamp, times=times)
        else:
            self.lo.on_lidar_scan(
                obs.data["xyz"],
                obs.stamp,
                times=obs.data.get("times"),
                intensity=obs.data.get("intensity"),
                ring=obs.data.get("ring"),
            )

    def _on_gnss(self, obs: Observation) -> None:
        self.lo.on_gnss(obs.stamp, obs.data)

    def _on_wheel_odometry(self, obs: Observation) -> None:
        self.lo.on_wheel_odometry(obs.stamp, obs.data["pose"])

    def _on_imu(self, obs: Observation) -> None:
        self.lo.on_imu(obs.stamp, obs.data)

    # -- requests / lifecycle ---------------------------------------------
    def enqueue_request(self, fn: Callable[[], None]) -> None:
        """Queue a mutation to run on the odometry thread before the next
        scan (reference enqueue_request, :2216-2245)."""
        with self._req_mtx:
            self._requests.append(fn)

    def _process_pending_requests(self) -> None:
        with self._req_mtx:
            reqs, self._requests = self._requests, []
        for fn in reqs:
            fn()

    def spin_once(self) -> None:
        """Periodic tick: drain user requests even when no scans arrive
        (reference spinOnce, :484-493)."""
        self.worker.enqueue(self._process_pending_requests)

    def is_busy(self) -> bool:
        return self.worker.is_busy()

    @property
    def dropped_observations(self) -> int:
        return self._dropped

    @property
    def fatal_error(self) -> bool:
        return self._fatal

    def shutdown(self) -> None:
        self.worker.wait_all()
        self.worker.shutdown()
