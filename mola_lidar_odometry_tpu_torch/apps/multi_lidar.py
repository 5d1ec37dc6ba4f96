"""Two LiDARs grouped into one frame by the async runtime.

lidar3d-default with ``MOLA_LIDAR_COUNT=2`` (``pipelines/lidar3d-default.yaml``
sets ``multiple_lidar_count`` from it) behind ``utils/runtime.py``'s
:class:`AsyncLidarOdometry`: each scan of a sequence is split by azimuth half
into two labelled sensors, the second stamped :data:`OFFSET` later with its
point times relative to its own stamp, and both are pushed as observations;
the runtime groups the two into one frame (reference
``LidarOdometry.cpp:664-689``).

:func:`feed` drives any odometry object and runtime module of this API, so
the same observations can go through another implementation of the runtime
for comparison; :func:`run` builds the port's.
"""

from __future__ import annotations

import os
import time

import numpy as np

LABELS = ("lidar_front", "lidar_rear")  # lidar3d-default's "lidar" label regex takes both
OFFSET = 0.005  # the second sensor stamps its half 5 ms after the first
PIPELINE = "lidar3d-default.yaml"


def split_by_azimuth(scan, n_azimuth: int = 2048):
    """A scan's valid rays as two sensors' halves: the azimuth columns below
    ``n_azimuth // 2`` and the rest (the simulator's scans are ring-major, a
    ray's column its index modulo ``n_azimuth``)."""
    xyz, times, _, valid = scan
    first = (np.arange(len(xyz)) % n_azimuth) < n_azimuth // 2
    return [(xyz[valid & half], times[valid & half]) for half in (first, ~first)]


def feed(lo, runtime, scans, traj, n_azimuth: int = 2048) -> dict:
    """Push ``scans`` as two sensors each into ``runtime.AsyncLidarOdometry(lo)``
    (``runtime`` a module holding it and ``Observation``) and wait for the
    worker.  Returns per-frame iterations, qualities, accepted flags and
    point counts, the groups formed, the observations dropped, the final
    pose, its gauge-aligned GT error and each frame's seconds."""
    from mola_lidar_odometry_tpu_torch.apps.cross_pipeline import gt_error

    outs, secs, step = [], [], lo.on_lidar_scan

    def record(*a, **k):
        t0 = time.perf_counter()
        outs.append(step(*a, **k))
        secs.append(time.perf_counter() - t0)
        return outs[-1]

    lo.on_lidar_scan = record
    rt = runtime.AsyncLidarOdometry(lo)
    try:
        for k, scan in enumerate(scans):
            for j, (label, (xyz, times)) in enumerate(zip(LABELS, split_by_azimuth(scan, n_azimuth))):
                off = j * OFFSET
                rt.on_new_observation(runtime.Observation("lidar", label, float(traj.stamps[k]) + off,
                                                          {"xyz": xyz, "times": (times - np.float32(off)).astype(np.float32)}))
        rt.worker.wait_all()
    finally:
        rt.shutdown()
    if rt.fatal_error:
        raise RuntimeError(f"multi-LiDAR: the runtime latched a fatal error: {rt._fatal_exception!r}")
    if not outs:
        raise RuntimeError("multi-LiDAR: the runtime formed no group")
    last = outs[-1]
    R, t = np.asarray(last.pose_R, np.float64), np.asarray(last.pose_t, np.float64)
    return dict(groups=len(outs), dropped=rt.dropped_observations,
                iterations=[int(o.iterations) for o in outs], quality=[float(o.quality) for o in outs],
                accepted=[bool(o.accepted) for o in outs], points=[int(o.n_raw) for o in outs],
                final_pose=np.concatenate([R.ravel(), t]).tolist(),
                final_pose_gt_error=gt_error(traj, len(outs) - 1, last.pose_R, last.pose_t), secs=secs)


def run(device, scans, traj, sizing: dict, n_azimuth: int = 2048) -> dict:
    """:func:`feed` through the port's ``LidarOdometry`` on ``device`` at
    ``sizing`` (``LidarOdometry`` keyword arguments) and its runtime."""
    from mola_lidar_odometry_tpu_torch.apps.cross_pipeline import ROOT
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu_torch.utils import runtime

    lo = LidarOdometry.from_yaml_file(os.path.join(ROOT, PIPELINE), env={"MOLA_LIDAR_COUNT": "2"}, device=device,
                                      **sizing)
    if lo.spec.multiple_lidar_count != 2:
        raise RuntimeError(f"multi-LiDAR: lidar_count {lo.spec.multiple_lidar_count} with MOLA_LIDAR_COUNT=2")
    try:
        return feed(lo, runtime, scans, traj, n_azimuth)
    finally:
        lo.close()
