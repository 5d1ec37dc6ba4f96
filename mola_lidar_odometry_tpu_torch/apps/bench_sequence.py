"""The bench's simulated sequence and its sizing, shared by the port's tools.

Port of ``bench.py:38-100``.  :func:`gen_scans` makes the bench's KITTI-like
sequence (the same world, trajectory, sensor model and seeds), and
:func:`resolve_sizing` sizes the bench configuration from it as the bench
does by default (the bench's ``MOLA_BENCH_HANDSIZED=1`` constants are not
ported: nothing of the port runs them).  ``apps/trace_step.py``, ``apps/profile_stages.py``,
``apps/cross_pipeline.py`` and ``chip_smoke.py`` share them, so that their
profiles and figures are those of one program.

The trajectory, the per-scan seeds (1000 + k) and the cross-pipeline
intensities are drawn in frame order, so the first ``n`` scans of a longer
sequence are the ``n`` scans of a shorter one.  Where the JAX script caches
the scans in a file beside itself, this module simulates them again, in
spawned worker processes (numpy only) for scans of the bench's size; each
scan comes from its own seed, so the result does not depend on how many.
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple

import numpy as np

N_SCANS = 30  # bench.py's MOLA_BENCH_SCANS default

PARALLEL_RAYS = 1 << 16  # scans of this many rays and more are simulated in worker processes
# the bench's sensor: HDL-64-like, 64 rings x 2048 azimuths, 10 Hz
SENSOR = dict(fov_up_deg=3.0, fov_down_deg=-24.0, spin_period=0.1, noise=0.01, max_range=80.0)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def bench_world():
    from mola_lidar_odometry_tpu_torch.utils import sim

    return sim.make_world(0, extent=60.0, n_boxes=100, n_plates=50)


def bench_trajectory(n: int, accel: float = 3.0):
    """The bench's trajectory (``bench.py:48``: seed 1, up to 8 m/s; the
    cross-pipeline script passes its ``--accel``, 3.0 by default, which is
    also the simulator's default)."""
    from mola_lidar_odometry_tpu_torch.utils import sim

    return sim.make_trajectory(n, dt=0.1, seed=1, speed=8.0, accel=accel)


def head(traj, n: int):
    """The first ``n`` frames of a trajectory (a trajectory of ``n`` frames
    is the first ``n`` of a longer one)."""
    import dataclasses

    return dataclasses.replace(traj, stamps=traj.stamps[:n], R=traj.R[:n], t=traj.t[:n], twists=traj.twists[:n])


def _scan(job):
    from mola_lidar_odometry_tpu_torch.utils import sim

    world, R, t, twist, k, n_rings, n_azimuth = job
    return sim.simulate_scan(world, R, t, twist, n_rings=n_rings, n_azimuth=n_azimuth, seed=1000 + k, **SENSOR)


def gen_scans(n: int = N_SCANS, *, accel: float = 3.0, n_rings: int = 64, n_azimuth: int = 2048,
              workers: int = None) -> Tuple[List[tuple], object]:
    """The first ``n`` scans of the bench's sequence (``bench.py:47-57``):
    ``(scans, trajectory)``, each scan ``(xyz, times, rings, valid)`` of
    ``n_rings * n_azimuth`` rays (the bench's 64 x 2048 by default; the
    tests pass fewer).  ``workers`` defaults to one process per CPU core
    for scans of the bench's size (several seconds each) and to this
    process for smaller ones."""
    traj = bench_trajectory(n, accel)
    world = bench_world()
    jobs = [(world, traj.R[k], traj.t[k], traj.twists[k], k, n_rings, n_azimuth) for k in range(n)]
    if workers is None:
        workers = (os.cpu_count() or 1) if n_rings * n_azimuth >= PARALLEL_RAYS else 1
    if workers > 1 and n > 1:
        import concurrent.futures
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")  # no copy of a CUDA context in the children
        with concurrent.futures.ProcessPoolExecutor(min(workers, n), mp_context=ctx) as pool:
            scans = list(pool.map(_scan, jobs))
    else:
        scans = [_scan(j) for j in jobs]
    return scans, traj


def scan_intensities(scans) -> List[np.ndarray]:
    """The cross-pipeline script's intensities: uniform in [0, 100) from
    ``default_rng(0)``, one draw per ray, scan after scan."""
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 100, s[0].shape[0]).astype(np.float32) for s in scans]


def resolve_sizing(cfg, scans) -> dict:
    """Capacity sizing of the bench spec (``bench.py:69-100``'s default):
    derived from the first scan by ``utils/capacity.py`` with the largest
    scan of the sequence as the raw size (``known_max_points``).  Keyword
    arguments of ``spec_from_yaml``."""
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.utils.capacity import derive_capacities

    spec0 = spec_from_yaml(cfg)
    max_pts = max(int(v.sum()) for _, _, _, v in scans)
    x0, t0, _, v0 = scans[0]
    raw_cap, map_slots, caps, budgets = derive_capacities(spec0, x0[v0], t0[v0], with_budgets=True,
                                                          known_max_points=max_pts)
    log(f"sizing: auto (utils/capacity.py) raw={raw_cap} slots={map_slots} layers={caps} budgets={budgets}")
    return dict(raw_capacity=raw_cap, map_slots=map_slots, layer_capacities=caps, insert_budgets=budgets)
