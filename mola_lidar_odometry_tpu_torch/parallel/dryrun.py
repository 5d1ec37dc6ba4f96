"""A tracking sequence over a ``(fleet, point)`` mesh: the port's counterpart
of ``__graft_entry__.py::dryrun_multichip``.

N cells form a mesh of point axis 2 when N is even and at least 4, else 1
(as the JAX function picks it), one :class:`batch.PointShardedFleet` cell
per device.  Every instance tracks six scans of the simulated 16 x 256
sequence at the JAX function's sizes (raw capacity 4096, 8192 map slots):
every frame must be accepted and the worst gauge-aligned SE(3) log-norm
error against ground truth must stay below 0.35.  Then the lidar3d-ndt leg
under the same mesh, then the leg on the kernels: lidar3d-default (B1-B3 on
the fused path) and lidar3d-dual-map (B4 on the generic loop) run the CUDA
kernels on a card by default, and every kernel must have launched in the
cells (on the CPU the kernels' plain twins run and nothing is counted).
Prints one summary line, as the JAX function does.

    python -m mola_lidar_odometry_tpu_torch.parallel.dryrun 4 --device cpu
    python -m mola_lidar_odometry_tpu_torch.parallel.dryrun 4          # four cards, nccl
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
SIZING = dict(
    raw_capacity=4096, map_slots=1 << 13, kf_ring_capacity=64,
    layer_capacities={"raw": 4096, "decimated_for_map_raw": 2048, "decimated_for_icp_skewed": 1024,
                      "decimated_for_icp": 1024, "decimated_for_map": 2048},
)
N_STEPS = 6
MAX_GAUGE_ERROR = 0.35
ANSWER_S = 180.0  # a cell that does not answer a step in this time ends the run


def point_axis_for(n_devices: int) -> int:
    return 2 if n_devices % 2 == 0 and n_devices >= 4 else 1


def track(pipeline: str, mesh, traj, scans, threads: int = 0):
    """Step a :class:`PointShardedFleet` of ``pipeline`` through ``scans``;
    returns (worst gauge error, the fleet's last collectives per cell, its
    kernel launches summed over the cells, seconds per step)."""
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.oracle import relative, se3_log
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    spec = spec_from_yaml(load_yaml_file(os.path.join(ROOT, "pipelines", pipeline), env={}), **SIZING)
    R0, t0 = traj.R[0], traj.t[0]
    worst, secs = 0.0, []
    with pb.PointShardedFleet(spec, mesh, threads=threads, answer_s=ANSWER_S) as fleet:
        b = fleet.batch
        for k, scan in enumerate(scans):
            t1 = time.perf_counter()
            out = fleet.step([scan] * b, [float(traj.stamps[k])] * b)
            secs.append(time.perf_counter() - t1)
            if not out.accepted.all():
                raise AssertionError(f"{pipeline}: step {k} rejected")
            R_gt, t_gt = R0.T @ traj.R[k], R0.T @ (traj.t[k] - t0)
            for i in range(b):
                Rr, tr = relative(R_gt, t_gt, out.pose_R[i].astype(np.float64), out.pose_t[i].astype(np.float64))
                worst = max(worst, float(np.linalg.norm(se3_log(Rr, tr))))
        launches = collections.Counter()
        for cell in fleet.launches:
            launches.update(cell)
        return worst, fleet.collectives, dict(launches), secs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils import sim

    point = point_axis_for(args.n_devices)
    mesh = pb.make_mesh(args.n_devices, point_axis=point, device=args.device)
    threads = 1 if args.device == "cpu" else 0
    traj, scans = sim.simulate_sequence(N_STEPS, n_rings=16, n_azimuth=256, speed=2.0, noise=0.01, max_range=40.0)

    worst, colls, launches, secs = track("lidar3d-default.yaml", mesh, traj, scans, threads)
    if not worst < MAX_GAUGE_ERROR:
        raise AssertionError(f"sharded-sequence tracking error {worst:.3f}")
    worst_ndt, _, _, _ = track("lidar3d-ndt.yaml", mesh, traj, scans, threads)
    if not worst_ndt < MAX_GAUGE_ERROR:
        raise AssertionError(f"NDT sharded-sequence tracking error {worst_ndt:.3f}")
    worst_dual, _, dual_launches, _ = track(os.path.join("extras", "lidar3d-dual-map.yaml"), mesh, traj, scans,
                                            threads)
    launches = collections.Counter(launches)
    launches.update(dual_launches)
    if args.device == "cuda":
        never = [k for k, v in launches.items() if v <= 0]
        if never:
            raise AssertionError(f"kernels never launched in the cells: {never}")
    kernel_leg = f"ok(dual-map worst {worst_dual:.3f}, launches {dict(launches)})"
    per_step = {k: list(v) for k, v in colls[0].items()}
    print(
        f"dryrun_multichip OK: mesh={{'fleet': {len(mesh)}, 'point': {point}}} steps={N_STEPS} "
        f"worst-gauge-err={worst:.3f} ndt-gauge-err={worst_ndt:.3f} kernel-leg={kernel_leg} "
        f"collectives-per-step(cell 0)={per_step} s-per-step={np.median(secs[1:]):.4f} device={args.device}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
