#!/usr/bin/env python3
"""Sizing and reference numbers for the port's dual-map smoke phase.

    JAX_PLATFORMS=cpu python eval/port_dualmap_reference.py [--scans 6] [--run]

Runs the JAX package (the reference), never the port.  Without ``--run`` it
sizes ``pipelines/extras/lidar3d-dual-map.yaml`` for the bench's simulated
KITTI-like sequence (``bench.py``'s world, trajectory, sensor model and
seeds) with ``utils/capacity.py`` (a host-side float64 dry pass over the
first scan) and prints the sizing that ``chip_smoke.py`` carries as
``DUALMAP_SIZING``.  With ``--run`` it also steps ONE instance of the JAX
package over the first scans on the CPU, with the per-voxel capture view
the port always uses (``MOLA_TPU_PER_VOXEL_NN=1``) and the XLA twin of the
``nn_select`` kernel (``MOLA_TPU_PALLAS=0``), and prints per-frame quality,
iterations and the final-pose GT error: the figures the smoke phase's guards
were set from.  One JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["MOLA_TPU_PER_VOXEL_NN"] = "1"
os.environ["MOLA_TPU_PALLAS"] = "0"

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
PIPE = os.path.join(HERE, "pipelines", "extras", "lidar3d-dual-map.yaml")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=6)
    ap.add_argument("--run", action="store_true")
    args = ap.parse_args()

    from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu.utils import sim
    from mola_lidar_odometry_tpu.utils.capacity import derive_capacities
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file

    t0 = time.time()
    world = sim.make_world(0, extent=60.0, n_boxes=100, n_plates=50)
    traj = sim.make_trajectory(args.scans, dt=0.1, seed=1, speed=8.0)
    scans = [
        sim.simulate_scan(
            world, traj.R[k], traj.t[k], traj.twists[k], n_rings=64, n_azimuth=2048, fov_up_deg=3.0,
            fov_down_deg=-24.0, spin_period=0.1, noise=0.01, max_range=80.0, seed=1000 + k,
        )
        for k in range(args.scans)
    ]
    print(f"simulated {args.scans} scans in {time.time() - t0:.1f} s", flush=True)

    cfg = load_yaml_file(PIPE, env={})
    max_pts = max(int(v.sum()) for _, _, _, v in scans)
    x0, t0_, _, v0 = scans[0]
    raw_cap, map_slots, caps, budgets = derive_capacities(
        spec_from_yaml(cfg), x0[v0], t0_[v0], with_budgets=True, known_max_points=max_pts
    )
    sizing = dict(raw_capacity=raw_cap, map_slots=map_slots, layer_capacities=caps, insert_budgets=budgets)
    print("sizing:", json.dumps(sizing), flush=True)
    result = dict(sizing=sizing, scans=args.scans)

    if args.run:
        import jax
        import jax.numpy as jnp

        from mola_lidar_odometry_tpu.ops import se3
        from mola_lidar_odometry_tpu.parallel import batch as pb

        spec = spec_from_yaml(cfg, kf_ring_capacity=256, **sizing)
        assert spec.icp_with_vel.per_voxel_nn and not spec.icp_with_vel.use_pallas
        step = jax.jit(pb.make_fleet_step(spec))
        carry = pb.init_fleet_carry(spec, 1)
        rows = []
        for k, s in enumerate(scans):
            t1 = time.time()
            carry, out = step(carry, pb.pack_scans(spec, [s], [traj.stamps[k]]))
            rows.append(dict(
                frame=k, quality=float(out.quality[0]), iterations=int(out.iterations[0]),
                corrections=int(out.corrections[0]), accepted=bool(out.accepted[0]),
                n_icp=int(out.n_icp_layer[0]), n_map=int(out.n_map_layer[0]),
                collision_drops=int(out.map_collision_drops[0]), deferred=int(out.deferred_drops[0]),
            ))
            print(rows[-1], f"{time.time() - t1:.1f} s", flush=True)

        def G(k):
            return se3.Pose(jnp.asarray(traj.R[k], jnp.float32), jnp.asarray(traj.t[k], jnp.float32))

        est = se3.Pose(carry.pose_R[0], carry.pose_t[0])
        gt_err = float(jnp.linalg.norm(se3.se3_log(se3.relative(se3.relative(G(0), G(args.scans - 1)), est))))
        result.update(frames=rows, mean_quality=float(np.mean([r["quality"] for r in rows[1:]])),
                      final_pose_gt_error=gt_err, backend=jax.default_backend())
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
