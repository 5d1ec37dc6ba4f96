"""Port parity of the lidar2d family (the 2D laser pipeline: an occupancy
local map with ray-traced free space, two pairings per point against its
coarse match index, SE(2)-pinned ICP with twist corrections), stepped
through the JAX package's ``LidarOdometry`` and the port's over the scans of
the JAX package's ``test_lidar2d_family_parity`` (a 720-beam horizontal
scan, 30 m range, 0.1 s spin, world seed 3, planar motion at 1.5 m/s),
with the gate of ``test_torch_family_ndt.step_both``: flags, layer counts,
drops and corrections equal, poses within 1e-5 m / 1e-5 rad, equal
occupied voxels.  The occupancy map itself is held word for word at the
last frame.  ``chip_smoke.py::lidar2d_scans`` builds the same scans for
its lidar2d phases, and ``reference`` (``__main__``) prints the JAX
package's figures they are held to."""

import os

import numpy as np

from mola_lidar_odometry_tpu_torch.utils import sim
from test_torch_family_ndt import GENERIC, PIPELINES, step_both

# the explicit sizes of test_lidar2d_family_parity
CAPS = dict(
    raw_capacity=1 << 11, map_slots=1 << 16,
    layer_capacities={"raw": 1 << 11, "deskewed": 1 << 11, "decimated_pre": 1 << 11, "decimated": 1 << 11},
    kf_ring_capacity=128,
)
FRAMES = 6


def scans(n: int = FRAMES, speed: float = 1.5, yaw_rate: float = 0.25, seed: int = 4):
    """``(trajectory, scans)``: n 2D scans of the family test's world (the
    fast-turn regime of ``test_lidar2d_fastturn_envelope``: speed 3.0,
    yaw rate 1.2, seed 6)."""
    world = sim.make_world(3, extent=25.0, n_boxes=40, n_plates=30)
    traj = sim.make_trajectory(n, dt=0.1, seed=seed, speed=speed, yaw_rate=yaw_rate, z=0.3)
    return traj, [
        sim.simulate_scan(world, traj.R[k], traj.t[k], traj.twists[k], n_rings=1, n_azimuth=720, fov_up_deg=0.0,
                          fov_down_deg=0.0, spin_period=0.1, max_range=30.0, seed=50 + k)
        for k in range(n)
    ]


def test_lidar2d_family_matches_jax():
    _, _, jouts, touts, jlo, tlo = step_both("lidar2d.yaml", GENERIC, frames=FRAMES, sequence=scans(), **CAPS)
    assert tlo.spec.pin_se2 and tlo.spec.icp_with_vel.matchers[0].pairings_per_point == 2
    assert all(bool(o.accepted) for o in touts) and min(float(o.quality) for o in touts[1:]) > 0.6
    tm, jm = tlo.carry.maps["localmap"], jlo.carry.maps["localmap"]
    for f in ("keys", "used", "logodds"):
        np.testing.assert_array_equal(getattr(tm, f)[0].numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    np.testing.assert_array_equal(tm.match.data[0].numpy(), np.asarray(jm.match.data))

    # the sizes both packages derive from the first scan are equal (and lose
    # the map: they count no free-space voxel, ROADMAP C10)
    from mola_lidar_odometry_tpu.utils.capacity import derive_capacities as jderive
    from mola_lidar_odometry_tpu_torch.utils.capacity import derive_capacities as tderive

    xyz, times, _, valid = scans(1)[1][0]
    args = (xyz[valid], times[valid])
    assert tderive(tlo.spec, *args, with_budgets=True) == jderive(jlo.spec, *args, with_budgets=True)


def reference(n_scans: int = 12, regime: str = "family", sizing: str = "explicit") -> dict:
    """The JAX package's figures for ``chip_smoke.py``'s lidar2d phases: one
    instance of its fleet step on the CPU over ``scans(n_scans)`` (the
    ``regime``: "family", or "fastturn", the fast-turn regime), at the
    family test's explicit sizes or (``sizing="auto"``) the sizes its
    ``utils/capacity.py`` derives; per-frame quality, iterations and
    corrections, the mean quality and the final-pose GT error."""
    import jax
    import jax.numpy as jnp

    from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu.ops import se3
    from mola_lidar_odometry_tpu.parallel import batch as pb
    from mola_lidar_odometry_tpu.utils.capacity import derive_capacities
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file

    traj, seq = scans(n_scans, **(dict(speed=3.0, yaw_rate=1.2, seed=6) if regime == "fastturn" else {}))
    cfg = load_yaml_file(os.path.join(PIPELINES, "lidar2d.yaml"), env={})
    if sizing == "auto":
        x0, t0, _, v0 = seq[0]
        names = ("raw_capacity", "map_slots", "layer_capacities", "insert_budgets")
        caps = dict(zip(names, derive_capacities(spec_from_yaml(cfg), x0[v0], t0[v0], with_budgets=True,
                                                 known_max_points=max(int(v.sum()) for *_, v in seq))))
    else:
        caps = dict(CAPS)
    spec = spec_from_yaml(cfg, **caps)
    step = jax.jit(pb.make_fleet_step(spec))
    carry = pb.init_fleet_carry(spec, 1)
    rows = []
    for k, s in enumerate(seq):
        carry, out = step(carry, pb.pack_scans(spec, [s], [traj.stamps[k]]))
        rows.append(dict(quality=float(out.quality[0]), iterations=int(out.iterations[0]),
                         corrections=int(out.corrections[0]), accepted=bool(out.accepted[0]),
                         collision_drops=int(out.map_collision_drops[0]), n_map=int(out.n_map_layer[0])))

    def G(k):
        return se3.Pose(jnp.asarray(traj.R[k], jnp.float32), jnp.asarray(traj.t[k], jnp.float32))

    est = se3.Pose(carry.pose_R[0], carry.pose_t[0])
    gt = float(jnp.linalg.norm(se3.se3_log(se3.relative(se3.relative(G(0), G(n_scans - 1)), est))))
    return dict(regime=regime, sizing={k: v for k, v in caps.items()}, frames=rows,
                mean_quality=float(np.mean([r["quality"] for r in rows[1:]])), final_pose_gt_error=gt)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_family_lidar2d.py [n_scans] [regime] [sizing]
    import json
    import sys

    args = sys.argv[1:]
    print(json.dumps(reference(int(args[0]) if args else 12, *args[1:])), flush=True)
