"""Port parity of a whole pipeline family: lidar3d-ndt (the NDT local map,
point-to-plane matching beside a point-to-point fallback matcher, the
``min_distance_between_points`` sub-cell dedup), stepped through the JAX
package's ``LidarOdometry`` and the port's (``device="cpu"``) over 6 frames
of ``sim.simulate_sequence`` (seeded), with the capacities both derive
from the first scan.

Per frame the flags (processed, accepted, keyframe, simple-map, map
update, restart), the layer counts and the correction and drop counters
must be equal.  The strict gate (translations within 1e-5 m, rotations
within 1e-5, the norm of the log of the relative rotation, and equal live
voxels in every map layer) holds for the point-map families; lidar3d-ndt
holds looser bounds, for the reason given at ``NDT_TRANS_TOL``.  The JAX
package runs its generic loop with the XLA twin of its nearest-select
kernel (``MOLA_TPU_PALLAS=0 MOLA_TPU_PER_VOXEL_NN=1``), as the dual-map
parity tests do.

``step_both`` is shared by the other family files
(``test_torch_family_intensity.py``, ``test_torch_family_edges.py``,
``test_torch_family_kissicp_nearfar.py``)."""

import os

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry as TLO
from mola_lidar_odometry_tpu_torch.utils import sim

HERE = os.path.dirname(os.path.abspath(__file__))
PIPELINES = os.path.join(HERE, "..", "pipelines")
GENERIC = {"MOLA_TPU_PALLAS": "0", "MOLA_TPU_PER_VOXEL_NN": "1"}
FRAMES = 6
FLAGS = ("processed", "accepted", "kf_local", "kf_simplemap", "sm_insert", "map_restarted", "n_raw", "n_icp_layer",
         "n_map_layer", "corrections", "map_collision_drops", "map_full_drops", "deferred_drops")
TRANS_TOL = 1e-5  # m
ROT_TOL = 1e-5  # rad
# lidar3d-ndt only (ROADMAP C8): the NDT moments are equal bit for bit,
# but the plane normals come from a closed-form eigen solve in which XLA
# multiplies by its own approximate reciprocal square root (11% of values
# one ulp off the correctly rounded one) and rounds cos/arccos its own way
# (C4), so most normals differ in their last bits; the point-to-plane
# residuals then differ by ~1e-5 m after one frame, an ICP stops an
# iteration earlier or later (3 against 5 at frame 2 of this probe) and the
# poses part by millimetres.  Measured worst over the 6 frames: 1.01e-3 to
# 2.02e-3 m (with one or eight torch threads), 7.07e-5 to 7.67e-5 rad, equal
# live voxels (6.6e-4 of them before the moments were
# summed in JAX's order).
NDT_TRANS_TOL = 5e-3
NDT_ROT_TOL = 5e-4
NDT_VOXEL_TOL = 2e-3


def _rot_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """|log(Ra^T Rb)| in float64, accurate for tiny angles."""
    M = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    w = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2.0
    return float(np.arctan2(np.linalg.norm(w), (np.trace(M) - 1.0) / 2.0))


def _live_voxels(m) -> int:
    """Live slots of a map layer of either package."""
    n = m.n if hasattr(m, "max_eigen_ratio") else m.count  # an NDT map's voxels, a point map's
    n = n() if callable(n) else n
    return int(np.sum(np.asarray(n[0] if torch.is_tensor(n) else n) > 0))


def step_both(rel, knobs, frames=FRAMES, intensity=None, scan_kw=None, trans_tol=TRANS_TOL, rot_tol=ROT_TOL,
              voxel_tol=0, **caps):
    """Step both packages' ``LidarOdometry`` over the same frames; returns
    (worst translation difference, worst rotation difference, JAX outputs,
    port outputs, the two instances).  ``voxel_tol`` bounds the relative
    difference of a map layer's live voxels (0: equal)."""
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry as JLO

    path = os.path.join(PIPELINES, rel)
    mp = pytest.MonkeyPatch()
    for k, v in knobs.items():
        mp.setenv(k, v)  # read when the JAX spec is built and traced
    # the port's ops here are small: one thread each keeps the suite's
    # parallel workers from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        traj, scans = sim.simulate_sequence(frames, **dict(dict(speed=2.0, noise=0.01), **(scan_kw or {})))
        jlo, tlo = JLO.from_yaml_file(path, env={}, **caps), TLO.from_yaml_file(path, env={}, device="cpu", **caps)
        worst_t = worst_r = worst_v = 0.0
        jouts, touts = [], []
        for k, (xyz, times, rings, valid) in enumerate(scans):
            kw = dict(times=times[valid], ring=rings[valid])
            if intensity is not None:
                kw["intensity"] = intensity(traj, k, xyz[valid])
            jo = jlo.on_lidar_scan(xyz[valid], traj.stamps[k], **kw)
            to = tlo.on_lidar_scan(xyz[valid], traj.stamps[k], **kw)
            for f in FLAGS:
                np.testing.assert_array_equal(getattr(to, f), np.asarray(getattr(jo, f)), err_msg=f"{f} frame {k}")
            for name in jlo.carry.maps:
                nt, nj = _live_voxels(tlo.carry.maps[name]), _live_voxels(jlo.carry.maps[name])
                worst_v = max(worst_v, abs(nt - nj) / max(nj, 1))
                assert abs(nt - nj) <= voxel_tol * nj, (name, k, nt, nj)
            worst_t = max(worst_t, float(np.abs(to.pose_t - np.asarray(jo.pose_t)).max()))
            worst_r = max(worst_r, _rot_angle(np.asarray(jo.pose_R), to.pose_R))
            jouts.append(jo)
            touts.append(to)
        print(f"{rel}: worst translation difference {worst_t:.3g} m, rotation {worst_r:.3g} rad, live voxels "
              f"{worst_v:.3g} (relative) over {frames} frames")
        assert worst_t <= trans_tol and worst_r <= rot_tol, (worst_t, worst_r)
        return worst_t, worst_r, jouts, touts, jlo, tlo
    finally:
        torch.set_num_threads(threads)
        mp.undo()


def test_ndt_family_matches_jax(tmp_path):
    """Auto-sized from the first scan, as a user starts the pipeline; both
    packages derive the same sizes, the NDT map's slots included.  Then the
    NDT local map the JAX package saved loads into a new port instance at
    those sizes word for word and steps the last scan again from the JAX
    package's pose."""
    scan_kw = dict(n_rings=16, n_azimuth=512)
    _, _, jouts, touts, jlo, tlo = step_both("lidar3d-ndt.yaml", GENERIC, scan_kw=scan_kw,
                                             trans_tol=NDT_TRANS_TOL, rot_tol=NDT_ROT_TOL, voxel_tol=NDT_VOXEL_TOL)
    js, ts = jlo.spec, tlo.spec
    assert ts.raw_capacity == js.raw_capacity and ts.layer_capacities == js.layer_capacities
    assert [(d.name, d.map_class, d.num_slots) for d in ts.map_layers] == [
        (d.name, d.map_class, d.num_slots) for d in js.map_layers]
    assert ts.map_layers[0].map_class == "NDT" and ts.map_layers[0].min_distance_between_points == 0.2
    m = tlo.carry.maps["localmap"]
    assert int(m.plane_ok().sum()) > 100  # the point-to-plane matcher had planes to pair with
    assert all(bool(o.accepted) for o in touts) and min(float(o.quality) for o in touts[1:]) > 0.5

    jlo.save_local_map(tmp_path / "jax_ndt.mm")
    sizes = dict(raw_capacity=ts.raw_capacity, map_slots=ts.map_layers[0].num_slots,
                 layer_capacities=ts.layer_capacities)
    fresh = TLO.from_yaml_file(os.path.join(PIPELINES, "lidar3d-ndt.yaml"), env={}, device="cpu", **sizes)
    fresh.load_local_map(tmp_path / "jax_ndt.mm")
    np.testing.assert_array_equal(fresh.carry.maps["localmap"].data[0].numpy(),
                                  np.asarray(jlo.carry.maps["localmap"].data))
    fresh.relocalize_near_pose_pdf(np.asarray(jouts[-1].pose_R), np.asarray(jouts[-1].pose_t))
    traj, scans = sim.simulate_sequence(FRAMES, speed=2.0, noise=0.01, **scan_kw)
    xyz, times, rings, valid = scans[-1]
    out = fresh.on_lidar_scan(xyz[valid], traj.stamps[-1], times=times[valid], ring=rings[valid])
    assert bool(out.accepted) and float(out.quality) > 0.5

    # from the reload there is no motion prior (as after a relocalization),
    # where the JAX instance had one: 0.036 m from its pose in this probe
    assert float(np.abs(out.pose_t - np.asarray(jouts[-1].pose_t)).max()) < 0.1


def reference(n_scans: int = 8) -> dict:
    """The JAX package's figures for ``chip_smoke.py``'s phases 7 and 8 on
    the bench's first ``n_scans`` scans (64 x 2048 rays, ``bench.py``'s
    world, trajectory, sensor model and seeds): lidar3d-ndt sized by its
    ``utils/capacity.py``, lidar3d-intensity and lidar3d-edges at the
    phase's explicit sizes (``chip_smoke.EXTRAS``).  ONE instance of its
    fleet step runs over the scans on the CPU (the phases' eight instances
    all see these scans); per pipeline the sizing, per-frame figures, mean
    quality and final-pose GT error."""
    import json
    import resource
    import sys
    import time

    os.environ.update(GENERIC)
    import jax
    import jax.numpy as jnp

    from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu.ops import se3
    from mola_lidar_odometry_tpu.parallel import batch as pb
    from mola_lidar_odometry_tpu.utils import sim as jsim
    from mola_lidar_odometry_tpu.utils.capacity import derive_capacities
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file

    sys.path.insert(0, os.path.join(HERE, ".."))
    import chip_smoke

    t0 = time.time()
    world = jsim.make_world(0, extent=60.0, n_boxes=100, n_plates=50)
    traj = jsim.make_trajectory(n_scans, dt=0.1, seed=1, speed=8.0)
    scans = [
        jsim.simulate_scan(world, traj.R[k], traj.t[k], traj.twists[k], n_rings=64, n_azimuth=2048, fov_up_deg=3.0,
                           fov_down_deg=-24.0, spin_period=0.1, noise=0.01, max_range=80.0, seed=1000 + k)
        for k in range(n_scans)
    ]
    print(f"simulated {n_scans} scans in {time.time() - t0:.1f} s", flush=True)
    results = {}
    for tag, rel, sizing in [("ndt", "lidar3d-ndt.yaml", None)] + [(t, r, z) for t, r, _, z in chip_smoke.EXTRAS]:
        cfg = load_yaml_file(os.path.join(PIPELINES, rel), env={})
        if sizing is None:
            x0, t0_, _, v0 = scans[0]
            max_pts = max(int(v.sum()) for _, _, _, v in scans)
            names = ("raw_capacity", "map_slots", "layer_capacities", "insert_budgets")
            sizing = dict(zip(names, derive_capacities(spec_from_yaml(cfg), x0[v0], t0_[v0], with_budgets=True,
                                                       known_max_points=max_pts)))
        spec = spec_from_yaml(cfg, kf_ring_capacity=256, **sizing)
        step = jax.jit(pb.make_fleet_step(spec))
        carry = pb.init_fleet_carry(spec, 1)
        rows = []
        for k, (xyz, times, rings, valid) in enumerate(scans):
            t1 = time.time()
            packed = pb.pack_scans(spec, [(xyz, times, rings, valid)], [traj.stamps[k]])
            if tag == "intensity":
                inten = np.zeros((1, spec.raw_capacity), np.float32)
                inten[0, : len(xyz)] = sim.world_intensity(traj, k, xyz)
                packed = packed._replace(intensity=jnp.asarray(inten))
            carry, out = step(carry, packed)
            rows.append(dict(frame=k, quality=float(out.quality[0]), iterations=int(out.iterations[0]),
                             corrections=int(out.corrections[0]), accepted=bool(out.accepted[0]),
                             n_icp=int(out.n_icp_layer[0]), n_map=int(out.n_map_layer[0]),
                             collision_drops=int(out.map_collision_drops[0]), seconds=round(time.time() - t1, 2)))
            print(tag, rows[-1], flush=True)

        def G(k):
            return se3.Pose(jnp.asarray(traj.R[k], jnp.float32), jnp.asarray(traj.t[k], jnp.float32))

        est = se3.Pose(carry.pose_R[0], carry.pose_t[0])
        gt_err = float(jnp.linalg.norm(se3.se3_log(se3.relative(se3.relative(G(0), G(n_scans - 1)), est))))
        results[tag] = dict(sizing=sizing, frames=rows, mean_quality=float(np.mean([r["quality"] for r in rows[1:]])),
                            final_pose_gt_error=gt_err)
    return dict(results, backend=jax.default_backend(),
                peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_family_ndt.py [n_scans]
    import json
    import sys

    print(json.dumps(reference(int(sys.argv[1]) if len(sys.argv) > 1 else 8)), flush=True)
