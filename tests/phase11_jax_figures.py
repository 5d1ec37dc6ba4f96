"""The JAX package's CPU figures for ``chip_smoke.py``'s phase 11.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/phase11_jax_figures.py [tag ...]
    PYTHONPATH=. python tests/phase11_jax_figures.py --port cpu|cuda tag ...   # the port's, beside them

On the bench's first 8 scans (64 x 2048 rays, ``bench.py``'s world,
trajectory, sensor model and seeds), ONE instance of the JAX package's fleet
step (the phase's eight instances all see these scans) for each
configuration of ``chip_smoke.COMPLETE`` at the sizes its
``utils/capacity.py`` derives from the first scan: per frame the quality,
iterations and flags, then the mean quality, the final-pose GT error and
the collision drops against the points offered to the map.
Each tag runs under its environment in ``ENVS``: the fused configurations
(``k64`` and the fused-dispatch tags of ``chip_smoke.COMPLETE_DISPATCH``)
the JAX package's TPU algorithm (its Pallas kernels in interpret mode),
with one of the fused path's switches set where the tag names one; the
others its generic loop with the XLA twin of the nearest-select kernel, as
the family tests do (``k200 dedup`` and ``per-voxel generic`` among them:
``MOLA_TPU_PALLAS=0``); the full-voxel tags
(``chip_smoke.COMPLETE_FULL_VOXEL``) at the JAX package's CPU defaults
(``MOLA_TPU_PALLAS=0 MOLA_TPU_PER_VOXEL_NN=0``: every point of each probed
voxel, the nearest selected in XLA).  Tags that run kernel B3 in interpret
mode take several minutes each.

Tag ``oracle``: the JAX package's ``LidarOdometry`` (auto-sized, the TPU
algorithm) beside its float64 oracle over the same scans, and the three
figures of ``tests/test_oracle_parity.py``: the worst per-pose SE(3)
log-norm between them, the engine-to-oracle ATE-RMSE as a share of the path
and the oracle's GT error per frame; with the oracle's seconds per scan.

Each tag runs in a process of its own (the knobs are read when a spec is
built and traced); with no tag, every tag runs, three at a time.  One JSON
line per tag.

``--port DEVICE``: the same figures from the port (no JAX imported), one
instance on ``DEVICE`` with the tag's ``chip_smoke.COMPLETE_KNOBS``, over
the same scans from ``apps/bench_sequence.py``: what phase 11's eight
instances read on the card, one instance on the CPU or the card.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
TPU_ALGO = {"MOLA_TPU_PALLAS": "1", "MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_PALLAS_CAPTURE": "1"}
GENERIC = {"MOLA_TPU_PALLAS": "0", "MOLA_TPU_PER_VOXEL_NN": "1"}
FULL_VOXEL = {"MOLA_TPU_PALLAS": "0", "MOLA_TPU_PER_VOXEL_NN": "0"}  # the JAX package's CPU defaults
ENVS = {  # tag -> the JAX package's environment (GENERIC for a tag not named)
    "k64": TPU_ALGO, "anderson": dict(GENERIC, MOLA_TPU_ICP_ANDERSON="3"),
    "full voxel": FULL_VOXEL, "full voxel dual-map": FULL_VOXEL,
    "k200 dedup fused": TPU_ALGO, "per-voxel generic": GENERIC,
    "capture off": dict(TPU_ALGO, MOLA_TPU_PALLAS_CAPTURE="0"),
    "phase1 4-probe": dict(TPU_ALGO, MOLA_TPU_PHASE1_NEIGHBORS="4"),
    "fresh refresh": dict(TPU_ALGO, MOLA_TPU_REFRESH_RESELECT="0"),
    "single phase": dict(TPU_ALGO, MOLA_TPU_FUSED_REFRESH="0"),
}
N_SCANS = 8


def _scans():
    from mola_lidar_odometry_tpu.utils import sim as jsim

    world = jsim.make_world(0, extent=60.0, n_boxes=100, n_plates=50)
    traj = jsim.make_trajectory(N_SCANS, dt=0.1, seed=1, speed=8.0)
    return traj, [
        jsim.simulate_scan(world, traj.R[k], traj.t[k], traj.twists[k], n_rings=64, n_azimuth=2048, fov_up_deg=3.0,
                           fov_down_deg=-24.0, spin_period=0.1, noise=0.01, max_range=80.0, seed=1000 + k)
        for k in range(N_SCANS)
    ]


def _gt_error(traj, k, R, t, port=False) -> float:
    """Pose ``k``'s gauge-aligned SE(3) log-norm error in float64, by the
    JAX package's oracle functions (the port's with ``port``)."""
    if port:
        from mola_lidar_odometry_tpu_torch.oracle import relative, se3_log
    else:
        from mola_lidar_odometry_tpu.oracle import relative, se3_log

    R0, t0 = traj.R[0], traj.t[0]
    Rr, tr = relative(R0.T @ traj.R[k], R0.T @ (traj.t[k] - t0), np.asarray(R, np.float64), np.asarray(t, np.float64))
    return float(np.linalg.norm(se3_log(Rr, tr)))


def run_config(tag: str) -> dict:
    import chip_smoke

    os.environ.update(ENVS.get(tag, GENERIC))
    import jax

    from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu.parallel import batch as pb
    from mola_lidar_odometry_tpu.utils.capacity import derive_capacities
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file

    traj, scans = _scans()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = chip_smoke.complete_cfg(tag, tmp, load_yaml_file)
    x0, t0, _, v0 = scans[0]
    names = ("raw_capacity", "map_slots", "layer_capacities", "insert_budgets")
    sizing = dict(zip(names, derive_capacities(spec_from_yaml(cfg), x0[v0], t0[v0], with_budgets=True,
                                               known_max_points=max(int(v.sum()) for *_, v in scans))))
    spec = spec_from_yaml(cfg, kf_ring_capacity=256, **sizing)
    step = jax.jit(pb.make_fleet_step(spec))
    carry = pb.init_fleet_carry(spec, 1)
    carry, rows = _step_all(tag, step, carry, lambda k, s: pb.pack_scans(spec, [s], [traj.stamps[k]]), scans)
    gt = _gt_error(traj, N_SCANS - 1, carry.pose_R[0], carry.pose_t[0])
    return _figures(dict(tag=tag, env=ENVS.get(tag, GENERIC)), sizing, spec, carry, rows, gt)


def _step_all(tag, step, carry, pack, scans):
    """Step ``carry`` over ``scans``; returns the last carry and each
    frame's figures."""
    rows = []
    for k, s in enumerate(scans):
        t1 = time.time()
        carry, out = step(carry, pack(k, s))
        rows.append(dict(frame=k, quality=float(out.quality[0]), iterations=int(out.iterations[0]),
                         corrections=int(out.corrections[0]), accepted=bool(out.accepted[0]),
                         collision_drops=int(out.map_collision_drops[0]), n_map=int(out.n_map_layer[0]),
                         seconds=round(time.time() - t1, 2)))
        print(tag, rows[-1], file=sys.stderr, flush=True)
    return carry, rows


def run_port(tag: str, device: str) -> dict:
    """``run_config``'s figures from the port on ``device``, no JAX imported."""
    import chip_smoke
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.capacity import derive_capacities
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    scans, traj = bs.gen_scans(N_SCANS)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = chip_smoke.complete_cfg(tag, tmp, load_yaml_file)
    knobs = chip_smoke.COMPLETE_KNOBS.get(tag, {})
    x0, t0, _, v0 = scans[0]
    names = ("raw_capacity", "map_slots", "layer_capacities", "insert_budgets")
    sizing = dict(zip(names, derive_capacities(spec_from_yaml(cfg, **knobs), x0[v0], t0[v0], with_budgets=True,
                                               known_max_points=max(int(v.sum()) for *_, v in scans))))
    spec = spec_from_yaml(cfg, kf_ring_capacity=256, **sizing, **knobs)
    carry = pb.init_fleet_carry(spec, 1, device=device)
    carry, rows = _step_all(tag, pb.make_fleet_step(spec), carry,
                            lambda k, s: pb.pack_scans(spec, [s], [traj.stamps[k]], device=device), scans)
    gt = _gt_error(traj, N_SCANS - 1, carry.pose_R[0].cpu().numpy(), carry.pose_t[0].cpu().numpy(), port=True)
    return _figures(dict(tag=tag, port=device, knobs=knobs), sizing, spec, carry, rows, gt)


def _figures(head, sizing, spec, carry, rows, gt) -> dict:
    m = carry.maps["localmap"]
    return dict(head, sizing=sizing, K=int(m.K), stride=int(m.stride), maps=sorted(carry.maps),
                per_voxel_nn=bool(spec.icp_with_vel.per_voxel_nn), nn_neighbors=int(spec.icp_with_vel.nn_neighbors),
                min_distance=float(spec.map_layers[0].min_distance_between_points),
                anderson_m=int(spec.icp_with_vel.anderson_m), horn=spec.icp_with_vel.horn is not None,
                one_to_one=not spec.icp_with_vel.matchers[0].allow_match_already_matched,
                iterations=[r["iterations"] for r in rows], quality=[r["quality"] for r in rows],
                accepted=[r["accepted"] for r in rows], collision_drops=sum(r["collision_drops"] for r in rows),
                map_points=sum(r["n_map"] for r in rows),
                mean_quality=float(np.mean([r["quality"] for r in rows[1:]])), final_pose_gt_error=gt)


def run_oracle() -> dict:
    os.environ.update(TPU_ALGO)
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu.oracle import OracleOdometry, relative, se3_log
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file

    import chip_smoke

    traj, scans = _scans()
    path = os.path.join(ROOT, "pipelines", "lidar3d-default.yaml")
    lo = LidarOdometry.from_yaml_file(path, env={}, kf_ring_capacity=256)
    oracle = OracleOdometry(spec_from_yaml(load_yaml_file(path, env={})))
    eng, ora, secs = [], [], []
    for k, (xyz, times, rings, valid) in enumerate(scans):
        out = lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid], ring=rings[valid])
        t1 = time.time()
        o = oracle.step(xyz[valid].astype(np.float64), times[valid].astype(np.float64), float(traj.stamps[k]))
        secs.append(time.time() - t1)
        eng.append((np.asarray(out.pose_R), np.asarray(out.pose_t)))
        ora.append((o.R, o.t, o.quality, o.accepted))
        print("oracle", k, float(out.quality), o.quality, round(secs[-1], 2), file=sys.stderr, flush=True)
    figures = chip_smoke.oracle_figures(traj, eng, [(R, t) for R, t, _, _ in ora], relative, se3_log)
    return dict(tag="oracle", **figures, oracle_quality=[q for *_, q, _ in ora],
                oracle_accepted=[a for *_, a in ora], oracle_seconds_per_scan=secs)


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    if argv[:1] == ["--port"]:
        for tag in argv[2:]:
            print(json.dumps(run_port(tag, argv[1])), flush=True)
        return 0
    if len(argv) == 1:
        print(json.dumps(run_oracle() if argv[0] == "oracle" else run_config(argv[0])), flush=True)
        return 0
    import chip_smoke

    tags = argv or list(chip_smoke.COMPLETE) + ["oracle"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    for i in range(0, len(tags), 3):
        procs = [subprocess.Popen([sys.executable, __file__, t], env=env, stdout=subprocess.PIPE, text=True)
                 for t in tags[i:i + 3]]
        for t, p in zip(tags[i:i + 3], procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                raise SystemExit(f"{t}: exit {p.returncode}")
            print(out.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
