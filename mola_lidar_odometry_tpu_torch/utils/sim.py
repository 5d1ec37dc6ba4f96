"""Synthetic spinning-LiDAR world simulator (host-side, numpy).

The reference's tests replay tiny recorded dataset fragments with known
ground truth (test/test_lidar_odometry_rawlog.cpp, GT
test/kitti_00_fragment_gt.tum).  Those fragments live in an external data
package that is not available here, so the golden end-to-end tests ray-cast
a synthetic structured world (ground plane + random boxes) along a known
smooth trajectory instead: same test shape (TUM GT + SE(3) log-norm
tolerance), fully self-contained and deterministic.

The sensor spins one revolution per scan; each azimuth column is cast from
the interpolated vehicle pose at its own sub-scan time, so scans exhibit
real motion distortion and the deskew path is exercised end-to-end.
Per-point timestamps are column times relative to mid-scan (matching
``FilterAdjustTimestamps(MiddleIsZero)`` conventions).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class SimWorld:
    """Ground plane + yaw-rotated boxes (diverse surface normals so
    point-to-point ICP is well-conditioned in every direction)."""

    centers: np.ndarray  # (B, 3) box centers (z = center of height)
    half: np.ndarray  # (B, 3) half sizes
    yaw: np.ndarray  # (B,) rotation about z
    ground_z: float = 0.0


def make_world(seed: int = 0, extent: float = 60.0, n_boxes: int = 50, n_plates: int = 30) -> SimWorld:
    """Buildings (tall rotated boxes, clear of the path) + ground 'plates'
    (large thin slabs: curbs, ramps, sidewalk steps) + a ROUGH ground.

    A glass-flat ground plane makes point-to-point ICP degenerate: the
    sensor-anchored ring pattern is a moving pattern the matcher locks
    onto, which measurably biases every scan-to-scan registration ~2 cm
    BACKWARD per frame on this geometry (even with zero motion distortion
    and exact float64 alignment — the bias is in the sampling, not the
    solver).  Real asphalt has centimetre roughness that anchors ground
    points to the WORLD, so the ground here carries a deterministic
    cell-hashed heightfield (~4 cm) — see ``_ground_height``."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n_boxes, 2))
    # keep a clear corridor near the origin path
    centers = centers[np.abs(centers[:, 1]) > 5.0]
    b = centers.shape[0]
    sizes = rng.uniform([1.0, 1.0, 2.0], [8.0, 8.0, 9.0], (b, 3))
    c3 = np.concatenate([centers, sizes[:, 2:3] / 2], axis=1)
    # thin plates anywhere (incl. under the path; <=25 cm tall)
    pc = rng.uniform(-extent, extent, (n_plates, 2))
    ps = rng.uniform([4.0, 4.0, 0.1], [18.0, 18.0, 0.25], (n_plates, 3))
    pc3 = np.concatenate([pc, ps[:, 2:3] / 2], axis=1)
    # street clutter: cars / bushes / posts (0.3-2.2 m tall), allowed close
    # to the path.  Streets are full of this, and it is what lets a
    # point-to-POINT pipeline observe along-track motion: ground rings are
    # a sensor-anchored pattern that p2p matching provably mis-registers
    # (measured ~70% of per-frame motion lost on a clutter-free corridor,
    # float64 exact solver — the pattern, not the solver, is the problem).
    n_clutter = n_boxes + n_plates
    cc = rng.uniform(-extent, extent, (n_clutter, 2))
    cc = cc[np.abs(cc[:, 1]) > 2.0]
    nc = cc.shape[0]
    cs = rng.uniform([0.3, 0.3, 0.3], [2.5, 2.5, 2.2], (nc, 3))
    cc3 = np.concatenate([cc, cs[:, 2:3] / 2], axis=1)
    return SimWorld(
        centers=np.concatenate([c3, pc3, cc3]).astype(np.float64),
        half=np.concatenate([sizes / 2, ps / 2, cs / 2]).astype(np.float64),
        yaw=np.concatenate(
            [
                rng.uniform(0, np.pi, b),
                rng.uniform(0, np.pi, n_plates),
                rng.uniform(0, np.pi, nc),
            ]
        ),
        ground_z=0.0,
    )


def make_indoor_world(seed: int = 0, extent: float = 12.0, n_racks: int = 10,
                      n_clutter: int = 40) -> SimWorld:
    """Warehouse-scale indoor world: perimeter walls + aisle racks + floor
    clutter, with structure CLOSE to the sensor path (unlike
    :func:`make_world`, which clears a street-width corridor).

    Hand-held indoor recordings (reference test/rslidar_fragment_gt.tum —
    a warehouse bag) move centimetres per frame; registration accuracy then
    comes from nearby vertical structure, not the ground.  An outdoor-style
    cleared corridor leaves mostly ground rings in view, which is the
    degenerate case for point-to-point matching."""
    rng = np.random.default_rng(seed)
    wall_t = 0.2
    h = 5.0
    walls = []
    for sgn in (-1.0, 1.0):
        walls.append(([sgn * extent, 0.0, h / 2], [wall_t, extent, h / 2], 0.0))
        walls.append(([0.0, sgn * extent, h / 2], [extent, wall_t, h / 2], 0.0))
    # aisle racks: rows of long shelving either side of a ~3 m aisle
    racks = []
    for k in range(n_racks):
        y = rng.choice([-1.0, 1.0]) * rng.uniform(1.8, extent - 2.0)
        x = rng.uniform(-extent + 2.0, extent - 2.0)
        ln = rng.uniform(2.0, 6.0)
        ht = rng.uniform(2.0, 4.5)
        racks.append(([x, y, ht / 2], [ln / 2, 0.5, ht / 2], rng.uniform(0, np.pi)))
    # floor clutter: crates/pallets, allowed close to the path
    clutter = []
    for k in range(n_clutter):
        x, y = rng.uniform(-extent + 1, extent - 1, 2)
        if abs(y) < 0.8 and abs(x) < 2.5:
            continue  # keep the sensor's own footprint clear
        s = rng.uniform([0.2, 0.2, 0.2], [1.2, 1.2, 1.5])
        clutter.append(([x, y, s[2] / 2], s / 2, rng.uniform(0, np.pi)))
    ents = walls + racks + clutter
    return SimWorld(
        centers=np.array([e[0] for e in ents], np.float64),
        half=np.array([e[1] for e in ents], np.float64),
        yaw=np.array([e[2] for e in ents], np.float64),
        ground_z=0.0,
    )


_GROUND_AMP = 0.04  # m — asphalt-scale roughness
_GROUND_CELL = 0.75  # m — texture cell size


def _ground_height(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Deterministic world-anchored ground roughness (integer-cell hash).

    The same (x, y) always returns the same height regardless of which
    scan asks, so ground points carry real registration information."""
    cx = np.floor(x / _GROUND_CELL).astype(np.int64)
    cy = np.floor(y / _GROUND_CELL).astype(np.int64)
    h = (cx * np.int64(73856093)) ^ (cy * np.int64(19349663))
    h = (h ^ (h >> 13)) * np.int64(0x5BD1E995)
    u = ((h ^ (h >> 15)) & 0xFFFF).astype(np.float64) / 65535.0
    return (u - 0.5) * 2.0 * _GROUND_AMP


def _ray_world(origins: np.ndarray, dirs: np.ndarray, world: SimWorld, max_range: float):
    """Closest hit distance per ray (inf = miss). origins/dirs: (N, 3)."""
    n = origins.shape[0]
    t_best = np.full(n, np.inf)

    # rough ground around z = ground_z (hit only from above): first-order
    # heightfield intersection — flat-plane hit, then re-solve against the
    # cell height at the flat hit's (x, y).  Exact for amplitudes far below
    # the sensor height; grazing rays get the same long range jitter real
    # rough ground produces.
    dz = dirs[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_g = (world.ground_z - origins[:, 2]) / dz
        hx = origins[:, 0] + t_g * dirs[:, 0]
        hy = origins[:, 1] + t_g * dirs[:, 1]
        hx = np.clip(np.nan_to_num(hx), -1e6, 1e6)  # misses produce inf
        hy = np.clip(np.nan_to_num(hy), -1e6, 1e6)
        gz = world.ground_z + _ground_height(hx, hy)
        t_g = (gz - origins[:, 2]) / dz
    ok = (dz < -1e-9) & (t_g > 0.05)
    t_best = np.where(ok, np.minimum(t_best, t_g), t_best)

    # rotated boxes: slab test in each box's frame
    for b in range(world.centers.shape[0]):
        cy, sy = np.cos(world.yaw[b]), np.sin(world.yaw[b])
        Rb = np.array([[cy, sy, 0], [-sy, cy, 0], [0, 0, 1]])  # world -> box
        o = (origins - world.centers[b]) @ Rb.T
        d = dirs @ Rb.T
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            t0 = (-world.half[b] - o) * inv
            t1 = (world.half[b] - o) * inv
        tmin = np.minimum(t0, t1).max(axis=1)
        tmax = np.maximum(t0, t1).min(axis=1)
        hit = (tmax >= tmin) & (tmax > 0) & (tmin > 0.05)
        t_best = np.where(hit, np.minimum(t_best, tmin), t_best)

    t_best = np.where(t_best <= max_range, t_best, np.inf)
    return t_best


def _so3_exp(phi: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(phi)
    if th < 1e-12:
        return np.eye(3)
    a = phi / th
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _pose_advance(R, t, twist, dt):
    """Advance pose by constant body twist over dt (rotation+translation split,
    matching the deskew model)."""
    v, w = twist[:3], twist[3:]
    Rd = _so3_exp(w * dt)
    return R @ Rd, t + R @ (v * dt)


@dataclass
class SimTrajectory:
    stamps: np.ndarray  # (F,)
    R: np.ndarray  # (F, 3, 3) pose at scan stamp (mid-scan)
    t: np.ndarray  # (F, 3)
    twists: np.ndarray  # (F, 6) body twist during each scan interval


def make_trajectory(
    n_frames: int,
    dt: float = 0.1,
    seed: int = 1,
    speed: float = 3.0,
    yaw_rate: float = 0.25,
    z: float = 1.5,
    accel: float = 3.0,
) -> SimTrajectory:
    """Smooth forward trajectory with slowly varying yaw rate.

    Acceleration is capped at ``accel`` m/s² (default: a brisk but
    physical 3 m/s²).  The old frame-count-based ramp reached 8 m/s² at
    bench settings — harder than any street vehicle — and a
    constant-velocity-prior odometry (this one, the float64 oracle, AND
    the reference algorithm) systematically under-corrects such a launch
    by ~30% of the per-frame velocity step, which read as ~1.2 m of
    along-track "drift" that was really an unrepresentative input.
    """
    rng = np.random.default_rng(seed)
    stamps = np.arange(n_frames) * dt
    R = np.eye(3)
    t = np.array([0.0, 0.0, z])
    Rs, ts, tws = [], [], []
    wz = wx = wy = vz = 0.0
    for k in range(n_frames):
        v = min(speed, accel * k * dt)
        ramp_f = v / speed if speed > 0 else 0.0
        wz = 0.9 * wz + 0.1 * rng.normal(0, yaw_rate * 3)
        wz = np.clip(wz, -yaw_rate * 2, yaw_rate * 2) * ramp_f
        # suspension motion: small smoothly-varying pitch/roll rates and
        # vertical velocity.  Without it the sensor height and ring
        # elevations repeat EXACTLY every frame, so the ground ring pattern
        # aliases frame-to-frame and point-to-point matching mis-registers
        # along-track (~70% of motion lost, verified with an exact float64
        # solver on the bounce-free world) — an artifact no real vehicle
        # produces.
        bf = ramp_f * min(1.0, v)
        wx = 0.85 * wx + 0.15 * rng.normal(0, 0.12) * bf  # roll rate [rad/s]
        wy = 0.85 * wy + 0.15 * rng.normal(0, 0.12) * bf  # pitch rate
        vz = 0.85 * vz + 0.15 * rng.normal(0, 0.25) * bf  # heave [m/s]
        # weak spring recentering so attitude/height never walk away
        ypr_pitch = np.arcsin(np.clip(-R[2, 0], -1, 1))
        ypr_roll = np.arctan2(R[2, 1], R[2, 2])
        wx -= 2.0 * ypr_roll * dt / max(dt, 1e-9) * 0.1
        wy -= 2.0 * ypr_pitch * dt / max(dt, 1e-9) * 0.1
        vz -= 2.0 * (t[2] - z) * 0.5
        tw = np.array([v, 0.0, vz, wx, wy, wz])
        Rs.append(R.copy())
        ts.append(t.copy())
        tws.append(tw)
        R, t = _pose_advance(R, t, tw, dt)
    return SimTrajectory(stamps, np.stack(Rs), np.stack(ts), np.stack(tws))


def _so3_log(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-9:
        return np.zeros(3)
    w = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2.0 * np.sin(th))
    )
    return w * th


def trajectory_from_tum(path, *, z_offset: float = 1.5) -> SimTrajectory:
    """Load a RECORDED ground-truth trajectory (TUM format) as a
    :class:`SimTrajectory` for raycasting the sim world along it.

    This imports real motion profiles — e.g. the reference's checked-in GT
    fragments (reference test/kitti_00_fragment_gt.tum: a KITTI-00 vehicle
    launch; test/rslidar_fragment_gt.tum: 23 hand-held warehouse poses whose
    jerk stresses the deskew path, per test/test_lidar_odometry_rosbag2.cpp:
    138-143) — into the synthetic accuracy bed: the worlds stay simulated
    and deterministic, the DYNAMICS are real.

    Per-frame twists come from finite differences in the body frame,
    matching :func:`_pose_advance`'s split convention (v advanced with the
    start rotation): ``w_k = log(R_k^T R_{k+1})/dt``,
    ``v_k = R_k^T (t_{k+1}-t_k)/dt``.  ``z_offset`` lifts the (usually
    origin-anchored) recorded track to a sensor height above the sim
    ground plane.
    """
    from mola_lidar_odometry_tpu_torch.utils.tum import load_tum

    stamps, t, quat_xyzw = load_tum(path)
    stamps = np.asarray(stamps, np.float64)
    stamps = stamps - stamps[0]
    t = np.asarray(t, np.float64) + np.array([0.0, 0.0, z_offset])
    n = len(stamps)
    Rs = np.empty((n, 3, 3))
    for k in range(n):
        x, y, zq, w = np.asarray(quat_xyzw[k], np.float64)
        nq = np.linalg.norm([x, y, zq, w]) or 1.0
        x, y, zq, w = x / nq, y / nq, zq / nq, w / nq
        Rs[k] = np.array(
            [
                [1 - 2 * (y * y + zq * zq), 2 * (x * y - zq * w), 2 * (x * zq + y * w)],
                [2 * (x * y + zq * w), 1 - 2 * (x * x + zq * zq), 2 * (y * zq - x * w)],
                [2 * (x * zq - y * w), 2 * (y * zq + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
    tws = np.zeros((n, 6))
    for k in range(n - 1):
        dt = max(float(stamps[k + 1] - stamps[k]), 1e-6)
        tws[k, 3:] = _so3_log(Rs[k].T @ Rs[k + 1]) / dt
        tws[k, :3] = Rs[k].T @ (t[k + 1] - t[k]) / dt
    if n > 1:
        tws[-1] = tws[-2]  # hold the last interval's twist
    return SimTrajectory(
        stamps.astype(np.float64), Rs, t, tws
    )


def simulate_scan(
    world: SimWorld,
    R: np.ndarray,
    t: np.ndarray,
    twist: np.ndarray,
    *,
    n_rings: int = 16,
    n_azimuth: int = 512,
    fov_up_deg: float = 10.0,
    fov_down_deg: float = -25.0,
    spin_period: float = 0.1,
    max_range: float = 80.0,
    noise: float = 0.01,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One motion-distorted scan from pose (R, t) at mid-scan.

    Returns (xyz_sensor (N,3) f32, times (N,) f32, rings (N,) i32,
    valid (N,) bool) with N = n_rings * n_azimuth.
    """
    rng = np.random.default_rng(seed)
    az = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False)
    el = np.deg2rad(np.linspace(fov_down_deg, fov_up_deg, n_rings))
    az_g, el_g = np.meshgrid(az, el)  # (H, W)
    dirs_sensor = np.stack(
        [np.cos(el_g) * np.cos(az_g), np.cos(el_g) * np.sin(az_g), np.sin(el_g)], axis=-1
    )  # (H, W, 3)
    col_time = (az / (2 * np.pi)) * spin_period  # in [-T/2, T/2)

    # per-column sensor pose (motion distortion), then one batched raycast
    Rcols = np.empty((n_azimuth, 3, 3))
    tcols = np.empty((n_azimuth, 3))
    for j in range(n_azimuth):
        Rcols[j], tcols[j] = _pose_advance(R, t, twist, col_time[j])
    d_w = np.einsum("jab,hjb->hja", Rcols, dirs_sensor)  # (H, W, 3)
    o_w = np.broadcast_to(tcols[None], (n_rings, n_azimuth, 3))
    trng = _ray_world(o_w.reshape(-1, 3), d_w.reshape(-1, 3), world, max_range)
    trng = trng.reshape(n_rings, n_azimuth)
    valid = np.isfinite(trng)
    rngs = np.where(valid, trng, 0.0) + rng.normal(0, noise, (n_rings, n_azimuth))
    # store in SENSOR frame at each column's own time (raw skewed scan)
    xyz = (dirs_sensor * rngs[..., None]).astype(np.float32)

    times = np.broadcast_to(col_time[None, :], (n_rings, n_azimuth))
    rings = np.broadcast_to(np.arange(n_rings)[:, None], (n_rings, n_azimuth))
    return (
        xyz.reshape(-1, 3).astype(np.float32),
        times.reshape(-1).astype(np.float32),
        rings.reshape(-1).astype(np.int32),
        valid.reshape(-1),
    )


def simulate_sequence(
    n_frames: int = 20,
    *,
    world_seed: int = 0,
    traj_seed: int = 1,
    dt: float = 0.1,
    speed: float = 3.0,
    n_rings: int = 24,
    n_azimuth: int = 1024,
    noise: float = 0.01,
    max_range: float = 60.0,
    fov_up_deg: float = 15.0,
    fov_down_deg: float = -16.0,
) -> Tuple[SimTrajectory, List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]]:
    """Convenience: world + trajectory + all scans.

    Default FOV keeps the featureless-ground fraction moderate: a perfectly
    planar synthetic ground with sparse rings is *harder* for point-to-point
    ICP than real streets (the sensor-anchored ring pattern pulls toward zero
    motion, with none of the texture real ground has), so the defaults aim
    for realistic structure fractions rather than worst-case glass floor.
    """
    world = make_world(world_seed, extent=45.0, n_boxes=80, n_plates=40)
    traj = make_trajectory(n_frames, dt=dt, seed=traj_seed, speed=speed)
    scans = []
    for k in range(n_frames):
        scans.append(
            simulate_scan(
                world,
                traj.R[k],
                traj.t[k],
                traj.twists[k],
                n_rings=n_rings,
                n_azimuth=n_azimuth,
                fov_up_deg=fov_up_deg,
                fov_down_deg=fov_down_deg,
                spin_period=dt,
                noise=noise,
                max_range=max_range,
                seed=1000 + k,
            )
        )
    return traj, scans


def world_intensity(traj: SimTrajectory, k: int, xyz: np.ndarray) -> np.ndarray:
    """Intensities for scan ``k`` of ``traj`` (sensor-frame ``xyz`` (N, 3)):
    bright (250) on stripes of the world, dull (0-120) elsewhere, a function
    of the world position only, so a bright surface stays bright from scan
    to scan (the intensity pipelines' bright layer)."""
    w = xyz.astype(np.float64) @ traj.R[k].T + traj.t[k]
    bright = np.sin(1.3 * w[:, 0]) * np.sin(1.1 * w[:, 1]) > 0.6
    return np.where(bright, 250.0, 60.0 * (1.0 + np.sin(3.0 * w[:, 2]))).astype(np.float32)
