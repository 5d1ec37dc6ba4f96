"""The fleet's town and its vehicles' trajectories, on the host in numpy.

A copy of the port's simulator (``utils/sim.py``: ``make_world``,
``make_trajectory``, ``_pose_advance``, ``_so3_exp``, the ground's
roughness), kept here so that the traffic a cell measures cannot move with
the program.  Two things differ, both because one town now holds a fleet:

* the town keeps every building and piece of street clutter it draws (the
  simulator clears one corridor along ``y = 0`` for its one vehicle);
* each vehicle's path is placed in the town instead: its own trajectory is
  turned and moved to a start drawn from the same stream until every pose
  of it keeps the simulator's corridor clearances (5 m from a building's
  centre, 2 m from a clutter item's, read on a 0.1 m grid) and stays inside
  the town.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

BUILDING_CLEARANCE = 5.0  # m, the simulator's corridor half-width for buildings
CLUTTER_CLEARANCE = 2.0  # m, and for street clutter
PLACEMENT_BATCH = 1024  # candidate starts drawn at once
PLACEMENT_ROUNDS = 256
GRID_M = 0.1  # the clearance is read on a grid of this pitch


@dataclass
class World:
    """Ground plane + yaw-rotated boxes: buildings, then plates, then clutter."""

    centers: np.ndarray  # (M, 3) box centres (z = half height)
    half: np.ndarray  # (M, 3) half sizes
    yaw: np.ndarray  # (M,)
    n_buildings: int
    n_plates: int
    ground_z: float = 0.0


@dataclass
class Trajectory:
    stamps: np.ndarray  # (F,)
    R: np.ndarray  # (F, 3, 3) pose at each scan's middle
    t: np.ndarray  # (F, 3)
    twists: np.ndarray  # (F, 6) body twist during each scan


def make_world(rng: np.random.Generator, extent: float, n_boxes: int, n_plates: int) -> World:
    """``utils/sim.py::make_world`` without its corridor: buildings (tall
    rotated boxes), thin ground plates, and street clutter (n_boxes +
    n_plates items, 0.3-2.2 m tall)."""
    centers = rng.uniform(-extent, extent, (n_boxes, 2))
    sizes = rng.uniform([1.0, 1.0, 2.0], [8.0, 8.0, 9.0], (n_boxes, 3))
    c3 = np.concatenate([centers, sizes[:, 2:3] / 2], axis=1)
    pc = rng.uniform(-extent, extent, (n_plates, 2))
    ps = rng.uniform([4.0, 4.0, 0.1], [18.0, 18.0, 0.25], (n_plates, 3))
    pc3 = np.concatenate([pc, ps[:, 2:3] / 2], axis=1)
    n_clutter = n_boxes + n_plates
    cc = rng.uniform(-extent, extent, (n_clutter, 2))
    cs = rng.uniform([0.3, 0.3, 0.3], [2.5, 2.5, 2.2], (n_clutter, 3))
    cc3 = np.concatenate([cc, cs[:, 2:3] / 2], axis=1)
    return World(
        centers=np.concatenate([c3, pc3, cc3]).astype(np.float64),
        half=np.concatenate([sizes / 2, ps / 2, cs / 2]).astype(np.float64),
        yaw=np.concatenate([rng.uniform(0, np.pi, n_boxes), rng.uniform(0, np.pi, n_plates),
                            rng.uniform(0, np.pi, n_clutter)]),
        n_buildings=n_boxes,
        n_plates=n_plates,
    )


def so3_exp(phi: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(phi)
    if th < 1e-12:
        return np.eye(3)
    a = phi / th
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def pose_advance(R, t, twist, dt):
    """Advance a pose by a constant body twist over ``dt`` (rotation and
    translation split, the deskew model)."""
    v, w = twist[:3], twist[3:]
    return R @ so3_exp(w * dt), t + R @ (v * dt)


def make_trajectory(rng: np.random.Generator, n_frames: int, dt: float, speed: float, yaw_rate: float,
                    accel: float, z: float = 1.5) -> Trajectory:
    """``utils/sim.py::make_trajectory`` on the given stream: from rest at
    the origin heading +x, speed up to ``speed`` at ``accel``, a slowly
    varying yaw rate, and suspension pitch, roll and heave."""
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
        bf = ramp_f * min(1.0, v)
        wx = 0.85 * wx + 0.15 * rng.normal(0, 0.12) * bf
        wy = 0.85 * wy + 0.15 * rng.normal(0, 0.12) * bf
        vz = 0.85 * vz + 0.15 * rng.normal(0, 0.25) * bf
        ypr_pitch = np.arcsin(np.clip(-R[2, 0], -1, 1))
        ypr_roll = np.arctan2(R[2, 1], R[2, 2])
        wx -= 2.0 * ypr_roll * 0.1
        wy -= 2.0 * ypr_pitch * 0.1
        vz -= 2.0 * (t[2] - z) * 0.5
        tw = np.array([v, 0.0, vz, wx, wy, wz])
        Rs.append(R.copy())
        ts.append(t.copy())
        tws.append(tw)
        R, t = pose_advance(R, t, tw, dt)
    return Trajectory(stamps, np.stack(Rs), np.stack(ts), np.stack(tws))


def forbidden_grid(world: World, extent: float) -> np.ndarray:
    """(G, G) bool over the town on a ``GRID_M`` grid: cells whose centre
    lies within a building's or a clutter item's clearance."""
    n = int(round(2 * extent / GRID_M))
    ax = -extent + (np.arange(n) + 0.5) * GRID_M
    gx, gy = np.meshgrid(ax, ax, indexing="ij")
    bad = np.zeros((n, n), bool)
    nb, npl = world.n_buildings, world.n_plates
    for sl, clearance in ((slice(0, nb), BUILDING_CLEARANCE), (slice(nb + npl, None), CLUTTER_CLEARANCE)):
        for cx, cy in world.centers[sl, :2]:
            i0, i1 = np.searchsorted(ax, [cx - clearance, cx + clearance])
            j0, j1 = np.searchsorted(ax, [cy - clearance, cy + clearance])
            sub = (gx[i0:i1, j0:j1] - cx) ** 2 + (gy[i0:i1, j0:j1] - cy) ** 2 < clearance * clearance
            bad[i0:i1, j0:j1] |= sub
    return bad


def _clear(paths_xy: np.ndarray, bad: np.ndarray, extent: float, inner: float) -> np.ndarray:
    """(C,) whether each candidate path (C, F, 2) stays within ``inner`` of
    the origin on both axes and off the forbidden cells."""
    ok = np.all(np.abs(paths_xy) <= inner, axis=(1, 2))
    idx = np.clip(((paths_xy + extent) / GRID_M).astype(np.int64), 0, bad.shape[0] - 1)
    return ok & ~bad[idx[..., 0], idx[..., 1]].any(axis=1)


def place(traj: Trajectory, bad: np.ndarray, rng: np.random.Generator, extent: float, margin: float) -> Trajectory:
    """``traj`` turned by a yaw and moved to a start, both drawn from
    ``rng``, at the first draw whose poses keep the clearances and stay
    ``margin`` inside the town."""
    inner = extent - margin
    xy = traj.t[:, :2]
    for _ in range(PLACEMENT_ROUNDS):
        yaw = rng.uniform(-np.pi, np.pi, PLACEMENT_BATCH)
        start = rng.uniform(-inner, inner, (PLACEMENT_BATCH, 2))
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)  # (C, 2, 2)
        cand = np.einsum("cij,fj->cfi", rot, xy) + start[:, None, :]
        hit = np.flatnonzero(_clear(cand, bad, extent, inner))
        if hit.size:
            i = int(hit[0])
            Rz = np.array([[c[i], -s[i], 0.0], [s[i], c[i], 0.0], [0.0, 0.0, 1.0]])
            t = traj.t @ Rz.T
            t[:, :2] += start[i]
            return Trajectory(traj.stamps, np.einsum("ij,fjk->fik", Rz, traj.R), t, traj.twists)
    raise RuntimeError("no clear start found for a vehicle; the town is too crowded for its paths")


def fleet(seed: int, traffic: dict) -> tuple[World, List[Trajectory], List[int]]:
    """The cell's town and its drives, one placed trajectory per instance,
    drawn from the traffic mix's fixed ``town_seed``, in an order drawn
    from ``seed``; and the drive each instance got.  Every run steps the
    same set of drives, so the seed does not change the work a run holds
    (towns drawn from the seed moved the step's time with it); it draws
    which instance drives which and, through ``noise_seeds``, every scan's
    sensor noise."""
    w = traffic["world"]
    v = traffic["vehicle"]
    town = w["town_seed"]
    world = make_world(np.random.default_rng([town, 0]), w["extent_m"], w["boxes"], w["plates"])
    bad = forbidden_grid(world, w["extent_m"])
    trajs = []
    for i in range(traffic["instances"]):
        rng = np.random.default_rng([town, 1, i])
        tr = make_trajectory(rng, traffic["frames"], 1.0 / traffic["sensor"]["rate_hz"], v["max_speed_mps"],
                             v["yaw_rate"], v["accel_mps2"])
        trajs.append(place(tr, bad, rng, w["extent_m"], w["path_margin_m"]))
    order = [int(i) for i in np.random.default_rng([seed, 3]).permutation(len(trajs))]
    return world, [trajs[i] for i in order], order


def noise_seeds(seed: int, traffic: dict, drives: List[int]) -> List[int]:
    """The seed of each drive's sensor noise, from the run's seed, the town
    and the drive."""
    town = traffic["world"]["town_seed"]
    return [int(np.random.SeedSequence([seed, town, 4, d]).generate_state(1, np.uint64)[0]) for d in drives]
