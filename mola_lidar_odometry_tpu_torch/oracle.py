"""Reference-exact float64 oracle odometry (NumPy / SciPy, host-only).

Port of ``mola_lidar_odometry_tpu/oracle.py``: the reference's per-scan
algorithm implemented a second time, exactly, so that the port's engine can
be held against it without the JAX package in the process:

  * float64 everywhere (the C++ uses double),
  * an *unbounded* voxel hash map (``dict`` keyed by integer voxel coords,
    per-voxel point cap only — no slot-collision drops, no fixed capacity),
  * exact nearest-neighbour search (``scipy.spatial.cKDTree`` over all map
    points, rebuilt after every map update),
  * exact dense Gauss-Newton with re-capture every iteration (no
    capture-once candidate caching, no kernels, no probe footprint limits).

It interprets the SAME compiled :class:`~.models.spec.OdometrySpec` the
port's engine runs (filter graph, runtime expressions, thresholds), so an
engine-vs-oracle delta isolates exactly the approximations of the engine:
float32, hash capacity, 27-voxel probe, candidate caching.  It is numpy on
the host in both packages, the same operations in the same order, so the
two oracles agree to float64 rounding; it is not a device path and never
touches a card.  The filter interpretation is ``utils/exact_filters.py``
(the one copy the capacity derivation reads too).

Used by ``tests/test_torch_oracle_parity.py`` (the gates of the JAX
package's ``tests/test_oracle_parity.py``: every engine pose within 0.1
SE(3) log-norm of the oracle's, the engine-to-oracle ATE-RMSE below 1% of
the path, the oracle within 0.25 of ground truth) and by
``chip_smoke.py``'s phase 11 beside the engine on the card.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from mola_lidar_odometry_tpu_torch.models import filter_graph as FG
from mola_lidar_odometry_tpu_torch.models.spec import OdometrySpec
from mola_lidar_odometry_tpu_torch.utils.exact_filters import Cloud, _deskew, _f, apply_pipeline_exact


# --------------------------------------------------------------------------
# float64 SE(3)
# --------------------------------------------------------------------------


def so3_exp(phi: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(phi))
    K = np.array(
        [[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]], np.float64
    )
    if th < 1e-12:
        return np.eye(3) + K + 0.5 * K @ K
    return (
        np.eye(3)
        + (math.sin(th) / th) * K
        + ((1.0 - math.cos(th)) / (th * th)) * (K @ K)
    )


def so3_log(R: np.ndarray) -> np.ndarray:
    c = (np.trace(R) - 1.0) / 2.0
    c = min(1.0, max(-1.0, c))
    th = math.acos(c)
    if th < 1e-9:
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        return w
    return (th / (2.0 * math.sin(th))) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )


def se3_exp(xi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """xi = [rho(3), phi(3)] -> (R, t); same V-matrix convention as ops/se3."""
    rho, phi = xi[:3], xi[3:]
    R = so3_exp(phi)
    th = float(np.linalg.norm(phi))
    K = np.array(
        [[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]], np.float64
    )
    if th < 1e-9:
        V = np.eye(3) + 0.5 * K + (1.0 / 6.0) * K @ K
    else:
        V = (
            np.eye(3)
            + ((1.0 - math.cos(th)) / (th * th)) * K
            + ((th - math.sin(th)) / th**3) * (K @ K)
        )
    return R, V @ rho


def se3_log(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    phi = so3_log(R)
    th = float(np.linalg.norm(phi))
    K = np.array(
        [[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]], np.float64
    )
    if th < 1e-9:
        Vinv = np.eye(3) - 0.5 * K + (1.0 / 12.0) * K @ K
    else:
        half = th / 2.0
        Vinv = (
            np.eye(3)
            - 0.5 * K
            + ((1.0 - half * math.cos(half) / math.sin(half)) / (th * th)) * (K @ K)
        )
    return np.concatenate([Vinv @ t, phi])


def compose(Ra, ta, Rb, tb):
    return Ra @ Rb, Ra @ tb + ta


def relative(Ra, ta, Rb, tb):
    """a^-1 b."""
    return Ra.T @ Rb, Ra.T @ (tb - ta)


# --------------------------------------------------------------------------
# unbounded voxel map + exact NN
# --------------------------------------------------------------------------


class ExactVoxelMap:
    """Unbounded HashedVoxelPointCloud semantics: dict of voxel -> points
    (per-voxel cap, first-come insertion order, L1 pruning)."""

    def __init__(self, voxel_size: float, points_per_voxel: int):
        self.voxel_size = float(voxel_size)
        self.cap = int(points_per_voxel)
        self.vox: Dict[Tuple[int, int, int], List[np.ndarray]] = {}
        self._tree = None
        self._pts = None

    def is_empty(self) -> bool:
        return not self.vox

    def insert(self, pts: np.ndarray) -> None:
        vs = self.voxel_size
        keys = np.floor(pts / vs).astype(np.int64)
        for p, k in zip(pts, map(tuple, keys)):
            lst = self.vox.get(k)
            if lst is None:
                self.vox[k] = [p]
            elif len(lst) < self.cap:
                lst.append(p)
        self._tree = None

    def prune_farther_than(self, center: np.ndarray, dist: float) -> None:
        if dist <= 0:
            return
        vs = self.voxel_size
        drop = [
            k
            for k in self.vox
            if np.max(np.abs((np.asarray(k, np.float64) + 0.5) * vs - center)) > dist
        ]
        for k in drop:
            del self.vox[k]
        if drop:
            self._tree = None

    def points(self) -> np.ndarray:
        if not self.vox:
            return np.zeros((0, 3))
        return np.concatenate([np.asarray(v) for v in self.vox.values()])

    def tree(self):
        from scipy.spatial import cKDTree

        if self._tree is None:
            self._pts = self.points()
            self._tree = cKDTree(self._pts)
        return self._tree, self._pts

    def match_targets(self) -> np.ndarray:
        """Points the NN matcher pairs against (= stored points)."""
        return self.points()

    def nearest_plane_fit(self, q, *, search_radius, min_plane_points, eigen_thr):
        """On-the-fly local plane fit per query (Matcher_Point2Plane against
        point maps; mirrors ops/voxel_hash.p2pl_from: fit over all stored
        points within ``search_radius``, exact eigh).  Returns
        ``(plane_pt, normal, found)``."""
        tree, pts = self.tree()
        N = len(q)
        plane_pt = np.zeros((N, 3))
        nrm = np.zeros((N, 3))
        found = np.zeros(N, bool)
        if len(pts) == 0:
            return plane_pt, nrm, found
        for i, nbrs in enumerate(tree.query_ball_point(q, search_radius)):
            if len(nbrs) < min_plane_points:
                continue
            rel = pts[nbrs] - q[i]
            mean = rel.mean(axis=0)
            C = (rel - mean).T @ (rel - mean) / len(nbrs)
            w, V = np.linalg.eigh(C)
            if w[0] > eigen_thr * max(w[1], 1e-12):
                continue
            n = V[:, 0]
            dpl = -float(n @ mean)  # signed dist: query - centroid
            plane_pt[i] = q[i] - dpl * n
            nrm[i] = n
            found[i] = True
        return plane_pt, nrm, found

    def clear(self) -> None:
        self.vox.clear()
        self._tree = None


class ExactNdtMap:
    """Unbounded ``mola::NDT`` semantics in f64: per-voxel Gaussians from
    voxel-center-relative moments, exact ``np.linalg.eigh`` plane fits, the
    same plane gate as the engine (n >= 5, lambda_min <=
    ``max_eigen_ratio`` * lambda_mid — ops/ndt.py:_refresh_planes; reference
    pipelines/lidar3d-ndt.yaml:236-254)."""

    MIN_POINTS_FOR_PLANE = 5

    def __init__(self, voxel_size: float, max_eigen_ratio: float = 0.05):
        self.voxel_size = float(voxel_size)
        self.ratio = float(max_eigen_ratio)
        # voxel key -> [n, sum(3) rel, sumsq(6) rel packed xx yy zz xy xz yz]
        self.vox: Dict[Tuple[int, int, int], list] = {}
        self._derived = None

    def is_empty(self) -> bool:
        return not self.vox

    def insert(self, pts: np.ndarray) -> None:
        vs = self.voxel_size
        keys = np.floor(pts / vs).astype(np.int64)
        for p, k in zip(pts, map(tuple, keys)):
            rel = p - (np.asarray(k, np.float64) + 0.5) * vs
            x, y, z = rel
            mom = np.array([x * x, y * y, z * z, x * y, x * z, y * z])
            e = self.vox.get(k)
            if e is None:
                self.vox[k] = [1, rel.copy(), mom]
            else:
                e[0] += 1
                e[1] += rel
                e[2] += mom
        self._derived = None

    def prune_farther_than(self, center: np.ndarray, dist: float) -> None:
        if dist <= 0:
            return
        vs = self.voxel_size
        drop = [
            k
            for k in self.vox
            if np.max(np.abs((np.asarray(k, np.float64) + 0.5) * vs - center)) > dist
        ]
        for k in drop:
            del self.vox[k]
        if drop:
            self._derived = None

    def clear(self) -> None:
        self.vox.clear()
        self._derived = None

    def _refresh(self):
        """means (global), normals, plane_ok arrays + KD-trees."""
        from scipy.spatial import cKDTree

        if self._derived is not None:
            return self._derived
        vs = self.voxel_size
        keys = np.asarray(list(self.vox.keys()), np.float64).reshape(-1, 3)
        n = np.array([e[0] for e in self.vox.values()], np.float64)
        s = np.stack([e[1] for e in self.vox.values()]) if self.vox else np.zeros((0, 3))
        ss = np.stack([e[2] for e in self.vox.values()]) if self.vox else np.zeros((0, 6))
        nf = np.maximum(n, 1.0)[:, None]
        mean_rel = s / nf
        means = (keys + 0.5) * vs + mean_rel
        normals = np.zeros_like(means)
        ok = np.zeros(len(n), bool)
        for i in range(len(n)):
            if n[i] < self.MIN_POINTS_FOR_PLANE:
                continue
            mx, my, mz = mean_rel[i]
            xx, yy, zz, xy, xz, yz = ss[i] / nf[i, 0] - np.array(
                [mx * mx, my * my, mz * mz, mx * my, mx * mz, my * mz]
            )
            C = np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])
            w, V = np.linalg.eigh(C)
            if w[0] >= -1e-6 and w[0] <= self.ratio * max(w[1], 1e-12):
                normals[i] = V[:, 0]
                ok[i] = True
        tree_all = cKDTree(means) if len(means) else None
        tree_pl = cKDTree(means[ok]) if ok.any() else None
        self._derived = (means, normals, ok, tree_all, tree_pl, means[ok], normals[ok])
        return self._derived

    def match_targets(self) -> np.ndarray:
        """Point-to-point fallback matches against voxel means
        (ops/ndt.py:p2p_from)."""
        return self._refresh()[0]

    def nearest_plane(self, q: np.ndarray):
        """Nearest plane-gated voxel (by mean distance, like the matcher's
        argmin over means): returns (mu, normal, found) arrays."""
        means, normals, ok, _, tree_pl, mpl, npl = self._refresh()
        N = len(q)
        mu = np.zeros((N, 3))
        nrm = np.zeros((N, 3))
        found = np.zeros(N, bool)
        if tree_pl is None:
            return mu, nrm, found
        d, j = tree_pl.query(q, k=1)
        found[:] = np.isfinite(d)
        mu[found] = mpl[j[found]]
        nrm[found] = npl[j[found]]
        return mu, nrm, found


class ExactOccupancyMap:
    """Unbounded ``mrpt::maps::CVoxelMap`` semantics in f64: log-odds voxels
    with ray-traced free space (reference pipelines/lidar2d.yaml:183-198).

    The free-space walk visits each voxel along the beam once (dense samples
    at ``voxel_size/4`` spacing + per-beam dedup — equivalent to a DDA walk
    except for corner-clipped voxels with chord < vs/4, which carry
    negligible evidence either way).  The engine's one-voxel-spaced
    sampled rays (ops/occupancy.py:insert) are a coarser approximation; the
    engine-vs-oracle delta therefore *includes* that documented deviation."""

    def __init__(
        self,
        voxel_size: float,
        *,
        prob_hit: float = 0.7,
        prob_miss: float = 0.3,
        clamp_min: float = 0.05,
        clamp_max: float = 0.95,
        occupied_threshold: float = 0.6,
        ray_trace: bool = True,
    ):
        def logit(p):
            return math.log(p / (1.0 - p))

        self.voxel_size = float(voxel_size)
        self.l_hit, self.l_miss = logit(prob_hit), logit(prob_miss)
        self.l_min, self.l_max = logit(clamp_min), logit(clamp_max)
        self.l_occ = logit(occupied_threshold)
        self.ray_trace = bool(ray_trace)
        self.vox: Dict[Tuple[int, int, int], float] = {}
        self._derived = None

    def is_empty(self) -> bool:
        return not any(v > self.l_occ for v in self.vox.values())

    def _add(self, key, delta):
        lo = self.vox.get(key, 0.0) + delta
        self.vox[key] = min(max(lo, self.l_min), self.l_max)

    def insert(self, pts: np.ndarray, origin: np.ndarray) -> None:
        vs = self.voxel_size
        if self.ray_trace and len(pts):
            d = pts - origin[None, :]
            rng = np.linalg.norm(d, axis=1)
            step = vs / 4.0
            for i in range(len(pts)):
                lim = rng[i] - 0.5 * vs
                if lim <= 0:
                    continue
                ts = np.arange(step * 0.5, lim, step)
                sample = origin[None, :] + d[i][None, :] * (ts / rng[i])[:, None]
                keys = np.floor(sample / vs).astype(np.int64)
                for k in map(tuple, dict.fromkeys(map(tuple, keys))):
                    self._add(k, self.l_miss)
        keys = np.floor(pts / vs).astype(np.int64)
        for k in map(tuple, keys):
            self._add(k, self.l_hit)
        self._derived = None

    def prune_farther_than(self, center: np.ndarray, dist: float) -> None:
        if dist <= 0:
            return
        vs = self.voxel_size
        drop = [
            k
            for k in self.vox
            if np.max(np.abs((np.asarray(k, np.float64) + 0.5) * vs - center)) > dist
        ]
        for k in drop:
            del self.vox[k]
        if drop:
            self._derived = None

    def clear(self) -> None:
        self.vox.clear()
        self._derived = None

    def match_targets(self) -> np.ndarray:
        """Occupied-voxel centers — the point view the matcher sees
        (ops/occupancy.py module docstring)."""
        if self._derived is None:
            occ = [k for k, v in self.vox.items() if v > self.l_occ]
            ctr = (
                (np.asarray(occ, np.float64).reshape(-1, 3) + 0.5) * self.voxel_size
            )
            self._derived = ctr
        return self._derived


# --------------------------------------------------------------------------
# exact navstate (same contract as models/navstate.py, f64)
# --------------------------------------------------------------------------


@dataclass
class NavEstimate:
    R: np.ndarray
    t: np.ndarray
    twist: np.ndarray
    valid: bool
    prior_info: np.ndarray  # (6, 6)


class ExactNavState:
    def __init__(self, cfg):
        self.cfg = cfg
        self.entries: List[Tuple[float, np.ndarray, np.ndarray]] = []

    def reset(self):
        self.entries.clear()

    def fuse_pose(self, t: float, R: np.ndarray, tr: np.ndarray):
        self.entries.append((t, R.copy(), tr.copy()))
        if len(self.entries) > 8:  # same WINDOW as the engine's ring
            self.entries.pop(0)

    def estimate(self, t_query: float) -> NavEstimate:
        cfg = self.cfg
        ident = NavEstimate(np.eye(3), np.zeros(3), np.zeros(6), False, np.zeros((6, 6)))
        if not self.entries:
            return ident
        tw_init = np.asarray(cfg.initial_twist, np.float64)
        horizon_win = cfg.sliding_window_length + cfg.max_time_to_use_velocity_model
        in_win = [e for e in self.entries if t_query - e[0] <= horizon_win]
        # consecutive finite-difference twists, recency-weighted (models/
        # navstate.py:137-155 semantics) with the robust/rmse contract
        pairs = []
        for (t0, R0, p0), (t1, R1, p1) in zip(self.entries[:-1], self.entries[1:]):
            if (t_query - t0 > horizon_win) or (t_query - t1 > horizon_win):
                continue
            dt = t1 - t0
            if dt <= 1e-6:
                continue
            Rr, tr = relative(R0, p0, R1, p1)
            xi = se3_log(Rr, tr) / dt
            tau = max(cfg.sliding_window_length / 4.0, 1e-3)
            w = dt * dt * math.exp(-max(t_query - t1, 0.0) / tau)
            pairs.append((xi, w))
        # normalized window evidence + per-axis prior + optional GM IRLS —
        # the exact math of models/navstate.py:estimate
        sl = max(getattr(cfg, "initial_twist_sigma_lin", 20.0), 1e-6)
        sa = max(getattr(cfg, "initial_twist_sigma_ang", 3.0), 1e-6)
        w0 = np.array([1 / sl**2] * 3 + [1 / sa**2] * 3)
        robust = getattr(cfg, "robust_param", 0.0)
        max_rmse = getattr(cfg, "max_rmse", 0.0)
        if pairs:
            xis = np.stack([xi for xi, _ in pairs])
            ws = np.array([w for _, w in pairs])
            wn = ws / ws.sum()
            rw = np.ones(len(pairs))
            twist = tw_init
            for _ in range(3 if robust > 0 else 1):
                den = float(np.sum(wn * rw)) + w0
                num = (xis * (wn * rw)[:, None]).sum(axis=0) + w0 * tw_init
                twist = num / den
                if robust > 0:
                    r2 = np.sum((xis - twist) ** 2, axis=1)
                    rw = (robust**2 / (r2 + robust**2)) ** 2
            rmse = math.sqrt(float(np.sum(wn * np.sum((xis - twist) ** 2, axis=1))))
            if max_rmse > 0 and rmse > max_rmse:
                twist = tw_init
        else:
            twist = tw_init
        t_last, R_last, p_last = self.entries[-1]
        horizon = t_query - t_last
        model_ok = 0 <= horizon <= cfg.max_time_to_use_velocity_model
        if not model_ok:
            return NavEstimate(R_last, p_last, np.zeros(6), False, np.zeros((6, 6)))
        dR, dt_ = se3_exp(twist * horizon)
        Rq, tq = compose(R_last, p_last, dR, dt_)
        sp = cfg.sigma_integrator_position + 0.5 * cfg.sigma_random_walk_acceleration_linear * horizon**2
        so = cfg.sigma_integrator_orientation + 0.5 * cfg.sigma_random_walk_acceleration_angular * horizon**2
        diag = np.array([1 / sp**2] * 3 + [1 / so**2] * 3)
        return NavEstimate(Rq, tq, twist, True, np.diag(diag))


# --------------------------------------------------------------------------
# the oracle engine
# --------------------------------------------------------------------------


@dataclass
class OracleOutput:
    R: np.ndarray
    t: np.ndarray
    stamp: float
    quality: float
    iterations: int
    accepted: bool
    kf_local: bool


class OracleOdometry:
    """Exact-arithmetic twin of models/odometry driven by the same spec."""

    _POINT_CLASSES = (
        "HashedVoxelPointCloud",
        "SparseTreesPointCloud",
        "CPointsMap",
        "CSimplePointsMap",
        "CPointsMapXYZI",
        "CPointsMapXYZIRT",
    )

    def __init__(self, spec: OdometrySpec):
        for d in spec.map_layers:
            if d.map_class not in self._POINT_CLASSES + ("NDT", "CVoxelMap"):
                raise ValueError(f"oracle: unsupported map class {d.map_class}")
        for cfg in (spec.icp_with_vel, spec.icp_without_vel):
            for mc in cfg.matchers:
                if mc.kind not in ("point2point", "point2plane"):
                    raise ValueError(f"oracle: unsupported matcher kind {mc.kind}")
                if mc.kind == "point2point" and mc.pairings_per_point not in (1, 2):
                    raise ValueError("oracle: pairingsPerPoint must be 1 or 2")
        self.spec = spec
        self.R = np.eye(3)
        self.t = np.zeros(3)
        self.sigma = 0.0
        self.est_range = 0.0
        self.inst_range = 0.0
        self.last_time: Optional[float] = None
        self.first_time: Optional[float] = None
        self.frame_idx = 0
        self.traj_len = 0
        self.last_iters = 0.0
        self.twist_corr = 0.0
        self.last_twist = np.zeros(6)
        self.has_twist = False
        self.nav = ExactNavState(spec.navstate)
        self.maps: Dict[str, object] = {}
        self.lm_kfs: List[Tuple[np.ndarray, np.ndarray]] = []
        self.removal_counter = 0
        self.outputs: List[OracleOutput] = []

    # -- dynamic variables (models/step._dynamic_env twin) -----------------
    def _env(self, stamp: float) -> Dict[str, float]:
        tw = self.last_twist if self.has_twist else np.zeros(6)
        at = self.spec.adaptive_threshold
        # ypr of current pose
        yaw = math.atan2(self.R[1, 0], self.R[0, 0])
        pitch = math.asin(min(1.0, max(-1.0, -self.R[2, 0])))
        roll = math.atan2(self.R[2, 1], self.R[2, 2])
        return {
            "vx": tw[0], "vy": tw[1], "vz": tw[2],
            "wx": tw[3], "wy": tw[4], "wz": tw[5],
            "robot_x": self.t[0], "robot_y": self.t[1], "robot_z": self.t[2],
            "robot_yaw": yaw, "robot_pitch": pitch, "robot_roll": roll,
            "ADAPTIVE_THRESHOLD_SIGMA": self.sigma if self.sigma != 0 else at.initial_sigma,
            "ICP_ITERATION": 0.0,
            "icp_iterations": self.last_iters,
            "SENSOR_TIME_OFFSET": 0.0,
            "twistCorrectionCount": self.twist_corr,
            "ESTIMATED_SENSOR_MAX_RANGE": self.est_range,
            "INSTANTANEOUS_SENSOR_MAX_RANGE": self.inst_range if self.inst_range > 0 else 20.0,
            "current_relative_timestamp": stamp - (self.first_time or stamp),
        }

    # -- one robust GN update on exact pairing blocks ------------------------
    # blocks: list of (kind, p_loc (N,3), q (N,3), nrm (N,3)|None, w_layer)
    def _gn_step(self, R, t, blocks, kernel_c, prior: NavEstimate):
        # MOLA_ORACLE_SOLVER_F32=1: degrade ONLY the normal-equation
        # assembly + solve to float32 (divergence attribution study —
        # compares against the default f64 oracle to isolate how much of
        # the engine-vs-oracle gap on a config is solver cancellation vs
        # pairing/capture differences).  Never set in the parity gates.
        dt = np.float32 if os.environ.get("MOLA_ORACLE_SOLVER_F32") == "1" else np.float64
        H = np.zeros((6, 6), dt)
        b = np.zeros(6, dt)
        c2 = kernel_c * kernel_c
        blocks = [
            (k, np.asarray(p, dt), np.asarray(q, dt),
             None if n is None else np.asarray(n, dt), w)
            for k, p, q, n, w in blocks
        ]
        R_s, t_s = np.asarray(R, dt), np.asarray(t, dt)
        for kind, p_loc, q_map, nrm, w_layer in blocks:
            if len(p_loc) == 0:
                continue
            tp = (p_loc @ R_s.T + t_s).astype(dt)
            K = np.zeros((len(tp), 3, 3))
            K[:, 0, 1], K[:, 0, 2] = -tp[:, 2], tp[:, 1]
            K[:, 1, 0], K[:, 1, 2] = tp[:, 2], -tp[:, 0]
            K[:, 2, 0], K[:, 2, 1] = -tp[:, 1], tp[:, 0]
            J3 = np.concatenate(
                [np.broadcast_to(np.eye(3), (len(tp), 3, 3)), -K], axis=2
            )
            if kind == "p2p":
                r = tp - q_map
                r2 = np.sum(r * r, axis=1)
                w = (c2 / (r2 + c2)) ** 2 * w_layer
                Jw = J3 * w[:, None, None]
                H += np.einsum("nij,nik->jk", Jw, J3)
                b += np.einsum("nij,ni->j", Jw, r)
            else:  # p2pl: scalar residual n . (Tp - q)
                r = np.sum(nrm * (tp - q_map), axis=1)
                J = np.einsum("ni,nij->nj", nrm, J3)
                w = (c2 / (r * r + c2)) ** 2 * w_layer
                Jw = J * w[:, None]
                H += np.einsum("ni,nj->ij", Jw, J)
                b += np.einsum("ni,n->i", Jw, r)
        if prior.valid or np.trace(prior.prior_info) > 0:
            Rr, tr = relative(prior.R, prior.t, R, t)
            rp = se3_log(Rr, tr)
            H = H + prior.prior_info
            b = b + prior.prior_info @ rp
        scale = np.trace(H) / 6.0 + 1.0
        Hd = H + 1e-8 * scale * np.eye(6)
        eps = -np.linalg.solve(Hd, b)
        dR, dt_ = se3_exp(eps)
        R2, t2 = compose(dR, dt_, R, t)
        return R2, t2, eps

    @staticmethod
    def _horn(blocks):
        """Closed-form weighted rigid alignment over the p2p pairings
        (Solver_Horn; mirrors ops/solver.py:solve_horn in f64)."""
        ps = [b[1] for b in blocks if b[0] == "p2p" and len(b[1])]
        qs = [b[2] for b in blocks if b[0] == "p2p" and len(b[1])]
        if not ps or sum(len(p) for p in ps) < 3:
            return None
        p = np.concatenate(ps)
        q = np.concatenate(qs)
        pc, qc = p.mean(axis=0), q.mean(axis=0)
        C = (p - pc).T @ (q - qc)
        U, _, Vt = np.linalg.svd(C.T)
        d = np.sign(np.linalg.det(U @ Vt))
        R = U @ np.diag([1.0, 1.0, d]) @ Vt
        return R, qc - R @ pc

    # -- exact pairing of every matcher at the current pose ------------------
    def _match_blocks(self, cfg, layers, R, t, env_it, it: int):
        """Returns (blocks, paired, n_local) mirroring ops/icp._matcher_blocks
        with exact (KD-tree over ALL targets) NN search."""
        from scipy.spatial import cKDTree

        blocks = []
        paired = 0.0
        n_local = 0.0
        for mc in cfg.matchers:
            c = layers[mc.local_layer]
            p_loc = c.xyz
            n_local += len(p_loc)
            if it < mc.run_from_iteration or (
                mc.run_up_to_iteration > 0 and it > mc.run_up_to_iteration
            ):
                continue
            thr = _f(mc.threshold(env_it))
            m = self.maps[mc.global_layer]
            q = p_loc @ R.T + t
            if mc.threshold_angular_deg > 0:
                thr = thr + np.linalg.norm(p_loc, axis=1) * math.sin(
                    math.radians(mc.threshold_angular_deg)
                )
            if mc.kind == "point2plane":
                if isinstance(m, ExactNdtMap):
                    mu, nrm, found = m.nearest_plane(q)
                    dpl = np.sum(nrm * (q - mu), axis=1)
                    plane_pt = q - dpl[:, None] * nrm
                else:  # point map: on-the-fly local plane fit (rgbd.yaml)
                    plane_pt, nrm, found = m.nearest_plane_fit(
                        q,
                        search_radius=mc.search_radius,
                        min_plane_points=mc.min_plane_points,
                        eigen_thr=mc.plane_eigen_threshold,
                    )
                    dpl = np.sum(nrm * (q - plane_pt), axis=1)
                pv = found & (dpl * dpl < thr * thr)
                blocks.append(("p2pl", p_loc[pv], plane_pt[pv], nrm[pv], mc.weight))
                paired += float(np.sum(pv))
                continue
            targets = m.match_targets()
            if len(targets) == 0:
                continue
            tree = cKDTree(targets)
            k = mc.pairings_per_point
            d, j = tree.query(q, k=k)
            if k == 1:
                pv = d <= thr
                if not mc.allow_match_already_matched:
                    # greedy in-order: lowest-index claimant keeps its global
                    # point, later claimants drop (ops/icp._one_to_one)
                    claimed: Dict[int, int] = {}
                    for i in np.nonzero(pv)[0]:
                        if j[i] in claimed:
                            pv[i] = False
                        else:
                            claimed[int(j[i])] = i
                blocks.append(
                    ("p2p", p_loc[pv], targets[j[pv]], None, mc.weight)
                )
                paired += float(np.sum(pv))
            else:
                pv2 = d <= (thr[:, None] if np.ndim(thr) else thr)
                for col in range(k):
                    sel = pv2[:, col]
                    blocks.append(
                        ("p2p", p_loc[sel], targets[j[sel, col]], None, mc.weight)
                    )
                paired += float(np.sum(pv2[:, 0]))
        return blocks, paired, n_local

    # -- full ICP with twist-reoptimization restarts ------------------------
    def _icp(self, layers, nav_est: NavEstimate, env, dt_scan: float):
        spec = self.spec
        cfg = spec.icp_with_vel if nav_est.valid else spec.icp_without_vel
        R = nav_est.R if nav_est.valid else self.R
        t = nav_est.t if nav_est.valid else self.t
        prior = nav_est if nav_est.valid else NavEstimate(
            np.eye(3), np.zeros(3), np.zeros(6), False, np.zeros((6, 6))
        )
        if spec.pin_se2:
            pin = np.zeros((6, 6))
            for i in (2, 3, 4):
                pin[i, i] = 1e6
            prior = NavEstimate(R, t, prior.twist, True, prior.prior_info + pin)
        last_kf_R, last_kf_t = self.R.copy(), self.t.copy()

        budget = cfg.max_iterations
        total_iters = 0
        corr = 0
        twist = nav_est.twist.copy()
        hook_on = cfg.hook_min_trans > 0 or cfg.hook_min_rot > 0
        max_corr = spec.optimize_twist_max_corrections if spec.optimize_twist else 0
        dsk = [op for op in spec.filter2 if isinstance(op, FG.DeskewOp)]
        horn_active = cfg.horn is not None

        while True:
            entry_R, entry_t = R.copy(), t.copy()
            hook_fired = False
            it = 0
            while it < budget:
                # ICP_ITERATION restarts per align() segment, matching the
                # engine (each hook re-entry is a fresh align call)
                env_it = dict(env)
                env_it["ICP_ITERATION"] = float(it)
                kernel_c = _f(cfg.kernel_param(env_it))
                blocks, _, _ = self._match_blocks(cfg, layers, R, t, env_it, it)
                R2, t2, _ = self._gn_step(R, t, blocks, kernel_c, prior)
                for _ in range(cfg.gn_inner_iterations - 1):
                    R2, t2, _ = self._gn_step(R2, t2, blocks, kernel_c, prior)
                if horn_active:
                    # coarse Horn stage until its correction is small
                    # (Solver_Horn runUntilTranslationCorrectionSmallerThan)
                    h = self._horn(blocks)
                    if h is not None:
                        R2, t2 = h
                        if (
                            float(np.linalg.norm(t2 - t))
                            < cfg.horn.run_until_translation_correction_smaller_than
                        ):
                            horn_active = False
                dtrans = float(np.linalg.norm(t2 - t))
                drot = float(np.linalg.norm(so3_log(R.T @ R2)))
                R, t = R2, t2
                it += 1
                if dtrans < cfg.min_abs_step_trans and drot < cfg.min_abs_step_rot:
                    break
                if hook_on:
                    ht = float(np.linalg.norm(t - entry_t))
                    hr = float(np.linalg.norm(so3_log(entry_R.T @ R)))
                    if ht > cfg.hook_min_trans or hr > cfg.hook_min_rot:
                        hook_fired = True
                        break
            total_iters += it
            budget -= it
            if (
                hook_fired
                and corr < max_corr
                and dt_scan > 0
                and budget > 0
                and dsk
            ):
                Rr, tr = relative(last_kf_R, last_kf_t, R, t)
                twist = np.concatenate([tr, so3_log(Rr)]) / max(dt_scan, 1e-6)
                env2 = dict(env)
                for i, k in enumerate(("vx", "vy", "vz", "wx", "wy", "wz")):
                    env2[k] = twist[i]
                for op in dsk:
                    c = layers[op.input]
                    layers[op.output] = (
                        Cloud(c.xyz.copy(), c.time.copy())
                        if op.skip
                        else _deskew(c, twist)
                    )
                corr += 1
                continue
            break

        # quality at final pose (paired ratio over all matchers, final
        # threshold — QualityEvaluator_PairedRatio, ops/icp.py:586)
        env_q = dict(env)
        env_q["ICP_ITERATION"] = float(total_iters)
        _, paired, n_local = self._match_blocks(
            cfg, layers, R, t, env_q, total_iters
        )
        quality = paired / max(n_local, 1.0)
        return R, t, quality, total_iters, corr, layers

    @staticmethod
    def _edge_mask(xyz, ring, valid, score_threshold, row_window_length):
        """Exact twin of ops/filters.range_image_edge_mask (LOAM-style
        row-window range-difference score on the ORGANIZED array order —
        pass the full un-compacted scan so roll-adjacency matches)."""
        r = np.linalg.norm(xyz, axis=1)
        score = np.zeros_like(r)
        in_row = np.ones_like(r, bool)
        w = max(1, row_window_length // 2)
        for j in range(1, w + 1):
            for sgn in (-1, 1):
                rj = np.roll(r, sgn * j)
                ring_ok = np.roll(ring, sgn * j) == ring
                vj = np.roll(valid, sgn * j) & ring_ok
                score += np.where(vj, np.abs(rj - r), 0.0)
                in_row &= vj
        rel = 100.0 * score / np.maximum(r, 1e-6)
        return valid & in_row & (rel > score_threshold)

    # -- the per-scan step ---------------------------------------------------
    def step(
        self,
        xyz: np.ndarray,
        times: np.ndarray,
        stamp: float,
        ring: Optional[np.ndarray] = None,
        valid: Optional[np.ndarray] = None,
    ) -> OracleOutput:
        """Process one scan.  For organized-scan generators (rgbd edges)
        pass the FULL array with ``ring`` + ``valid`` so row adjacency
        matches the device path; otherwise pass compacted points."""
        spec = self.spec
        xyz = np.asarray(xyz, np.float64)
        times = np.asarray(times, np.float64)
        edge_ops = [
            op
            for op in spec.generator_pipeline
            if isinstance(op, FG.EdgesFromRangeImageOp)
        ]
        gen_layers: Dict[str, Cloud] = {}
        if edge_ops:
            if ring is None:
                raise ValueError("organized-scan pipeline needs ring indices")
            v = (
                np.ones(len(xyz), bool)
                if valid is None
                else np.asarray(valid, bool)
            )
            for op in edge_ops:
                em = self._edge_mask(
                    xyz, np.asarray(ring), v, op.score_threshold, op.row_window_length
                )
                gen_layers[op.target_layer] = Cloud(xyz[em], times[em])
                if op.planes_target_layer:
                    pm = v & ~em
                    gen_layers[op.planes_target_layer] = Cloud(xyz[pm], times[pm])
        if valid is not None:
            xyz, times = xyz[valid], times[valid]
        if self.last_time is not None and stamp - self.last_time < spec.min_time_between_scans:
            out = OracleOutput(self.R, self.t, stamp, 0.0, 0, False, False)
            self.outputs.append(out)
            return out
        if self.first_time is None:
            self.first_time = stamp

        raw_radius = max(
            float(np.max(np.linalg.norm(xyz, axis=1))) if len(xyz) else 0.0,
            spec.absolute_minimum_sensor_range,
        )
        if self.est_range <= 0:
            self.est_range = raw_radius
        env = self._env(stamp)

        layers = {"raw": Cloud(xyz, times), **gen_layers}
        layers = apply_pipeline_exact(spec.adjust_pipeline, layers, env)
        layers = apply_pipeline_exact(spec.filter1, layers, env)
        layers = apply_pipeline_exact(spec.filter2, layers, env)

        icp_layer = layers.get(spec.icp_local_layer, layers["raw"])
        inst = max(
            float(np.max(np.linalg.norm(icp_layer.xyz, axis=1))) if len(icp_layer.xyz) else 0.0,
            spec.absolute_minimum_sensor_range,
        )
        a = spec.max_sensor_range_filter_coefficient
        first_ever = self.frame_idx == 0
        est_range = self.est_range if first_ever else a * self.est_range + (1 - a) * inst
        self.inst_range = inst

        nav_est = self.nav.estimate(stamp)
        dt_scan = (stamp - self.last_time) if self.last_time is not None else 0.0
        map_empty = not self.maps or all(m.is_empty() for m in self.maps.values())

        if map_empty:
            R, t, quality, iters, corr = self.R, self.t, 1.0, 0, 0
            layers_f = layers
            init_R, init_t = self.R, self.t
        else:
            env_icp = dict(env)
            env_icp["ESTIMATED_SENSOR_MAX_RANGE"] = est_range
            init_R = nav_est.R if nav_est.valid else self.R
            init_t = nav_est.t if nav_est.valid else self.t
            R, t, quality, iters, corr, layers_f = self._icp(
                dict(layers), nav_est, env_icp, dt_scan
            )

        accepted = quality >= spec.min_icp_goodness
        if accepted:
            self.R, self.t = R, t
            self.nav.fuse_pose(stamp, R, t)
            self.traj_len += 1
        else:
            self.nav.reset()

        # adaptive sigma (KISS-ICP; models/step.py stage 10 twin)
        at = spec.adaptive_threshold
        if at.enabled and not map_empty:
            Rr, tr = relative(init_R, init_t, R, t)
            theta = float(np.linalg.norm(so3_log(Rr)))
            model_err = float(np.linalg.norm(tr)) + 2.0 * est_range * math.sin(theta / 2.0)
            rot_err = (
                0.1 * float(np.linalg.norm(nav_est.twist[3:])) * est_range
                if nav_est.valid
                else 0.0
            )
            gain = min(max(at.kp * (1.0 - quality), 0.1), at.kp)
            sig0 = self.sigma if self.sigma != 0 else at.initial_sigma
            self.sigma = min(
                max(at.alpha * sig0 + (1 - at.alpha) * (model_err + rot_err) * gain, at.min_motion),
                at.maximum_sigma,
            )

        # KF decider + map update
        lmu = spec.local_map_updates
        env_kf = self._env(stamp)
        env_kf["ESTIMATED_SENSOR_MAX_RANGE"] = est_range
        if self.lm_kfs:
            if lmu.measure_from_last_kf_only:
                cand = [self.lm_kfs[-1]]
            else:
                cand = self.lm_kfs
            dmin, rmin = 1e18, 1e18
            for Rk, tk in cand:
                dmin = min(dmin, float(np.linalg.norm(self.t - tk)))
                rmin = min(rmin, float(np.linalg.norm(so3_log(Rk.T @ self.R))))
            min_t = _f(lmu.min_translation_between_keyframes(env_kf))
            min_r = _f(lmu.min_rotation_between_keyframes_deg(env_kf)) * math.pi / 180.0
            update_map = accepted and lmu.enabled and nav_est.valid and (
                dmin > min_t or rmin > min_r
            )
        else:
            update_map = True

        restart = (not accepted) and self.traj_len == 1
        if restart:
            self.traj_len = 0
            for m in self.maps.values():
                m.clear()
            self.lm_kfs.clear()
            update_map = False

        if update_map:
            if not self.maps or map_empty:
                for d in spec.map_layers:
                    vs = _f(d.voxel_size(env_kf))
                    if d.map_class == "NDT":
                        self.maps[d.name] = ExactNdtMap(
                            vs, d.max_eigen_ratio_for_planes
                        )
                    elif d.map_class == "CVoxelMap":
                        self.maps[d.name] = ExactOccupancyMap(
                            vs,
                            prob_hit=d.prob_hit,
                            prob_miss=d.prob_miss,
                            clamp_min=d.clamp_min,
                            clamp_max=d.clamp_max,
                            occupied_threshold=d.occupied_threshold,
                            ray_trace=d.ray_trace_free_space,
                        )
                    else:
                        self.maps[d.name] = ExactVoxelMap(vs, d.points_per_voxel)
            for opi in spec.map_inserts:
                src = layers_f.get(opi.input_layer, icp_layer)
                m = self.maps[opi.target_map_layer]
                pts_g = src.xyz @ self.R.T + self.t
                if isinstance(m, ExactOccupancyMap):
                    m.insert(pts_g, self.t)
                else:
                    m.insert(pts_g)
            self.removal_counter += 1
            for d in spec.map_layers:
                prune = _f(d.remove_voxels_farther_than(env_kf))
                self.maps[d.name].prune_farther_than(self.t, prune)
            if not map_empty:
                self.lm_kfs.append((self.R.copy(), self.t.copy()))
            max_keep = _f(lmu.max_distance_to_keep_keyframes(env_kf))
            if max_keep > 0 and self.removal_counter >= lmu.check_for_removal_every_n:
                self.lm_kfs = [
                    (Rk, tk)
                    for Rk, tk in self.lm_kfs
                    if np.linalg.norm(tk - self.t) <= max_keep
                ]
                self.removal_counter = 0

        self.est_range = est_range
        self.last_time = stamp
        self.frame_idx += 1
        self.last_iters = float(iters)
        self.twist_corr = float(corr)
        self.last_twist = nav_est.twist
        self.has_twist = bool(nav_est.valid)
        out = OracleOutput(self.R.copy(), self.t.copy(), stamp, quality, iters, accepted, update_map)
        self.outputs.append(out)
        return out
