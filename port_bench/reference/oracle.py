"""The plain reference: float64 LiDAR odometry on the host, in numpy.

A frozen copy of the program's float64 oracle (``oracle.py`` and
``utils/exact_filters.py`` of the port) for the pipelines the benchmark
runs, reading the YAML through :mod:`.pipeline` instead of the program's
compiled spec:

* float64 everywhere,
* an unbounded voxel map (a dict of voxel -> points, the per-voxel cap
  only: no slot collisions, no fixed capacity, no insert budget),
* exact nearest neighbours (a KD-tree over every map point),
* exact Gauss-Newton with a fresh pairing every iteration,
* the filter graph interpreted op by op.

It follows one instance through its scans from an empty map, as the
program's fleet step follows each of its instances.

The control (:func:`.pipeline.without_registration`) is this reference
with its ICP given no iterations, breaking the registration the
configuration states.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from port_bench.reference import pipeline as P


# --------------------------------------------------------------------------
# float64 SE(3)
# --------------------------------------------------------------------------


def _hat(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float64)


def so3_exp(phi: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(phi))
    K = _hat(phi)
    if th < 1e-12:
        return np.eye(3) + K + 0.5 * K @ K
    return np.eye(3) + (math.sin(th) / th) * K + ((1.0 - math.cos(th)) / (th * th)) * (K @ K)


def so3_log(R: np.ndarray) -> np.ndarray:
    c = min(1.0, max(-1.0, (np.trace(R) - 1.0) / 2.0))
    th = math.acos(c)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-9:
        return 0.5 * w
    return (th / (2.0 * math.sin(th))) * w


def se3_exp(xi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """xi = [rho(3), phi(3)] -> (R, t)."""
    rho, phi = xi[:3], xi[3:]
    th = float(np.linalg.norm(phi))
    K = _hat(phi)
    if th < 1e-9:
        V = np.eye(3) + 0.5 * K + (1.0 / 6.0) * K @ K
    else:
        V = np.eye(3) + ((1.0 - math.cos(th)) / (th * th)) * K + ((th - math.sin(th)) / th**3) * (K @ K)
    return so3_exp(phi), V @ rho


def se3_log(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    phi = so3_log(R)
    th = float(np.linalg.norm(phi))
    K = _hat(phi)
    if th < 1e-9:
        Vinv = np.eye(3) - 0.5 * K + (1.0 / 12.0) * K @ K
    else:
        half = th / 2.0
        Vinv = np.eye(3) - 0.5 * K + ((1.0 - half * math.cos(half) / math.sin(half)) / (th * th)) * (K @ K)
    return np.concatenate([Vinv @ t, phi])


def compose(Ra, ta, Rb, tb):
    return Ra @ Rb, Ra @ tb + ta


def relative(Ra, ta, Rb, tb):
    """a^-1 b."""
    return Ra.T @ Rb, Ra.T @ (tb - ta)


# --------------------------------------------------------------------------
# the filter graph, exactly
# --------------------------------------------------------------------------


@dataclass
class Cloud:
    xyz: np.ndarray  # (N, 3)
    time: np.ndarray  # (N,)


def _decimate_first_point(pts: np.ndarray, times: np.ndarray, res: float):
    """FirstPoint voxel decimation: the first input point of each voxel."""
    keys = np.floor(pts / res).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    keep = np.zeros(len(pts), bool)
    keep[first] = True
    return pts[keep], times[keep]


def _deskew(c: Cloud, twist: np.ndarray) -> Cloud:
    """Per-point ``R(w*dt) p + v*dt`` (Rodrigues)."""
    v, w = twist[:3], twist[3:]
    dt = c.time[:, None]
    phi = w[None, :] * dt
    th = np.linalg.norm(phi, axis=1, keepdims=True)
    k = phi / np.where(th < 1e-12, 1.0, th)
    p = c.xyz
    kdp = np.sum(k * p, axis=1, keepdims=True)
    s, cth = np.sin(th), np.cos(th)
    rot = p * cth + np.cross(k, p) * s + k * kdp * (1.0 - cth)
    return Cloud(np.where(th < 1e-12, p, rot) + v[None, :] * dt, c.time)


def apply_filters(ops, layers: Dict[str, Cloud], env: Dict[str, float]) -> Dict[str, Cloud]:
    """The pipeline's ops in order."""
    layers = dict(layers)
    for op in ops:
        if isinstance(op, P.AdjustTimestampsOp):
            c = layers.get(op.layer)
            if c is None or len(c.time) == 0:
                continue
            tmin, tmax = float(c.time.min()), float(c.time.max())
            if op.method == "MiddleIsZero":
                shift = 0.5 * (tmin + tmax)
            elif op.method == "EarliestIsZero":
                shift = tmin
            else:
                raise ValueError(op.method)
            layers[op.layer] = Cloud(c.xyz, c.time - shift + op.time_offset(env))
        elif isinstance(op, P.DecimateOp):
            c = layers[op.input]
            if len(c.xyz) < op.min_input_points:
                layers[op.output] = Cloud(c.xyz.copy(), c.time.copy())
            elif op.method == "FirstPoint":
                layers[op.output] = Cloud(*_decimate_first_point(c.xyz, c.time, op.resolution(env)))
            else:
                raise ValueError(f"the reference does not decimate by {op.method}")
        elif isinstance(op, P.RangeOp):
            c = layers[op.input]
            r = np.linalg.norm(c.xyz, axis=1)
            m = (r >= op.range_min(env)) & (r <= op.range_max(env))
            if op.between:
                layers[op.between] = Cloud(c.xyz[m], c.time[m])
            if op.outside:
                layers[op.outside] = Cloud(c.xyz[~m], c.time[~m])
        elif isinstance(op, P.BBoxOp):
            c = layers[op.input]
            mn = np.array([e(env) for e in op.bb_min])
            mx = np.array([e(env) for e in op.bb_max])
            m = np.all((c.xyz >= mn) & (c.xyz <= mx), axis=1)
            if op.inside:
                layers[op.inside] = Cloud(c.xyz[m], c.time[m])
            if op.outside:
                layers[op.outside] = Cloud(c.xyz[~m], c.time[~m])
        elif isinstance(op, P.DeskewOp):
            c = layers[op.input]
            if op.skip:
                layers[op.output] = Cloud(c.xyz.copy(), c.time.copy())
            else:
                layers[op.output] = _deskew(c, np.array([float(env[v]) for v in op.twist_vars]))
        elif isinstance(op, P.DeleteOp):
            for name in op.layers_to_remove:
                layers.pop(name, None)
    return layers


# --------------------------------------------------------------------------
# the unbounded voxel map and the velocity model
# --------------------------------------------------------------------------


class VoxelMap:
    """Voxel -> points, at most ``cap`` per voxel, first come first kept."""

    def __init__(self, voxel_size: float, cap: int):
        self.voxel_size = float(voxel_size)
        self.cap = int(cap)
        self.vox: Dict[Tuple[int, int, int], List[np.ndarray]] = {}
        self._pts = self._tree = None

    def is_empty(self) -> bool:
        return not self.vox

    def insert(self, pts: np.ndarray) -> None:
        keys = np.floor(pts / self.voxel_size).astype(np.int64)
        for p, k in zip(pts, map(tuple, keys)):
            lst = self.vox.get(k)
            if lst is None:
                self.vox[k] = [p]
            elif len(lst) < self.cap:
                lst.append(p)
        self._pts = self._tree = None

    def prune_farther_than(self, center: np.ndarray, dist: float) -> None:
        if dist <= 0:
            return
        vs = self.voxel_size
        drop = [k for k in self.vox if np.max(np.abs((np.asarray(k, np.float64) + 0.5) * vs - center)) > dist]
        for k in drop:
            del self.vox[k]
        if drop:
            self._pts = self._tree = None

    def points(self) -> np.ndarray:
        if self._pts is None:
            self._pts = np.concatenate([np.asarray(v) for v in self.vox.values()]) if self.vox else np.zeros((0, 3))
        return self._pts

    def tree(self):
        """A KD-tree over :meth:`points`, kept until the map changes."""
        from scipy.spatial import cKDTree

        if self._tree is None:
            self._tree = cKDTree(self.points())
        return self._tree

    def clear(self) -> None:
        self.vox.clear()
        self._pts = self._tree = None


@dataclass
class NavEstimate:
    R: np.ndarray
    t: np.ndarray
    twist: np.ndarray
    valid: bool
    prior_info: np.ndarray  # (6, 6)


class NavState:
    """The velocity model: recency-weighted finite-difference twists over a
    window of the last accepted poses."""

    WINDOW = 8

    def __init__(self, cfg: P.NavState):
        self.cfg = cfg
        self.entries: List[Tuple[float, np.ndarray, np.ndarray]] = []

    def reset(self):
        self.entries.clear()

    def fuse_pose(self, t: float, R: np.ndarray, tr: np.ndarray):
        self.entries.append((t, R.copy(), tr.copy()))
        if len(self.entries) > self.WINDOW:
            self.entries.pop(0)

    def estimate(self, t_query: float) -> NavEstimate:
        cfg = self.cfg
        if not self.entries:
            return NavEstimate(np.eye(3), np.zeros(3), np.zeros(6), False, np.zeros((6, 6)))
        tw_init = np.asarray(cfg.initial_twist, np.float64)
        horizon_win = cfg.sliding_window_length + cfg.max_time_to_use_velocity_model
        pairs = []
        for (t0, R0, p0), (t1, R1, p1) in zip(self.entries[:-1], self.entries[1:]):
            if (t_query - t0 > horizon_win) or (t_query - t1 > horizon_win):
                continue
            dt = t1 - t0
            if dt <= 1e-6:
                continue
            xi = se3_log(*relative(R0, p0, R1, p1)) / dt
            tau = max(cfg.sliding_window_length / 4.0, 1e-3)
            pairs.append((xi, dt * dt * math.exp(-max(t_query - t1, 0.0) / tau)))
        sl = max(cfg.initial_twist_sigma_lin, 1e-6)
        sa = max(cfg.initial_twist_sigma_ang, 1e-6)
        w0 = np.array([1 / sl**2] * 3 + [1 / sa**2] * 3)
        robust = cfg.robust_param
        twist = tw_init
        if pairs:
            xis = np.stack([xi for xi, _ in pairs])
            ws = np.array([w for _, w in pairs])
            wn = ws / ws.sum()
            rw = np.ones(len(pairs))
            for _ in range(3 if robust > 0 else 1):
                twist = ((xis * (wn * rw)[:, None]).sum(axis=0) + w0 * tw_init) / (float(np.sum(wn * rw)) + w0)
                if robust > 0:
                    rw = (robust**2 / (np.sum((xis - twist) ** 2, axis=1) + robust**2)) ** 2
            rmse = math.sqrt(float(np.sum(wn * np.sum((xis - twist) ** 2, axis=1))))
            if cfg.max_rmse > 0 and rmse > cfg.max_rmse:
                twist = tw_init
        t_last, R_last, p_last = self.entries[-1]
        horizon = t_query - t_last
        if not 0 <= horizon <= cfg.max_time_to_use_velocity_model:
            return NavEstimate(R_last, p_last, np.zeros(6), False, np.zeros((6, 6)))
        Rq, tq = compose(R_last, p_last, *se3_exp(twist * horizon))
        sp = cfg.sigma_integrator_position + 0.5 * cfg.sigma_random_walk_acceleration_linear * horizon**2
        so = cfg.sigma_integrator_orientation + 0.5 * cfg.sigma_random_walk_acceleration_angular * horizon**2
        return NavEstimate(Rq, tq, twist, True, np.diag(np.array([1 / sp**2] * 3 + [1 / so**2] * 3)))


# --------------------------------------------------------------------------
# the odometry
# --------------------------------------------------------------------------


@dataclass
class Output:
    R: np.ndarray
    t: np.ndarray
    quality: float
    iterations: int
    accepted: bool
    kf_local: bool
    n_icp_layer: int
    n_map_layer: int


class Odometry:
    """One instance of the pipeline, scan by scan."""

    def __init__(self, pipe: P.Pipeline):
        self.p = pipe
        self.R, self.t = np.eye(3), np.zeros(3)
        self.sigma = self.est_range = self.inst_range = 0.0
        self.last_time: Optional[float] = None
        self.first_time: Optional[float] = None
        self.frame_idx = self.traj_len = self.removal_counter = 0
        self.last_iters = self.twist_corr = 0.0
        self.last_twist = np.zeros(6)
        self.has_twist = False
        self.nav = NavState(pipe.navstate)
        self.maps: Dict[str, VoxelMap] = {}
        self.lm_kfs: List[Tuple[np.ndarray, np.ndarray]] = []

    def _env(self, stamp: float) -> Dict[str, float]:
        tw = self.last_twist if self.has_twist else np.zeros(6)
        R = self.R
        return {
            "vx": tw[0], "vy": tw[1], "vz": tw[2], "wx": tw[3], "wy": tw[4], "wz": tw[5],
            "robot_x": self.t[0], "robot_y": self.t[1], "robot_z": self.t[2],
            "robot_yaw": math.atan2(R[1, 0], R[0, 0]), "robot_pitch": math.asin(min(1.0, max(-1.0, -R[2, 0]))),
            "robot_roll": math.atan2(R[2, 1], R[2, 2]),
            "ADAPTIVE_THRESHOLD_SIGMA": self.sigma if self.sigma != 0 else self.p.adaptive_threshold.initial_sigma,
            "ICP_ITERATION": 0.0, "icp_iterations": self.last_iters, "SENSOR_TIME_OFFSET": 0.0,
            "twistCorrectionCount": self.twist_corr, "ESTIMATED_SENSOR_MAX_RANGE": self.est_range,
            "INSTANTANEOUS_SENSOR_MAX_RANGE": self.inst_range if self.inst_range > 0 else 20.0,
            "current_relative_timestamp": stamp - (self.first_time or stamp),
        }

    def _gn_step(self, R, t, blocks, kernel_c, prior: NavEstimate):
        """One robust (Geman-McClure) Gauss-Newton update over the pairings."""
        dt = np.float64
        H = np.zeros((6, 6), dt)
        b = np.zeros(6, dt)
        c2 = kernel_c * kernel_c
        R_s, t_s = np.asarray(R, dt), np.asarray(t, dt)
        for p_loc, q_map, w_layer in blocks:
            if len(p_loc) == 0:
                continue
            p_loc, q_map = np.asarray(p_loc, dt), np.asarray(q_map, dt)
            tp = (p_loc @ R_s.T + t_s).astype(dt)
            K = np.zeros((len(tp), 3, 3), dt)
            K[:, 0, 1], K[:, 0, 2] = -tp[:, 2], tp[:, 1]
            K[:, 1, 0], K[:, 1, 2] = tp[:, 2], -tp[:, 0]
            K[:, 2, 0], K[:, 2, 1] = -tp[:, 1], tp[:, 0]
            J3 = np.concatenate([np.broadcast_to(np.eye(3, dtype=dt), (len(tp), 3, 3)), -K], axis=2)
            r = tp - q_map
            w = ((c2 / (np.sum(r * r, axis=1) + c2)) ** 2 * w_layer).astype(dt)
            Jw = J3 * w[:, None, None]
            H += np.einsum("nij,nik->jk", Jw, J3)
            b += np.einsum("nij,ni->j", Jw, r)
        if prior.valid or np.trace(prior.prior_info) > 0:
            rp = se3_log(*relative(prior.R, prior.t, R, t))
            H = H + prior.prior_info
            b = b + prior.prior_info @ rp
        scale = np.trace(H) / 6.0 + 1.0
        eps = -np.linalg.solve(H + 1e-8 * scale * np.eye(6), b)
        R2, t2 = compose(*se3_exp(np.asarray(eps, np.float64)), R, t)
        return R2, t2

    def _match_blocks(self, layers, R, t, env_it, it: int):
        """Exact nearest-neighbour pairings of every matcher at ``(R, t)``:
        ``(blocks, paired, n_local)``."""
        blocks, paired, n_local = [], 0.0, 0.0
        for mc in self.p.icp.matchers:
            p_loc = layers[mc.local_layer].xyz
            n_local += len(p_loc)
            if it < mc.run_from_iteration or (mc.run_up_to_iteration > 0 and it > mc.run_up_to_iteration):
                continue
            thr = mc.threshold(env_it)
            if mc.threshold_angular_deg > 0:
                thr = thr + np.linalg.norm(p_loc, axis=1) * math.sin(math.radians(mc.threshold_angular_deg))
            m = self.maps[mc.global_layer]
            targets = m.points()
            if len(targets) == 0:
                continue
            d, j = m.tree().query(p_loc @ R.T + t, k=1)
            pv = d <= thr
            if not mc.allow_match_already_matched:
                claimed: Dict[int, int] = {}
                for i in np.nonzero(pv)[0]:
                    if j[i] in claimed:
                        pv[i] = False
                    else:
                        claimed[int(j[i])] = i
            blocks.append((p_loc[pv], targets[j[pv]], mc.weight))
            paired += float(np.sum(pv))
        return blocks, paired, n_local

    def _icp(self, layers, nav_est: NavEstimate, env, dt_scan: float):
        """ICP with the twist re-estimation restarts (the hook)."""
        p, icp = self.p, self.p.icp
        R = nav_est.R if nav_est.valid else self.R
        t = nav_est.t if nav_est.valid else self.t
        prior = nav_est if nav_est.valid else NavEstimate(np.eye(3), np.zeros(3), np.zeros(6), False,
                                                          np.zeros((6, 6)))
        last_kf_R, last_kf_t = self.R.copy(), self.t.copy()
        budget, total_iters, corr = icp.max_iterations, 0, 0
        hook_on = icp.hook_min_trans > 0 or icp.hook_min_rot > 0
        max_corr = p.optimize_twist_max_corrections if p.optimize_twist else 0
        dsk = [op for op in p.filter2 if isinstance(op, P.DeskewOp)]
        while True:
            entry_R, entry_t = R.copy(), t.copy()
            hook_fired, it = False, 0
            while it < budget:
                env_it = dict(env, ICP_ITERATION=float(it))
                kernel_c = icp.kernel_param(env_it)
                blocks, _, _ = self._match_blocks(layers, R, t, env_it, it)
                R2, t2 = self._gn_step(R, t, blocks, kernel_c, prior)
                for _ in range(icp.gn_inner_iterations - 1):
                    R2, t2 = self._gn_step(R2, t2, blocks, kernel_c, prior)
                dtrans = float(np.linalg.norm(t2 - t))
                drot = float(np.linalg.norm(so3_log(R.T @ R2)))
                R, t = R2, t2
                it += 1
                if dtrans < icp.min_abs_step_trans and drot < icp.min_abs_step_rot:
                    break
                if hook_on and (float(np.linalg.norm(t - entry_t)) > icp.hook_min_trans
                                or float(np.linalg.norm(so3_log(entry_R.T @ R))) > icp.hook_min_rot):
                    hook_fired = True
                    break
            total_iters += it
            budget -= it
            if hook_fired and corr < max_corr and dt_scan > 0 and budget > 0 and dsk:
                Rr, tr = relative(last_kf_R, last_kf_t, R, t)
                twist = np.concatenate([tr, so3_log(Rr)]) / max(dt_scan, 1e-6)
                for op in dsk:
                    c = layers[op.input]
                    if op.skip:
                        layers[op.output] = Cloud(c.xyz.copy(), c.time.copy())
                    else:
                        layers[op.output] = _deskew(c, twist)
                corr += 1
                continue
            break
        env_q = dict(env, ICP_ITERATION=float(total_iters))
        _, paired, n_local = self._match_blocks(layers, R, t, env_q, total_iters)
        return R, t, paired / max(n_local, 1.0), total_iters, corr, layers

    def step(self, xyz: np.ndarray, times: np.ndarray, stamp: float) -> Output:
        """Process one scan of valid points in the sensor frame."""
        p = self.p
        xyz = np.asarray(xyz, np.float64)
        times = np.asarray(times, np.float64)
        if self.last_time is not None and stamp - self.last_time < p.min_time_between_scans:
            return Output(self.R.copy(), self.t.copy(), 0.0, 0, False, False, 0, 0)
        if self.first_time is None:
            self.first_time = stamp
        raw_radius = max(float(np.max(np.linalg.norm(xyz, axis=1))) if len(xyz) else 0.0,
                         p.absolute_minimum_sensor_range)
        if self.est_range <= 0:
            self.est_range = raw_radius
        env = self._env(stamp)
        layers = {"raw": Cloud(xyz, times)}
        for ops in (p.adjust, p.filter1, p.filter2):
            layers = apply_filters(ops, layers, env)
        icp_layer = layers.get(p.icp_local_layer, layers["raw"])
        map_layer = layers.get(p.map_inserts[0].input_layer, icp_layer) if p.map_inserts else icp_layer
        n_icp, n_map = len(icp_layer.xyz), len(map_layer.xyz)
        inst = max(float(np.max(np.linalg.norm(icp_layer.xyz, axis=1))) if len(icp_layer.xyz) else 0.0,
                   p.absolute_minimum_sensor_range)
        a = p.max_sensor_range_filter_coefficient
        est_range = self.est_range if self.frame_idx == 0 else a * self.est_range + (1 - a) * inst
        self.inst_range = inst
        nav_est = self.nav.estimate(stamp)
        dt_scan = (stamp - self.last_time) if self.last_time is not None else 0.0
        map_empty = not self.maps or all(m.is_empty() for m in self.maps.values())
        if map_empty:
            R, t, quality, iters, corr = self.R, self.t, 1.0, 0, 0
            layers_f, init_R, init_t = layers, self.R, self.t
        else:
            env_icp = dict(env, ESTIMATED_SENSOR_MAX_RANGE=est_range)
            init_R = nav_est.R if nav_est.valid else self.R
            init_t = nav_est.t if nav_est.valid else self.t
            R, t, quality, iters, corr, layers_f = self._icp(dict(layers), nav_est, env_icp, dt_scan)

        accepted = quality >= p.min_icp_goodness
        if accepted:
            self.R, self.t = R, t
            self.nav.fuse_pose(stamp, R, t)
            self.traj_len += 1
        else:
            self.nav.reset()

        at = p.adaptive_threshold
        if at.enabled and not map_empty:
            Rr, tr = relative(init_R, init_t, R, t)
            theta = float(np.linalg.norm(so3_log(Rr)))
            model_err = float(np.linalg.norm(tr)) + 2.0 * est_range * math.sin(theta / 2.0)
            rot_err = 0.1 * float(np.linalg.norm(nav_est.twist[3:])) * est_range if nav_est.valid else 0.0
            gain = min(max(at.kp * (1.0 - quality), 0.1), at.kp)
            sig0 = self.sigma if self.sigma != 0 else at.initial_sigma
            self.sigma = min(max(at.alpha * sig0 + (1 - at.alpha) * (model_err + rot_err) * gain, at.min_motion),
                             at.maximum_sigma)

        lmu = p.local_map_updates
        env_kf = dict(self._env(stamp), ESTIMATED_SENSOR_MAX_RANGE=est_range)
        if self.lm_kfs:
            cand = [self.lm_kfs[-1]] if lmu.measure_from_last_kf_only else self.lm_kfs
            dmin = min(float(np.linalg.norm(self.t - tk)) for _, tk in cand)
            rmin = min(float(np.linalg.norm(so3_log(Rk.T @ self.R))) for Rk, _ in cand)
            update_map = accepted and lmu.enabled and nav_est.valid and (
                dmin > lmu.min_translation_between_keyframes(env_kf)
                or rmin > lmu.min_rotation_between_keyframes_deg(env_kf) * math.pi / 180.0)
        else:
            update_map = True

        if not accepted and self.traj_len == 1:  # a bad first ICP restarts the map
            self.traj_len = 0
            for m in self.maps.values():
                m.clear()
            self.lm_kfs.clear()
            update_map = False

        if update_map:
            if not self.maps or map_empty:
                self.maps = {d.name: VoxelMap(d.voxel_size(env_kf), d.points_per_voxel) for d in p.map_layers}
            for op in p.map_inserts:
                src = layers_f.get(op.input_layer, icp_layer)
                self.maps[op.target_map_layer].insert(src.xyz @ self.R.T + self.t)
            self.removal_counter += 1
            for d in p.map_layers:
                self.maps[d.name].prune_farther_than(self.t, d.remove_voxels_farther_than(env_kf))
            if not map_empty:
                self.lm_kfs.append((self.R.copy(), self.t.copy()))
            max_keep = lmu.max_distance_to_keep_keyframes(env_kf)
            if max_keep > 0 and self.removal_counter >= lmu.check_for_removal_every_n:
                self.lm_kfs = [(Rk, tk) for Rk, tk in self.lm_kfs if np.linalg.norm(tk - self.t) <= max_keep]
                self.removal_counter = 0

        self.est_range = est_range
        self.last_time = stamp
        self.frame_idx += 1
        self.last_iters = float(iters)
        self.twist_corr = float(corr)
        self.last_twist = nav_est.twist
        self.has_twist = bool(nav_est.valid)
        return Output(self.R.copy(), self.t.copy(), quality, iters, accepted, update_map, n_icp, n_map)


def run_sequence(yaml_path: str, scans, stamps, registration: bool = True) -> List[Output]:
    """One instance over its scans: ``scans`` a list of ``(xyz, times)`` of
    valid points; returns each scan's output.  ``registration=False`` runs
    the control (:func:`.pipeline.without_registration`)."""
    pipe = P.read(yaml_path)
    odo = Odometry(pipe if registration else P.without_registration(pipe))
    return [odo.step(x, t, float(s)) for (x, t), s in zip(scans, stamps)]
