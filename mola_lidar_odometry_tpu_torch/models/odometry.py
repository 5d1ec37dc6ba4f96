"""Host-side odometry orchestrator — the public ``LidarOdometry`` API.

Port of ``mola_lidar_odometry_tpu/models/odometry.py``: the thin host
wrapper around the scan step, mirroring the reference module's public
surface (module/include/mola_lidar_odometry/LidarOdometry.h:72-625):
``from_yaml_file``/``from_yaml_text``, ``on_lidar_scan`` (the push entry
point, cf. ``onNewObservation``), ``estimated_trajectory()``,
``reconstructed_map()`` (simple-map), ``reset()``, the active flag, and the
trajectory, simple-map, local-map and debug-trace writers.  GNSS
observations are ring-buffered and attached to simple-map keyframes by
timestamp proximity (reference LidarOdometry.cpp:1221-1235, 1392-1414).

The step is ``models/step.py::make_step`` on a one-instance carry (the
fleet's leading dimension is 1).  Per scan the host makes one copy to the
card (the padded scan, packed into one flat buffer, from pinned memory on
CUDA) and one copy back (every field of the step's output, packed into one
float64 tensor); everything the host does with the output reads that numpy
copy.  The output ``on_lidar_scan`` returns is that copy: a ``StepOutput``
of numpy values without the fleet dimension.

With ``MP2P_ICP_GENERATE_DEBUG_FILES=1`` every
``MP2P_ICP_LOG_FILES_DECIMATION``-th scan's align is first replayed on the
pre-step carry and written as an ICP log (``utils/icp_log.py``).

Entry points run on the card: ``device="cuda"`` is the default, and without
a card the constructor raises; ``device="cpu"`` runs the plain twins of the
kernels on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from mola_lidar_odometry_tpu_torch.models import navstate as ns, step as step_mod
from mola_lidar_odometry_tpu_torch.models.spec import OdometrySpec, spec_from_yaml
from mola_lidar_odometry_tpu_torch.models.step import Carry, Scan, StepOutput
from mola_lidar_odometry_tpu_torch.ops import maps as maps_ops, se3
from mola_lidar_odometry_tpu_torch.utils import serialization, tum
from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file, load_yaml_text
from mola_lidar_odometry_tpu_torch.utils.profiler import Profiler, use as use_profiler

_log = logging.getLogger("mola_lidar_odometry_tpu_torch")


@dataclass
class SimpleMapKeyframe:
    """A simple-map entry: pose + (optionally) the raw observation.

    ``metadata`` mirrors the reference's per-KF YAML metadata observation
    (frame bounding box etc., LidarOdometry.cpp:1244-1268)."""

    stamp: float
    t: np.ndarray  # (3,)
    quat_xyzw: np.ndarray  # (4,)
    twist: np.ndarray  # (6,)
    scan_xyz: Optional[np.ndarray] = None  # None for non-KF pose-only entries
    scan_path: Optional[str] = None  # set when externalized (lazy-load)
    gnss: Optional[dict] = None
    metadata: Optional[dict] = None


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device with no card raises instead of
    carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is visible: pass device="cpu" to run on the CPU')
    return dev


def output_to_host(out: StepOutput) -> StepOutput:
    """Copy every field of a one-instance step output to the host in ONE
    transfer (all fields packed into one float64 tensor: f32 values and
    int32 counts are exact in it) and unpack it into numpy values without
    the fleet dimension."""
    flat = torch.cat([f.reshape(-1).to(torch.float64) for f in out]).cpu().numpy()
    vals, k = [], 0
    for f in out:
        n = f.numel()
        dtype = {torch.bool: np.bool_, torch.int32: np.int32}.get(f.dtype, np.float32)
        vals.append(flat[k : k + n].astype(dtype).reshape(f.shape[1:]))
        k += n
    return StepOutput(*vals)


class LidarOdometry:
    """LiDAR odometry instance (one vehicle; see ``parallel/`` for fleets)."""

    def __init__(self, spec: OdometrySpec, device="cuda"):
        self.device = resolve_device(device)
        self.spec = spec
        self.profiler = Profiler(enabled=True)
        # the step is built at the first scan when pin_se2 is None (auto):
        # the reference pins z/pitch/roll whenever the incoming observation
        # IS a 2D scan (LidarOdometry.cpp:863-876)
        self._step = None
        if spec.pin_se2 is not None:
            self._step = step_mod.make_step(spec)
        self._auto_cfg = None
        self.reset()
        self.active = spec.start_active
        self._label_regexes = [re.compile(s) for s in spec.lidar_sensor_labels]
        # ICP debug logs (.icplog analogue), enabled like the reference via
        # MP2P_ICP_GENERATE_DEBUG_FILES=1 (pipelines/lidar3d-default.yaml:177)
        self._icp_log = None
        if os.environ.get("MP2P_ICP_GENERATE_DEBUG_FILES", "0") == "1":
            from mola_lidar_odometry_tpu_torch.utils.icp_log import IcpLogWriter

            self._icp_log = IcpLogWriter(decimation=int(os.environ.get("MP2P_ICP_LOG_FILES_DECIMATION", 10)))
        # session preload (reference LidarOdometry.cpp:465-476; YAML
        # load_existing_local_map / load_existing_simple_map)
        self._closed = False
        if spec.local_map_updates.load_existing_local_map:
            self.load_local_map(spec.local_map_updates.load_existing_local_map)
        if spec.simplemap.load_existing_simple_map:
            self.simplemap = serialization.load_simplemap(spec.simplemap.load_existing_simple_map)

    def close(self) -> None:
        """Flush configured outputs (reference destructor behavior,
        LidarOdometry.cpp:84-111: save trajectory / simplemap / traces at
        exit when the YAML asked for them).  Idempotent."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        if self.spec.save_trajectory and self.trajectory:
            self.save_trajectory_tum(self.spec.trajectory_output_file)
        if self.spec.simplemap.generate and self.simplemap and self.spec.simplemap.save_final_map_to_file:
            self.save_simplemap(self.spec.simplemap.save_final_map_to_file)
        if self.spec.debug_traces_save and self.traces:
            self.save_debug_traces(self.spec.debug_traces_file)

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self.close()
        except Exception:
            pass

    # -- construction ------------------------------------------------------
    @staticmethod
    def _build(cfg, overrides, device) -> "LidarOdometry":
        # capacity auto-sizing (utils/capacity.py): on unless the caller
        # pinned a capacity (the port's spec reads no environment knobs)
        auto = overrides.pop("auto_capacity", None)
        if auto is None:
            auto = not ({"raw_capacity", "map_slots", "layer_capacities"} & overrides.keys())
        lo = LidarOdometry(spec_from_yaml(cfg, **overrides), device=device)
        if auto:
            lo._auto_cfg = (cfg, dict(overrides))
            lo._step = None  # sizes resolve on the first scan
        return lo

    @staticmethod
    def from_yaml_file(path: Union[str, Path], env=None, device="cuda", **overrides) -> "LidarOdometry":
        return LidarOdometry._build(load_yaml_file(path, env=env), overrides, device)

    @staticmethod
    def from_yaml_text(text: str, env=None, device="cuda", **overrides) -> "LidarOdometry":
        return LidarOdometry._build(load_yaml_text(text, env=env), overrides, device)

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        """Re-initialize all state from the spec (reference ``reset()``)."""
        self.carry: Carry = step_mod.init_carry(self.spec, 1, self.device)
        self.trajectory: List[Dict[str, Any]] = []  # accepted poses
        self.simplemap: List[SimpleMapKeyframe] = []
        self.traces: List[Dict[str, float]] = []
        self._gnss_buffer: List[dict] = []  # last N GNSS observations
        self._imu_buffer: List[dict] = []
        self._last_odom = None  # previous wheel-odometry (R, t)
        # publisher callbacks (the mola_kernel advertise* interfaces,
        # reference LidarOdometry.cpp:2079-2149): localization every scan,
        # map every publish_map_updates_every_n keyframes
        self._stamp0 = None  # host f64 stamp base (first scan)
        self._localization_subscribers: List = []
        self._map_subscribers: List = []
        self.publish_map_updates_every_n = 10
        self._kf_counter = 0
        self.frames_processed = 0
        self.frames_dropped = 0
        self._drop_window: List[tuple] = []  # (collision_drops, inserts)
        self._capacity_warned = False
        self._raw_truncation_warned = False
        self._host_scan = None  # pinned staging buffer (CUDA), sized at the first scan
        # reset() is the reference's full re-initialization: a fatal-error
        # latch from a previous run clears here (LidarOdometry.cpp:495-501)
        self._fatal_error = False

    def _ensure_step(self, first_xyz: np.ndarray, first_times=None) -> None:
        """First-scan spec finalization, before the first step:

        * capacity auto-sizing: a host-side dry pass over the first scan
          derives every layer capacity, the map hash size and the insert
          budgets (utils/capacity.py); explicit overrides win;
        * pin_se2=None (auto) resolves from the scan's planarity (reference
          LidarOdometry.cpp:863-876).
        """
        if self._step is not None:
            return
        if self._auto_cfg is not None:
            from mola_lidar_odometry_tpu_torch.utils.capacity import derive_capacities

            cfg, overrides = self._auto_cfg
            names = ("raw_capacity", "map_slots", "layer_capacities", "insert_budgets")
            derived = dict(zip(names, derive_capacities(self.spec, first_xyz, first_times, with_budgets=True)))
            derived.update(overrides)
            self.spec = spec_from_yaml(cfg, **derived)
            self._auto_cfg = None
            # no scan has been processed yet: rebuild the carry at the
            # derived shapes (empty, as the JAX package does: a preloaded
            # local map is dropped with the old sizes)
            self.carry = step_mod.init_carry(self.spec, 1, self.device)
        if self.spec.pin_se2 is None:
            # auto mode only: an explicit YAML pin_se2 is never overridden
            z = np.asarray(first_xyz)[:, 2] if len(first_xyz) else np.zeros(1)
            planar = bool(np.max(np.abs(z)) < 1e-6) if z.size else False
            self.spec = dataclasses.replace(self.spec, pin_se2=planar)
        self._step = step_mod.make_step(self.spec)

    def set_mapping_enabled(self, enabled: bool) -> None:
        """Runtime local-map toggle (the reference GUI's "generate map"
        checkbox, LidarOdometry.cpp:1944-1961): disabled = localization-only
        against the frozen map; matching continues."""
        flag = torch.full((1,), bool(enabled), dtype=torch.bool, device=self.device)
        self.carry = self.carry._replace(mapping_enabled=flag)

    @property
    def mapping_enabled(self) -> bool:
        return bool(self.carry.mapping_enabled[0])

    def matches_lidar_label(self, label: str) -> bool:
        return any(r.fullmatch(label) or r.match(label) for r in self._label_regexes)

    def _rebase(self, stamp: float) -> float:
        if self._stamp0 is None:
            self._stamp0 = float(stamp)
        return float(stamp) - self._stamp0

    def on_gnss(self, stamp: float, data: dict) -> None:
        """Ring-buffer GNSS observations for simple-map keyframes
        (reference onGPSImpl, LidarOdometry.cpp:1392-1414; buffer of 100)."""
        self._gnss_buffer.append({"stamp": self._rebase(stamp), **data})
        if len(self._gnss_buffer) > 100:
            self._gnss_buffer.pop(0)

    def on_imu(self, stamp: float, data: dict) -> None:
        """IMU intake. The reference profiles and otherwise ignores IMU
        (onIMUImpl is a stub, LidarOdometry.cpp:1333-1338); a small buffer
        keeps it for downstream consumers."""
        with self.profiler.enter("onIMU"):
            self._imu_buffer.append({"stamp": stamp, **data})
            if len(self._imu_buffer) > 1000:
                self._imu_buffer.pop(0)

    def on_wheel_odometry(self, stamp: float, pose) -> None:
        """Fuse wheel odometry (reference onWheelOdometryImpl ->
        NavStateFuse::fuse_odometry, LidarOdometry.cpp:1357-1373).

        ``pose`` is a 4x4 (or (R, t)) absolute odometry-frame pose.  The
        relative motion since the previous reading, composed onto the newest
        navstate pose, enters the navstate window as a pose sample: velocity
        evidence between LiDAR scans.  It never moves the pose estimate
        itself (only ICP-accepted scans move ``carry.pose``)."""
        if isinstance(pose, tuple):
            R, t = pose
        else:
            pose = np.asarray(pose)
            R, t = pose[:3, :3], pose[:3, 3]
        stamp = self._rebase(stamp)
        with self.profiler.enter("onWheelOdometry"):
            if self._last_odom is not None:
                R0, t0 = self._last_odom
                rel_R, rel_t = R0.T @ R, R0.T @ (t - t0)
                # chain onto the NEWEST window pose (dead reckoning between
                # scans), not the scan-gated carry pose
                nav = self.carry.nav
                valid = nav.valid[0].cpu().numpy()
                W = len(valid)
                if valid.any():
                    order = (int(nav.head[0]) - 1 - np.arange(W)) % W
                    newest = next(int(i) for i in order if valid[i])
                    cur = se3.Pose(nav.R[:, newest], nav.t[:, newest])
                else:
                    cur = se3.Pose(self.carry.pose_R, self.carry.pose_t)
                inc = se3.Pose(
                    torch.as_tensor(rel_R, dtype=torch.float32, device=self.device)[None],
                    torch.as_tensor(rel_t, dtype=torch.float32, device=self.device)[None],
                )
                when = torch.full((1,), stamp, dtype=torch.float32, device=self.device)
                self.carry = self.carry._replace(nav=ns.fuse_pose(nav, when, se3.compose(cur, inc)))
            self._last_odom = (np.asarray(R, np.float64), np.asarray(t, np.float64))

    # -- relocalization (reference LidarOdometry.h:102-107) ----------------
    def relocalize_near_pose_pdf(self, R: np.ndarray, t: np.ndarray) -> None:
        """Re-seed the estimator near the given pose: reset the kinematic
        state and continue localizing against the existing local map."""
        dev = self.device
        self.carry = self.carry._replace(
            pose_R=torch.as_tensor(np.array(R, np.float32), device=dev)[None],
            pose_t=torch.as_tensor(np.array(t, np.float32), device=dev)[None],
            nav=ns.NavStateBuffer.empty(1, dev),
            sigma=torch.zeros((1,), dtype=torch.float32, device=dev),  # re-open the adaptive threshold
        )

    def relocalize_from_gnss(self) -> bool:
        """Seed position from the newest buffered GNSS fix (ENU expected in
        ``data['enu']``).  Returns False if no usable fix is buffered."""
        for g in reversed(self._gnss_buffer):
            enu = g.get("enu")
            if enu is not None:
                self.relocalize_near_pose_pdf(self.carry.pose_R[0].cpu().numpy(), np.asarray(enu, np.float64))
                return True
        return False

    def on_lidar_scan(
        self,
        xyz: np.ndarray,
        stamp: float,
        times: Optional[np.ndarray] = None,
        intensity: Optional[np.ndarray] = None,
        ring: Optional[np.ndarray] = None,
        keep_scan_for_simplemap: bool = True,
    ) -> Optional[StepOutput]:
        """Process one scan (numpy, sensor frame).  Returns the step output
        on the host (numpy, no fleet dimension), or None while inactive."""
        if not self.active or self._fatal_error:
            return None
        try:
            # Rebase stamps to the first scan (float64 on host): device time
            # is float32, whose ulp reaches ~1 ms at t=10^4 s.  Outputs add
            # the base back (estimated_trajectory / simplemap).
            stamp = self._rebase(stamp)
            self._ensure_step(xyz, times)
            prof = self.profiler
            with prof.enter("onLidar"):
                with prof.enter("pad"):  # host padding and the copy to the device
                    scan = self._pad_scan(xyz, stamp, times, intensity, ring)
                if self._icp_log is not None and self._icp_log.want_frame():
                    with prof.enter("icp_log"):  # the replay on the pre-step carry
                        self._write_icp_log(scan)
                # the step's own ``step`` span (issuing it, and its own syncs) and
                # its layers' spans land here, as onLidar.step[.filters|.icp|.map]
                with use_profiler(prof):
                    self.carry, out = self._step(self.carry, scan)
                with prof.enter("readback"):  # waits for the device
                    out = output_to_host(out)
            self._post_step(out, xyz if keep_scan_for_simplemap else None)
            return out
        except Exception:
            # reference behavior: a worker exception sets a fatal flag and
            # discards further input (LidarOdometry.cpp:614-619)
            self._fatal_error = True
            raise

    # -- ICP debug logs (.icplog analogue; utils/icp_log.py) ----------------
    def _write_icp_log(self, scan: Scan, n_iters: int = 30) -> None:
        """Replay the align of this scan on the PRE-step carry with a fixed
        ``n_iters`` schedule (``utils/icp_log.py``) and write its log; the
        logged quality is the pre-step carry's.  One host copy, after the
        replay."""
        from mola_lidar_odometry_tpu_torch.models.filter_graph import apply_pipeline
        from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud
        from mola_lidar_odometry_tpu_torch.utils.icp_log import replay_align_with_trace

        # reference decimationIterationDetails (lidar3d-default.yaml:180):
        # full pairing details every Nth iteration; 0 disables the details
        detail_every = int(os.environ.get("MP2P_ICP_LOG_ITER_DETAILS", 3))
        spec, carry, prof = self.spec, self.carry, self.profiler
        with prof.enter("replay"):  # issue, then wait for the one host copy
            env = step_mod._dynamic_env(spec, carry, scan.stamp)
            layers = {"raw": PointCloud(scan.xyz, scan.time, scan.intensity, scan.ring, scan.valid)}
            for pl in (spec.generator_pipeline, spec.adjust_pipeline, spec.filter1, spec.filter2):
                layers = apply_pipeline(pl, layers, env)
            nav = ns.estimate(carry.nav, spec.navstate, scan.stamp)
            v = nav.valid[:, None]
            pose0 = se3.Pose(torch.where(v[..., None], nav.pose.R, carry.pose_R),
                             torch.where(v, nav.pose.t, carry.pose_t))
            cfg = spec.icp_with_vel
            icp_layers = {mc.local_layer: (layers[mc.local_layer].xyz, layers[mc.local_layer].valid)
                          for mc in cfg.matchers}
            Rs, ts, paired, det = replay_align_with_trace(
                carry.maps, icp_layers, pose0, nav.prior, cfg, env, n_iters, detail_every=detail_every,
            )
            # one instance: every part is (1, ...); paired counts are exact in f32
            parts = [Rs, ts, paired.to(torch.float32), pose0.R, pose0.t, carry.last_icp_quality, scan.stamp]
            parts += [det] if det is not None else []
            flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts]).cpu().numpy()
        with prof.enter("write"):
            vals, k = [], 0
            for p in parts:
                vals.append(flat[k : k + p.numel()].reshape(p.shape[1:]))
                k += p.numel()
            Rs, ts, paired, p0R, p0t, quality, stamp = vals[:7]
            extra = {"pose0_R": p0R, "pose0_t": p0t}  # align entry pose: detail slot 0 was recorded here
            if det is not None:
                # per-detail-iteration pairings: [lx ly lz tx ty tz d2 valid]
                extra["pair_details"] = vals[7]
                extra["detail_iters"] = np.arange(0, n_iters, detail_every, dtype=np.int32)
            self._icp_log.log(
                frame_idx=self.frames_processed, stamp=float(stamp), poses_R=Rs, poses_t=ts,
                paired=paired.astype(np.int32), quality=float(quality), iterations=n_iters, extra=extra,
            )

    # -- internals ---------------------------------------------------------
    def _pad_scan(self, xyz, stamp, times, intensity, ring) -> Scan:
        """Pad on the host into one flat float32 buffer ``[xyz (3N) | time
        | intensity | ring (int32 bits) | valid (0/1) | stamp]`` and make one
        copy to the device (from a pinned buffer on CUDA, reused every scan:
        the previous scan's readback has already waited for its copy)."""
        N = self.spec.raw_capacity
        n = min(len(xyz), N)
        size = 7 * N + 1
        if self.device.type == "cuda":
            if self._host_scan is None or self._host_scan.numel() != size:
                self._host_scan = torch.empty(size, dtype=torch.float32, pin_memory=True)
            host = self._host_scan
        else:
            host = torch.empty(size, dtype=torch.float32)  # the step keeps views of it
        buf = host.numpy()
        buf[: 7 * N] = 0.0
        xyz_n = np.asarray(xyz[:n], np.float32)
        buf[: 3 * n] = xyz_n.reshape(-1)
        for k, a in ((3, times), (4, intensity)):
            if a is not None:
                buf[k * N : k * N + n] = np.asarray(a[:n], np.float32)
        if ring is not None:
            buf[5 * N : 6 * N].view(np.int32)[:n] = np.asarray(ring[:n], np.int32)
        buf[6 * N : 6 * N + n] = np.all(np.isfinite(xyz_n), axis=1)
        buf[7 * N] = np.float32(stamp)
        dev = host.to(self.device, non_blocking=True)
        return Scan(
            xyz=dev[: 3 * N].view(1, N, 3),
            time=dev[3 * N : 4 * N].view(1, N),
            intensity=dev[4 * N : 5 * N].view(1, N),
            ring=dev[5 * N : 6 * N].view(torch.int32).view(1, N),
            valid=(dev[6 * N : 7 * N] > 0).view(1, N),
            stamp=dev[7 * N :],
        )

    def _closest_gnss(self, stamp: float) -> Optional[dict]:
        if not self._gnss_buffer:
            return None
        best = min(self._gnss_buffer, key=lambda g: abs(g["stamp"] - stamp))
        if abs(best["stamp"] - stamp) <= self.spec.simplemap.save_gnss_max_age:
            return best
        return None

    def _post_step(self, out: StepOutput, scan_xyz: Optional[np.ndarray]) -> None:
        """Host bookkeeping of one scan; ``out`` is the host copy."""
        if not bool(out.processed):
            self.frames_dropped += 1
            return
        self.frames_processed += 1

        # raw-truncation watchdog: a scan padded EXACTLY to capacity very
        # likely lost points in _pad_scan
        if int(out.n_raw) >= self.spec.raw_capacity and not self._raw_truncation_warned:
            self._raw_truncation_warned = True
            _log.warning(
                "scan filled the raw buffer (%d points): larger scans are being truncated — grow raw_capacity",
                self.spec.raw_capacity,
            )

        # capacity-saturation watchdog: collision drops beyond 0.1% of
        # inserts over a rolling window of keyframe frames
        if bool(out.kf_local):
            self._drop_window.append((int(out.map_collision_drops), max(int(out.n_map_layer), 1)))
        if len(self._drop_window) > 32:
            self._drop_window.pop(0)
        drops = sum(d for d, _ in self._drop_window)
        inserts = sum(n for _, n in self._drop_window)
        if len(self._drop_window) >= 8 and drops > 0.001 * inserts and not self._capacity_warned:
            self._capacity_warned = True
            _log.warning(
                "map hash collision drops %.2f%% of inserts over the last %d frames (map_slots=%d "
                "undersized for this world; grow it or use capacity auto-sizing)",
                100.0 * drops / max(inserts, 1), len(self._drop_window), self.spec.map_layers[0].num_slots,
            )

        if bool(out.map_restarted):
            self.trajectory.clear()

        if bool(out.accepted):
            q = se3.rot_to_quat(torch.from_numpy(out.pose_R)).numpy()
            entry = {
                "stamp": float(out.stamp) + (self._stamp0 or 0.0),
                "t": np.asarray(out.pose_t, np.float64),
                "quat_xyzw": q.astype(np.float64),
            }
            self.trajectory.append(entry)

            if bool(out.sm_insert):
                keep_scan = scan_xyz if bool(out.kf_simplemap) else None
                meta = None
                if keep_scan is not None and len(keep_scan):
                    meta = {  # frame bbox metadata (reference :1244-1268)
                        "bbox_min": keep_scan.min(axis=0).tolist(),
                        "bbox_max": keep_scan.max(axis=0).tolist(),
                        "n_points": int(len(keep_scan)),
                    }
                self.simplemap.append(
                    SimpleMapKeyframe(
                        stamp=entry["stamp"], t=entry["t"], quat_xyzw=entry["quat_xyzw"],
                        twist=np.asarray(out.twist, np.float64), scan_xyz=keep_scan,
                        gnss=self._closest_gnss(float(out.stamp)), metadata=meta,
                    )
                )

            # doPublishUpdatedLocalization (reference :2079-2100)
            for cb in self._localization_subscribers:
                cb(entry)
            # doPublishUpdatedMap every N keyframes (reference :2102-2149)
            if bool(out.kf_local):
                self._kf_counter += 1
                if self._map_subscribers and self._kf_counter % self.publish_map_updates_every_n == 0:
                    pts = self.local_map_pointcloud()
                    for cb in self._map_subscribers:
                        cb(pts)

        if self.spec.debug_traces_save:
            # full dynamic-variable dump per frame, like the reference's
            # doWriteDebugTracesFile (LidarOdometry.cpp:2247-2282)
            tw = np.asarray(out.twist, np.float64)
            t = np.asarray(out.pose_t, np.float64)
            yaw, pitch, roll = (float(x) for x in se3.rot_to_ypr(torch.from_numpy(out.pose_R)))
            self.traces.append(
                {
                    "stamp": float(out.stamp),
                    "vx": tw[0], "vy": tw[1], "vz": tw[2],
                    "wx": tw[3], "wy": tw[4], "wz": tw[5],
                    "robot_x": t[0], "robot_y": t[1], "robot_z": t[2],
                    "robot_yaw": yaw, "robot_pitch": pitch, "robot_roll": roll,
                    "ADAPTIVE_THRESHOLD_SIGMA": float(out.sigma),
                    "icp_iterations": int(out.iterations),
                    "twistCorrectionCount": int(out.corrections),
                    "ESTIMATED_SENSOR_MAX_RANGE": float(out.est_range),
                    "icp_quality": float(out.quality),
                    "n_raw": int(out.n_raw),
                    "n_icp": int(out.n_icp_layer),
                    "accepted": int(bool(out.accepted)),
                    "kf_local": int(bool(out.kf_local)),
                    "map_collision_drops": int(out.map_collision_drops),
                    "map_full_drops": int(out.map_full_drops),
                    "onLidar_time_ms": 1e3 * self.profiler.last("onLidar"),
                }
            )

    # -- outputs (reference :1425-1435, 1865-1904) -------------------------
    def estimated_trajectory(self) -> Dict[str, np.ndarray]:
        if not self.trajectory:
            return {"stamps": np.zeros(0), "t": np.zeros((0, 3)), "quat_xyzw": np.zeros((0, 4))}
        return {
            "stamps": np.asarray([e["stamp"] for e in self.trajectory]),
            "t": np.stack([e["t"] for e in self.trajectory]),
            "quat_xyzw": np.stack([e["quat_xyzw"] for e in self.trajectory]),
        }

    def save_trajectory_tum(self, path: Union[str, Path]) -> None:
        tr = self.estimated_trajectory()
        tum.save_tum(path, tr["stamps"], tr["t"], tr["quat_xyzw"])

    def reconstructed_map(self) -> List[SimpleMapKeyframe]:
        return self.simplemap

    def save_simplemap(self, path: Union[str, Path]) -> None:
        serialization.save_simplemap(path, self.simplemap, lazy_load=self.spec.simplemap.generate_lazy_load_scan_files)

    def local_map_pointcloud(self, capacity: int = 1 << 20, layer: Optional[str] = None) -> np.ndarray:
        """Materialize a live local-map layer as an (N, 3) numpy array (the
        wrapped voxel keys unwrapped near the current pose)."""
        name = layer or self.spec.map_layers[0].name
        pc = maps_ops.as_pointcloud(self.carry.maps[name], capacity, anchor=self.carry.pose_t)
        return pc.xyz[0][pc.valid[0]].cpu().numpy()

    def save_local_map(self, path: Union[str, Path]) -> None:
        """Persist all local-map layers (the '.mm' analogue)."""
        serialization.save_metric_map(path, self.carry.maps)

    def load_local_map(self, path: Union[str, Path]) -> None:
        """Preload an existing local map (multi-session / localization-only,
        reference LidarOdometry.cpp:465-476)."""
        loaded = serialization.load_metric_map(path, device=self.device)
        has_content = any(not bool(m.is_empty()[0]) for m in loaded.values())
        flag = torch.full((1,), has_content, dtype=torch.bool, device=self.device)
        self.carry = self.carry._replace(maps=loaded, map_has_content=flag)

    def save_debug_traces(self, path: Union[str, Path]) -> None:
        if not self.traces:
            return
        keys = list(self.traces[0].keys())
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for row in self.traces:
                f.write(",".join(str(row[k]) for k in keys) + "\n")

    # -- publisher subscriptions (mola_kernel advertise* interfaces) --------
    def subscribe_localization_updates(self, cb) -> None:
        """``cb(entry)`` per accepted pose (advertiseUpdatedLocalization)."""
        self._localization_subscribers.append(cb)

    def subscribe_map_updates(self, cb) -> None:
        """``cb(points)`` every ``publish_map_updates_every_n`` keyframes
        (advertiseUpdatedMap)."""
        self._map_subscribers.append(cb)

    def is_busy(self) -> bool:
        return False  # synchronous host API; the async runtime lives in utils/runtime.py
